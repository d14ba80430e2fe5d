"""Phase 16 of ``chip_smoke.py`` (expert, pipeline and context parallelism
over NCCL) at one rank a card of the machine, with the kernels built from
this checkout:

    python3 tools/model_parallel_torch.py [--world N] [--parts P,...]
        [--out results.json]

On one card with the default parts this is ``chip_smoke.py``'s phase 16
alone.  On 2 or 4 cards (``--world`` takes fewer ranks than cards) the
parts run across cards, each against one process on the same data:

* ``switch``: Switch-GPT-350M/8 through the ported example with its
  experts sharded over the ranks (EP = the ranks, each on its rows of the
  global batch) and one GShard step; ``ep_reference``: the same example
  in one process on each card over the whole global batch, each rank's
  rows its own micro-batches (the per-shard golden);
* ``pipeline``: GPT-350M through ``pipeline_step`` over the ranks, 1F1B
  (``n_virtual=1``) and interleaved (``n_virtual=2``), against
  ``forward_backward_no_pipelining`` in one process;
* ``pp_tp``: pipe 2 x model 2 with sequence parallelism (4 ranks) against
  the same tensor-parallel model without the pipeline;
* ``context``: GPT-350M with ``context_axis`` over the ranks, Ulysses and
  ring attention, against the pipeline part's one-process reference;
* ``parity``: 16p and 16b's small-width card-vs-CPU checks.

The last lines are the cards' names and power limits and one ``{json}``
line: the loss gaps and each rank's step times, peak memory and launches.
The gaps are held to ``chip_smoke.MP_LOSS_RTOL`` (a rank count without
readings raises).

    python3 tools/model_parallel_torch.py --gates [--world N] [--parts P,...]

The readings behind phase 16's loss gates (``chip_smoke.MP_LOSS_RTOL``):
each part's largest relative loss gap to its reference, correct and with
every fault of ``chip_smoke.MP_FAULTS`` planted (each in one path's own
code: ``drop_microbatch`` the pipeline engine, ``ring_dkv`` ring
attention's reverse ring, ``a2a_bwd_local`` the backward exchanges of
the MoE ``all_to_all`` and Ulysses), so that each gate sits between its
two readings.  At one rank the parts are 16c's pipeline (the collectives
are local, so only ``drop_microbatch`` acts); ``--parts parity`` reads
16p's ``w1`` gradient in norm, correct and with ``chip_smoke._plant_moe``'s
``drop_slot`` (``chip_smoke.MOE_W1_NORM_TOL``), in this process.
"""
import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402

ALL_PARTS = ("switch", "ep_reference", "pipeline", "pp_tp", "context",
             "parity")


def parts_for(names, world):
    parts = {}
    for name in names:
        if name not in ALL_PARTS:
            raise SystemExit(f"unknown part {name!r}; parts: {ALL_PARTS}")
        if name == "pp_tp" and world % 4:
            raise SystemExit("pp_tp needs 4 ranks (pipe 2 x model 2)")
        parts[name] = (1, 2) if name == "pipeline" else True
    if "context" in parts and "pipeline" not in parts:
        parts["pipeline"] = ()          # its one-process reference
    return parts


def gates(world, parts):
    """Each part's loss gaps, correct and with every fault planted, at
    ``world`` ranks."""
    out = {}
    for faults in ((), c.MP_FAULTS):
        t0 = time.perf_counter()
        name = "+".join(faults) or "correct"
        ranks = c.run_mp_ranks(world, os.path.join(
            "build", "mp_loss_gates", name), parts, faults)
        out[name] = dict(gaps=c.report_mp(ranks, world, parts),
                         seconds=time.perf_counter() - t0)
        c.log(f"{name}: gaps {out[name]['gaps']} "
              f"({out[name]['seconds']:.1f} s)")
    return out


def parity_gates():
    """16p's ``w1`` readings in norm (and the other gradients entry by
    entry), correct and with ``drop_slot`` planted on the card."""
    out = {}
    for fault in (None, "drop_slot"):
        for top_k in (1, 2):
            p = c._moe_train_parity(top_k, fault)
            out[f"{fault}/top{top_k}"] = p
            c.log(f"16p top-{top_k} fault {fault}: w1 in norm "
                  f"{p['w1_norm_err']!r} at {p['worst_w1']}, entry by "
                  f"entry {p['w1_entry_err']!r}; other gradients "
                  f"{p['grad_rel_err']!r} at {p['worst_grad']}; loss "
                  f"{p['loss_rel_err']!r}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the results to this file")
    ap.add_argument("--gates", action="store_true",
                    help="take the gate readings instead")
    ap.add_argument("--world", type=int, default=None,
                    help="ranks (default: every card)")
    ap.add_argument("--parts", default=None,
                    help=f"comma-separated subset of {ALL_PARTS} (default: "
                         "phase 16's at one rank; at more, every part the "
                         "rank count allows but parity)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    world = args.world or torch.cuda.device_count()
    if world > torch.cuda.device_count():
        raise SystemExit(f"--world {world} needs as many cards")
    c.phase_build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    if args.parts:
        parts = parts_for(args.parts.split(","), world)
    elif args.gates and world == 1:
        parts = {"pipeline": (2,)}
    elif world == 1:
        parts = dict(c.PHASE16_PARTS)
    else:
        parts = parts_for([p for p in ALL_PARTS if p != "parity" and (
            p != "pp_tp" or world % 4 == 0)], world)
    if args.gates:
        readings = {}
        if parts.pop("parity", None):
            readings["parity"] = parity_gates()
        if parts:
            readings["loss"] = gates(world, parts)
        res = dict(world=world, readings=readings)
        summary = dict(world=world, parity={
            key: {k: p[k] for k in ("w1_norm_err", "w1_entry_err",
                                    "grad_rel_err", "loss_rel_err")}
            for key, p in readings.get("parity", {}).items()}, loss={
            key: r["gaps"] for key, r in readings.get("loss", {}).items()})
    else:
        t0 = time.perf_counter()
        ranks = c.run_mp_ranks(world, os.path.join("build", "phase16"),
                               parts)
        seconds = time.perf_counter() - t0
        gaps = c.report_mp(ranks, world, parts)
        c.gate_mp(gaps, world)
        res = dict(world=world, seconds=seconds, gaps=gaps, ranks=ranks)
        summary = dict(world=world, seconds=seconds, gaps=gaps, ranks=[
            {key: {k: run[k] for k in ("step_times_s", "peak_memory_bytes",
                                       "launches", "losses") if k in run}
             for key, run in rank.items() if isinstance(run, dict)}
            for rank in ranks])
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(res, nvidia_smi=smi), f, indent=1, default=str)
    print(smi)
    print(json.dumps(summary, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
