"""Phase 15 of ``chip_smoke.py`` (tensor and sequence parallelism over NCCL:
GPT-350M TP + SP with the fused FFN and FusedAdam, the same with the
overlap rings, BERT-large O2 + FusedLAMB TP + SP with the rings) at one
rank a card of the machine, with the kernels built from this checkout:

    python3 tools/tensor_parallel_torch.py [--out results.json]

On one card this is ``chip_smoke.py``'s phase 15 alone; on 2 or 4 cards
(``--world`` takes fewer ranks than cards) it runs the collectives, the
rings and the shards across cards.  The last lines are the cards' names
and power limits and one ``{json}`` line: the tensor-parallel size, the
loss gaps, and each rank's step times, peak memory and launches.

    python3 tools/tensor_parallel_torch.py --gates [--world N]
        [--out results.json]

The readings behind phase 15's loss gates: each run's largest relative
loss gap to its one-process reference, correct and with each planted
fault of ``chip_smoke._tp_plant`` (``ring_dw``: the rings' weight
gradient misses each shard's last token; ``ring_row``: each ring product
loses its last row; ``bias_copy``: the row bias loses its
sequence-parallel ``copy_to``, invisible at one rank), so that a gate
can sit between the two; on the cards at full width, the kernels built
first.
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


def gates(world):
    """Each fault's loss gaps beside the correct run's, at ``world``
    ranks."""
    # bias_copy is the identity at one rank; ring_dw reads within the
    # correct run's spread at one rank (Adam's normalized step)
    faults = [None, "ring_row"] + (["bias_copy"] if world > 1
                                   else ["ring_dw"])
    out = {}
    for fault in faults:
        t0 = time.perf_counter()
        ranks = c.run_tp_ranks(world, os.path.join(
            "build", "tp_loss_gates", str(fault)), fault)
        out[str(fault)] = dict(
            gaps=c.tp_loss_gaps(ranks),
            losses={key: ranks[0][key]["losses"] for key, *_ in c.TP_RUNS},
            reference={key: ranks[0][key]["reference"]
                       for key, *_ in c.TP_RUNS},
            seconds=time.perf_counter() - t0)
        c.log(f"fault {fault}: gaps {out[str(fault)]['gaps']} "
              f"({out[str(fault)]['seconds']:.1f} s)")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the results to this file")
    ap.add_argument("--gates", action="store_true",
                    help="take the loss-gate readings instead")
    ap.add_argument("--world", type=int, default=None,
                    help="ranks (default: every card)")
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
    if args.gates:
        res = dict(world=world, readings=gates(world))
        summary = {fault: r["gaps"] for fault, r in res["readings"].items()}
    else:
        res = c.phase_tensor_parallel(world=world)
        summary = dict(world=res["world"], seconds=res["seconds"],
                       gaps=res["gaps"], ranks=[
                           {key: {k: run[k] for k in (
                               "step_times_s", "peak_memory_bytes",
                               "reference_peak_memory_bytes", "launches")}
                            for key, run in rank.items()}
                           for rank in res["ranks"]])
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(res, nvidia_smi=smi), f, indent=1, default=str)
    print(smi)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
