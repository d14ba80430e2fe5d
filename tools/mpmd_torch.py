#!/usr/bin/env python3
"""GPT-350M through apex_tpu_torch's MPMD pipeline on one or more cards:
``chip_smoke.py`` phase 19's recipe (phase 5's weights from seed 0 and its
16,384-token batch as M = 4 micro-batches, ``FusedAdam(lr=1e-4)``, two pods)
with stage ``i`` on ``cuda:i``.

    python3 tools/mpmd_torch.py [--cards N] [--pp S] [--out f.json]
    python3 tools/mpmd_torch.py --gates [--out f.json]

Without ``--gates``: ``--cards`` (default ``torch.cuda.device_count()``)
cards hold ``--pp`` (default: the cards) stages round robin; a traced
``dcn_hiding`` run of 3 steps (one scheduled ``dcn_fault``) and a
``measure_ops`` ``1f1b`` run of 2 steps, each under phase 19's gates (exact
launches, no plain version, the replicas bit for bit, the retries, the
flow chains, step 0 against one process on ``cuda:0`` within
``MPMD_GATES``), with step times, tokens/s, peak memory a card, the
channel's bytes and seconds and the measured step's attribution.

``--gates`` reads the gaps of ``chip_smoke.MPMD_GATES`` on one card at
phase 19's two recipes (pp 2 ``dcn_hiding``, pp 4 ``1f1b``), correct and
with each of ``MPMD_FAULTS`` planted, one step each; set the gates between
the correct and the faulted readings.

For example, on one card ``python3 tools/mpmd_torch.py --gates``; on a host
with four cards ``python3 tools/mpmd_torch.py --cards 2`` and then
``python3 tools/mpmd_torch.py --cards 4``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402


def _setup():
    c.phase_build()
    model = c.build_model("cuda").init_params(
        torch.Generator().manual_seed(0))
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model
    batch = c._gpt350m_batch(n_micro=c.MPMD_M)
    ref = c._mpmd_reference(init, *batch)
    torch.cuda.empty_cache()
    return init, batch, ref


def _free():
    gc.collect()
    torch.cuda.empty_cache()


def read_gates():
    """Each recipe's step-0 gaps, correct and with each fault planted."""
    init, batch, ref = _setup()
    out = {}
    for tag, pp, schedule in (("19a", 2, "dcn_hiding"), ("19b", 4, "1f1b")):
        for fault in (None,) + c.MPMD_FAULTS:
            with c._plant_mpmd((fault,) if fault else ()):
                run = c._mpmd_run(init, batch, ref, pp=pp, n_pods=2,
                                  schedule=schedule, steps=1)
            key = f"{tag} {fault or 'correct'}"
            out[key] = run["gaps"]
            c.log(f"[gates] {key}: {run['gaps']}")
            _free()
    return out


def run_cards(cards, pp):
    """Phase 19's two runs with stage ``i`` on ``cuda:(i % cards)``."""
    if torch.cuda.device_count() < cards:
        raise SystemExit(f"--cards {cards} but this machine has "
                         f"{torch.cuda.device_count()}")
    init, batch, ref = _setup()
    devices = [f"cuda:{i % cards}" for i in range(pp)]
    out = {}
    for tag, kw, retries in (
            ("traced", dict(schedule="dcn_hiding", steps=3, trace=True,
                            dcn_fault_at=0), 1),
            ("measure_ops", dict(schedule="1f1b", steps=2,
                                 measure_ops=True), 0)):
        run = c._mpmd_run(init, batch, ref, pp=pp, n_pods=2,
                          devices=devices, **kw)
        c.log_mpmd(f"[{cards} cards, pp {pp}, {tag}]", run,
                   f"GPT-350M, stage i on cuda:(i % {cards})")
        c.check_mpmd(f"[{cards} cards {tag}]", run, retries=retries)
        out[tag] = run
        _free()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=None)
    ap.add_argument("--pp", type=int, default=None)
    ap.add_argument("--gates", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mpmd_torch: torch.cuda.is_available() is False; this tool "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = c._smi()
    t0 = time.perf_counter()
    if args.gates:
        result = {"gates": read_gates()}
    else:
        cards = args.cards or torch.cuda.device_count()
        result = run_cards(cards, args.pp or max(cards, 2))
    c.log(f"mpmd_torch: {time.perf_counter() - t0:.1f} s on "
          f"{torch.cuda.device_count()} x {smi}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(result, nvidia_smi=smi), f, indent=1,
                      sort_keys=True, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
