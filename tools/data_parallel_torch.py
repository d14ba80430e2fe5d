"""Phase 14 of ``chip_smoke.py`` (data parallelism over NCCL: BERT-large O2
+ DistributedFusedLAMB, GPT-350M + DistributedFusedAdam, ResNet-50 O1
``--sync-bn`` under DDP through the example) at one rank a card of the
machine, held against phases 7 and 5 run first in this process on card 0
and 14c's one-process reference (phase 9 logged beside it), with the
kernels built from this checkout:

    python3 tools/data_parallel_torch.py [--out results.json]

On one card this is ``chip_smoke.py``'s phase 14 alone; on four it runs the
ZeRO shards, the collectives and the batch statistics across cards.  The
last lines are the cards' names and power limits and one ``{json}`` line:
the world size, the largest loss gaps, and each rank's step times, peak
memory and launches.
"""
import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the results to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    c.phase_build()
    singles = {}
    for key, run in (("train", c.phase_train), ("bert", c.phase_bert_train)):
        out = run()
        singles[key] = out[-1]
        del out
        torch.cuda.empty_cache()
    trainer, batch, singles["resnet"] = c.phase_resnet("O1", "[9]")
    del trainer, batch
    torch.cuda.empty_cache()
    dp = c.phase_data_parallel(singles["train"], singles["bert"],
                               singles["resnet"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    summary = dict(world=dp["world"], gaps=dp["gaps"], ranks=[
        {key: {k: run[k] for k in ("step_times_s", "peak_memory_bytes",
                                   "launches")}
         for key, run in rank.items()} for rank in dp["ranks"]],
        single={key: {k: run[k] for k in ("step_times_s",
                                          "peak_memory_bytes")}
                for key, run in singles.items()})
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(dp, single=singles), f, indent=1, default=str)
    print(smi)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
