"""One checkout's phases 5 and 7 of ``chip_smoke.py`` (GPT-350M and
BERT-large O2 training with the fused LM head) at 10 steps each instead of
4, for comparing the step times of two checkouts on one card in one call
(each run its own process, the order alternated):

    for t in parent . . parent parent .; do
      python3 tools/train_steps_compare_torch.py $t
    done

Each run prints one ``PROBE {json}`` line with each phase's median step
and step times; ``TREE`` is the root of a checkout (its own kernels are
built there).
"""
import json
import os
import sys

tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
os.chdir(tree)
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402

c.phase_build()
c.TRAIN_STEPS = c.BERT_STEPS = 10
out = {"tree": os.path.basename(tree)}
for phase, run in (("5", c.phase_train), ("7", c.phase_bert_train)):
    model, opt, _, _, res = run()
    out[phase] = dict(median_step_s=res["median_step_s"],
                      step_times_s=res["step_times_s"])
    del model, opt, res
    torch.cuda.empty_cache()
print("PROBE " + json.dumps(out), flush=True)
