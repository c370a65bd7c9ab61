#!/usr/bin/env python3
"""Parent against change on one NVIDIA GPU, in turns.

    git archive <parent> | tar -x -C build/parent   # an ignored directory
    python3 scripts/chip_ab.py build/parent

Runs, in the order parent, change, change, parent and each tree in its
own process from its own root (so each builds and loads its own
kernels): three full-width Wan2.1 training steps through that tree's
`chip_smoke.phase_train` (kernel backend, bf16 compute, per-layer remat),
then three static Qwen3-1.7B prefill groups of 2 x 32,000 tokens through
the `ServingEngine` (kernel backend, decode-SLA). Prints one JSON line a
run: the step walls, peak memory and prefill walls. Exits non-zero if a
run failed. Compare the two trees only within one call of this script.
"""
import json
import subprocess
import sys
from pathlib import Path

CHANGE = Path(__file__).resolve().parents[1]
RUN = r'''
import json, sys
sys.path.insert(0, ".")
import numpy as np
import torch
import chip_smoke as cs
from repro_torch.serving.engine import Request, ServingEngine
cs.phase_card()
cs.phase_build()
cfg, params = cs._main_model(seed=0)
train = cs.phase_train(cfg, params, False)
del params
torch.cuda.empty_cache()
lm_cfg, lm_params = cs._lm_model(seed=0)
eng = ServingEngine(lm_cfg, lm_params, batch_size=2, max_len=32768,
                    backend="kernel", decode_sla=True)
rs = np.random.default_rng(0)
prefill = []
for _ in range(3):
    reqs = [Request(rid=i, prompt=rs.integers(0, lm_cfg.vocab_size,
                                              size=32000).astype(np.int32),
                    max_new_tokens=2) for i in range(2)]
    before = eng.stats.prefill_s
    eng.run(reqs)
    prefill.append(eng.stats.prefill_s - before)
print("AB " + json.dumps(dict(
    train_walls=[r["wall_s"] for r in train["steps"]],
    peak_gib=train["peak_gib"], prefill_s=prefill)), flush=True)
'''


def main(argv) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"parent": Path(argv[0]).resolve(), "change": CHANGE}
    failed = False
    for name in ("parent", "change", "change", "parent"):
        p = subprocess.run([sys.executable, "-c", RUN], cwd=trees[name],
                           capture_output=True, text=True, timeout=900)
        line = [x for x in p.stdout.splitlines() if x.startswith("AB ")]
        res = dict(tree=name, rc=p.returncode,
                   **(json.loads(line[0][3:]) if line else {}))
        if p.returncode or not line:
            failed = True
            res["tail"] = (p.stdout + p.stderr)[-3000:]
        print(json.dumps(res), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
