"""Worked example for every launch/serve.py flag of the PyTorch/CUDA
port, centered on routing.

Runs the SAME synthetic request stream through four serving
configurations and prints a comparison table:

  1. baseline          dense decode, plan per chunk, threshold routing
  2. +plan-reuse       `--plan-reuse adaptive --drift-threshold 0.1`
                       (prefill block plans reused across request
                       chunks, re-planned on measured drift)
  3. +decode-sla       `--decode-sla` (incremental decode plans + the
                       O(1) linear running state; per-token attention
                       is critical-blocks + O(1), not O(context))
  4. +learned routing  `--routing-mode learned` on top of (3): the
                       trainable SLA2-style block scorer. At identity
                       init it reproduces the threshold router
                       BITWISE, so this run must emit the same tokens
                       as (3) — asserted below. After a distillation
                       fine-tune (launch/train.py --distill
                       --routing-mode learned --train-only
                       routing,sla_proj) the scorer routes better than
                       the hand-tuned rule at the same FLOP budget.

Every configuration is driven through `repro_torch.launch.serve.main`,
i.e. the real CLI surface:

    PYTHONPATH=src:. python -m examples_torch.serve_routing
    PYTHONPATH=src:. python -m examples_torch.serve_routing --device cpu
"""
import argparse
import contextlib
import io

from repro_torch.launch import serve

COMMON = ["--arch", "qwen3-1.7b", "--smoke", "--requests", "4",
          "--batch", "2", "--prompt-len", "32", "--max-new", "8",
          "--backend", "gather"]

CONFIGS = [
    ("baseline", []),
    ("plan-reuse", ["--plan-reuse", "adaptive",
                    "--drift-threshold", "0.1"]),
    ("decode-sla", ["--decode-sla"]),
    ("decode-sla+learned", ["--decode-sla",
                            "--routing-mode", "learned"]),
]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain twins)")
    args = ap.parse_args(argv)
    tokens = {}
    for name, extra in CONFIGS:
        argv = COMMON + ["--device", args.device] + extra
        print(f"\n=== {name}: serve.py {' '.join(extra) or '(defaults)'} "
              f"===")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            done = serve.main(argv)
        print(buf.getvalue().strip())
        tokens[name] = [r.tokens_out for r in done]
        assert all(len(r.tokens_out) == r.max_new_tokens for r in done)

    # identity-initialized learned routing must route exactly like the
    # threshold rule — same plans, same tokens (DESIGN.md "Learned
    # routing"); fresh params make the two decode-SLA runs comparable
    assert tokens["decode-sla+learned"] == tokens["decode-sla"], \
        "learned routing at init must reproduce threshold routing"
    print("\nlearned routing at identity init emitted identical tokens "
          "to threshold routing (bitwise plan parity) — fine-tune with "
          "launch/train.py --distill --routing-mode learned to move it")
    return tokens


if __name__ == "__main__":
    main()
