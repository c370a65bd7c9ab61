"""Serve a small LM with batched requests on the PyTorch/CUDA port: SLA
prefill + KV-cache decode.

    PYTHONPATH=src:. python -m examples_torch.serve_lm --requests 8 --batch 4
    PYTHONPATH=src:. python -m examples_torch.serve_lm --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_arch
from repro_torch.models import registry
from repro_torch.serving.engine import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=96)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain twins)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch).smoke()  # CPU-runnable reduced config
    mdl = registry.get_model(cfg)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = mdl.init(gen, cfg, device=device)
    n = sum(x.numel() for x in params.parameters())
    print(f"serving {cfg.name} (reduced, {n/1e6:.2f}M params), "
          f"batch={args.batch}")

    rs = np.random.default_rng(args.seed)
    reqs = [
        Request(rid=i,
                prompt=rs.integers(0, cfg.vocab_size,
                                   size=args.prompt_len).astype(np.int32),
                max_new_tokens=args.max_new - (i % 3))
        for i in range(args.requests)
    ]
    engine = ServingEngine(cfg, params, batch_size=args.batch,
                           max_len=args.prompt_len + args.max_new + 8)
    t0 = time.time()
    done = engine.run(reqs)
    wall = time.time() - t0
    st = engine.stats
    print(f"served {len(done)} requests in {wall:.1f}s")
    print(f"prefill: {st.prefill_tokens} tok in {st.prefill_s:.2f}s | "
          f"decode: {st.decode_tokens} tok in {st.decode_s:.2f}s | "
          f"decode-slot occupancy {st.occupancy():.2f}")
    for r in done[:4]:
        print(f"  req {r.rid}: {len(r.tokens_out)} tokens | ttft "
              f"{r.metrics.ttft_s*1e3:.0f}ms | latency "
              f"{r.latency_s*1e3:.0f}ms -> {r.tokens_out[:8]}...")
    assert all(len(r.tokens_out) == r.max_new_tokens for r in done)
    assert all(r.latency_s == r.metrics.latency_s for r in done)
    print("all requests honored their token budgets; see "
          "examples_torch/serve_stream.py for the v2 continuous scheduler")
    return done


if __name__ == "__main__":
    main()
