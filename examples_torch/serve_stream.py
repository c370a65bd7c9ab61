"""Serving API v2 end to end on the PyTorch/CUDA port: continuous
batching, streaming, sampling.

    PYTHONPATH=src:. python -m examples_torch.serve_stream
    PYTHONPATH=src:. python -m examples_torch.serve_stream --device cpu

Drives `repro_torch.serving.api.Scheduler` directly (the surface
`launch/serve.py --scheduler continuous` wraps): staggered submissions,
per-token StreamEvents, mixed greedy/temperature sampling with stop
tokens, and the per-request metrics the v1 engine could not report —
then cross-checks greedy tokens against the static-batch engine.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_arch
from repro_torch.models import registry
from repro_torch.serving.api import SamplingParams, Scheduler
from repro_torch.serving.engine import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain twins)")
    args = ap.parse_args(argv)
    cfg = get_arch("qwen3-1.7b").smoke()  # CPU-runnable reduction
    mdl = registry.get_model(cfg)
    device = resolve_device(args.device)
    params = mdl.init(torch.Generator(device=device).manual_seed(0), cfg,
                      device=device)
    rs = np.random.default_rng(0)
    prompts = [rs.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (32, 20, 32, 24)]
    budgets = [6, 14, 4, 9]

    sched = Scheduler(cfg, params, num_slots=2, max_len=96,
                      prefill_bucket=32)
    t0 = time.time()
    # two requests up front...
    for p, b in zip(prompts[:2], budgets[:2]):
        sched.submit(p, SamplingParams(max_new_tokens=b))
    # ...stream a few steps, then two more arrive mid-flight (the
    # staggered-arrival pattern static batching cannot express)
    n_events = 0
    for _ in range(3):
        for ev in sched.step():
            n_events += 1
    sched.submit(prompts[2], SamplingParams(max_new_tokens=budgets[2]))
    sched.submit(prompts[3], SamplingParams(max_new_tokens=budgets[3],
                                            temperature=0.8, seed=7))
    for ev in sched.stream():
        n_events += 1
        if ev.kind == "token":
            print(f"  [{ev.t - t0:6.3f}s] req {ev.rid} "
                  f"token[{ev.index}] = {ev.token}")
        else:
            print(f"  [{ev.t - t0:6.3f}s] req {ev.rid} -- {ev.kind}")
    done = sched.drain()

    print(f"\n{len(done)} requests, {n_events} events, "
          f"occupancy {sched.stats.occupancy():.2f}, "
          f"{sched.stats.admissions} admissions")
    for r in done:
        m = r.metrics
        print(f"  req {r.rid}: {len(r.tokens_out)} tok | queue "
              f"{m.queue_s*1e3:.0f}ms | ttft {m.ttft_s*1e3:.0f}ms | "
              f"latency {m.latency_s*1e3:.0f}ms")

    # greedy requests must match the static-batch engine exactly (same
    # decode batch width: a full group of 2 vs the 2-slot pool)
    reqs = [Request(rid=i, prompt=prompts[i], max_new_tokens=budgets[i])
            for i in range(2)]
    static = ServingEngine(cfg, params, batch_size=2, max_len=96)
    for a, b in zip(static.run(reqs), done[:2]):
        assert a.tokens_out == b.tokens_out, (a.rid, a.tokens_out,
                                              b.tokens_out)
    print("greedy tokens identical to the static-batch engine")
    return done


if __name__ == "__main__":
    main()
