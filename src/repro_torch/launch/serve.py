"""Serving CLI of the port: the streaming DiT denoise service.

    python -m repro_torch.launch.serve --workload dit --arch wan2_1_1_3b \
        --backend kernel --seq-len 32768
    PYTHONPATH=src python -m repro_torch.launch.serve --workload dit \
        --arch lightningdit_1b --smoke --device cpu --requests 3

Counterpart of `repro.launch.serve` with its DiT flags and defaults plus
`--device` (default cuda). Only `--workload dit` is ported; the LM
workload raises and names the ROADMAP item that ports it, and the LM
flags come with it. Request
latents come from `np.random.default_rng(--seed)` exactly as in the
reference, so a CPU run of the port and of the reference see the same
requests; the weights are random, from a seeded `torch.Generator`.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_arch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4,
                    help="dit: number of denoise slots")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="gather",
                    help="SLA execution backend: 'gather' (LUT gather, "
                         "default), 'reference' (dense oracle), 'kernel' "
                         "(the fused CUDA kernel; its plain twin on the "
                         "CPU). Unknown names fail loudly at startup")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; 'cpu' "
                         "runs the kernels' plain twins)")
    ap.add_argument("--drift-threshold", default=None,
                    help="re-plan a layer when its plan drift reaches "
                         "this; a comma-separated list gives one "
                         "threshold per layer. Default: "
                         "cfg.sla.plan_drift_threshold")
    ap.add_argument("--workload", default="lm", choices=["lm", "dit"],
                    help="'dit' serves streaming diffusion denoising; "
                         "'lm' is not ported yet")
    ap.add_argument("--num-steps", type=int, default=8,
                    help="dit: Euler denoise steps per request")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="dit: latent tokens per request (block-aligned). "
                         "Default: 2 SLA query blocks")
    ap.add_argument("--t-start", type=float, default=1.0,
                    help="dit: trajectory start time in (0, 1]")
    ap.add_argument("--refresh-mode", default=None,
                    choices=["fixed", "adaptive"],
                    help="dit: per-slot plan refresh policy. Default: "
                         "cfg.sla.plan_refresh_mode")
    ap.add_argument("--plan-cache", action="store_true",
                    help="dit: cross-request plan cache (not ported yet)")
    ap.add_argument("--stats-json", default=None, metavar="PATH",
                    help="after the run, dump ServeStats + per-request "
                         "metrics as JSON to PATH")
    ap.add_argument("--routing-mode", default=None,
                    choices=["threshold", "learned"],
                    help="block-classification router. Default: "
                         "cfg.sla.routing_mode")
    args = ap.parse_args(argv)
    if args.drift_threshold is not None:
        parts = [float(x) for x in str(args.drift_threshold).split(",")]
        args.drift_threshold = parts[0] if len(parts) == 1 else tuple(parts)
    if args.workload == "lm":
        raise NotImplementedError(
            "the LM serving workload is not ported to repro_torch yet "
            "(ROADMAP.md queue 1, item 14); use --workload dit")

    from repro_torch.core import backends as backend_registry
    backend_registry.resolve(args.backend)  # unknown names fail here

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.routing_mode is not None:
        cfg = dataclasses.replace(
            cfg, sla=cfg.sla.replace(routing_mode=args.routing_mode))
    cfg.sla.validate()
    if cfg.family != "dit":
        ap.error(f"--arch {args.arch} is not a DiT")
    device = resolve_device(args.device)
    from repro_torch.models import dit
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = dit.init(gen, cfg, device=device)
    rs = np.random.default_rng(args.seed)
    return _run_dit(args, cfg, params, rs, device)


def _run_dit(args, cfg, params, rs, device):
    """Synthetic denoise requests through the DiffusionScheduler, mixed
    timesteps sharing every batched tick."""
    from repro_torch.serving.api import percentile as pct
    from repro_torch.serving.diffusion import (DenoiseParams,
                                               DiffusionScheduler)

    seq_len = (2 * cfg.sla.block_q if args.seq_len is None
               else args.seq_len)
    sched = DiffusionScheduler(
        cfg, params, num_slots=args.batch, seq_len=seq_len,
        backend=args.backend, refresh_mode=args.refresh_mode,
        drift_threshold=args.drift_threshold,
        plan_cache=args.plan_cache or None, device=device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    for _ in range(args.requests):
        sched.submit(
            rs.standard_normal((seq_len, cfg.patch_dim), dtype=np.float32),
            DenoiseParams(num_steps=args.num_steps, t_start=args.t_start))
    done = sched.drain()
    wall = time.time() - t0
    st = sched.stats
    print(f"{len(done)} denoise requests ({args.num_steps} steps, "
          f"{seq_len} latent tokens) in {wall:.1f}s | "
          f"{st.denoise_steps} denoise steps | slot occupancy "
          f"{st.occupancy():.2f} ({st.slot_steps_active}/"
          f"{st.slot_steps_total} slot-steps)")
    print(f"plans: {st.plan_builds} built, {st.plan_reuses} reused, "
          f"{st.plan_replans} re-plans | retention "
          f"{st.last_retention:.3f}")
    lats = [r.metrics.latency_s for r in done
            if r.metrics.latency_s is not None]
    if lats:
        print(f"per-request: latency p50 {pct(lats, 0.5)*1e3:.0f}ms / "
              f"p95 {pct(lats, 0.95)*1e3:.0f}ms")
    if device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(device)} | peak "
              f"memory {torch.cuda.max_memory_allocated(device) / 2**30:.2f}"
              f" GiB")
    if args.stats_json:
        from repro_torch.serving.api import stats_json_payload
        with open(args.stats_json, "w") as f:
            json.dump(stats_json_payload("dit", st, done), f, indent=2,
                      default=float)
        print(f"stats json -> {args.stats_json}")
    return done


if __name__ == "__main__":
    main()
