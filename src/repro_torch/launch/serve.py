"""Serving CLI of the port: LM serving and the streaming DiT service.

    python -m repro_torch.launch.serve --arch qwen3-1.7b --decode-sla \
        --backend kernel --batch 2 --prompt-len 32000 --max-new 96
    python -m repro_torch.launch.serve --arch qwen3-1.7b --decode-sla \
        --backend kernel --scheduler continuous --paged --batch 4 \
        --requests 6 --prompt-len 32000 --max-new 64 --pool-pages 2053
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --smoke --device cpu --scheduler continuous --paged --decode-sla \
        --backend kernel --prefill-chunk 1 --requests 4 --batch 2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --smoke --device cpu --disagg --paged --prefill-chunk 1 \
        --decode-sla --backend kernel --requests 4 --batch 2
    PYTHONPATH=src python -m repro_torch.launch.serve --workload lm \
        --arch qwen3-1.7b --smoke --device cpu --decode-sla --backend kernel
    python -m repro_torch.launch.serve --workload dit --arch wan2_1_1_3b \
        --backend kernel --seq-len 32768
    PYTHONPATH=src python -m repro_torch.launch.serve --workload dit \
        --arch wan2_1_1_3b --smoke --device cpu --backend kernel \
        --plan-cache --t-buckets 8 --cache-entries 256

Counterpart of `repro.launch.serve` with its LM flags (the static engine,
the continuous scheduler with `--stream`, the paged KV cache with
`--paged` / `--pool-pages`), its DiT flags, the same argument checks and
defaults, plus `--device` (default cuda), chunked admission
(`--prefill-chunk`, with `--paged`) and disaggregated serving
(`--disagg`, `--prefill-workers`, `--decode-workers`: a prefill pool and
a decode pool with handoff bundles; `--batch` is then the slots of each
decode worker). Prompts and request latents come from
`np.random.default_rng(--seed)` exactly as in the reference, so a CPU run
of the port and of the reference see the same requests; the weights are
random, from a seeded `torch.Generator`.
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
                    help="lm static scheduler: decode group size; lm "
                         "continuous scheduler: number of decode slots; "
                         "dit: number of denoise slots")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=8)
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
    ap.add_argument("--scheduler", default="static",
                    choices=["static", "continuous"],
                    help="lm: 'static' decodes fixed groups in lockstep; "
                         "'continuous' runs the continuous-batching "
                         "scheduler (a fixed pool of decode slots; a "
                         "request is admitted the moment a slot frees)")
    ap.add_argument("--stream", action="store_true",
                    help="lm: print per-token StreamEvents as they are "
                         "produced (continuous scheduler only)")
    ap.add_argument("--plan-reuse", default="off",
                    choices=["off", "adaptive"],
                    help="lm: 'adaptive' pads every prefill chunk to one "
                         "block-aligned bucket, plans the per-layer block "
                         "structure once and reuses it across chunks, "
                         "re-planning a layer when its drift reaches "
                         "--drift-threshold")
    ap.add_argument("--decode-sla", action="store_true",
                    help="lm: decode with incremental SLA block plans and "
                         "the O(1) linear running state instead of dense "
                         "attention over the whole cache")
    ap.add_argument("--paged", action="store_true",
                    help="lm: paged KV cache: block_kv-sized physical pages "
                         "in a refcounted global pool, prompt prefixes "
                         "shared between requests (copy-on-write). "
                         "Requires --scheduler continuous")
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="total physical pages in the paged KV pool "
                         "(default: one full sequence per slot plus a "
                         "scratch page per slot and the zero page)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    metavar="BLOCKS",
                    help="lm: chunked admission prefill: a request that "
                         "misses the full-prompt snapshot owns its slot "
                         "in PREFILLING state and advances BLOCKS SLA "
                         "blocks of prompt per tick while the other slots "
                         "keep decoding, bounding the decode stall a long "
                         "prompt causes to one chunk. Requires --paged and "
                         "--scheduler continuous; lifts "
                         "sla.col_capacity_factor to None (printed): "
                         "chunk classification is row-decomposable only "
                         "uncapped")
    ap.add_argument("--disagg", action="store_true",
                    help="lm: disaggregated serving: a prefill worker pool "
                         "runs admission, a decode worker pool runs token "
                         "generation, with handoff bundles (prefill cache "
                         "+ decode-SLA state) routed to the least-loaded "
                         "decode worker and requeue of a lost worker's "
                         "in-flight requests. Greedy tokens equal the "
                         "single-Scheduler run's. --batch sets the slots "
                         "of EACH decode worker; incompatible with "
                         "--stream and --plan-reuse adaptive")
    ap.add_argument("--prefill-workers", type=int, default=1,
                    help="prefill pool size for --disagg")
    ap.add_argument("--decode-workers", type=int, default=2,
                    help="decode pool size for --disagg")
    ap.add_argument("--workload", default="lm", choices=["lm", "dit"],
                    help="'lm' serves autoregressive token generation "
                         "(default); 'dit' serves streaming diffusion "
                         "denoising")
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
                    help="dit: cross-request plan cache — admissions "
                         "look up per-(layer, timestep-bucket) SLAPlans "
                         "and validate them through the drift check "
                         "instead of planning from scratch "
                         "(serving/plan_cache.py)")
    ap.add_argument("--t-buckets", type=int, default=8,
                    help="dit: timestep buckets for --plan-cache keys")
    ap.add_argument("--cache-entries", type=int, default=256,
                    help="dit: LRU bound on --plan-cache entries "
                         "(per-layer, per-bucket)")
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
    if args.stream and args.scheduler != "continuous":
        ap.error("--stream requires --scheduler continuous")
    if args.paged and args.scheduler != "continuous" and not args.disagg:
        ap.error("--paged requires --scheduler continuous or --disagg")
    if args.prefill_chunk is not None and not args.paged \
            and not args.disagg:
        # in-process chunked admission lands through the page-table
        # scatter; the disaggregated prefill pool chunks on its carry,
        # with no pages, so --disagg lifts the requirement
        ap.error("--prefill-chunk requires --paged (chunks land "
                 "through the page-table scatter) or --disagg")
    if args.disagg and args.stream:
        ap.error("--disagg prints pool stats, not a token stream; "
                 "drop --stream")
    if args.disagg and args.plan_reuse != "off":
        ap.error("--disagg requires --plan-reuse off: requeue replays "
                 "a lost worker's prefill, which must be a pure "
                 "function of the prompt")
    if args.workload == "dit" and (args.disagg or args.stream or args.paged
                                   or args.decode_sla
                                   or args.plan_reuse != "off"
                                   or args.prefill_chunk is not None):
        ap.error("--workload dit serves denoise requests — --disagg/"
                 "--stream/--paged/--decode-sla/--plan-reuse/"
                 "--prefill-chunk are LM-serving flags")

    from repro_torch.core import backends as backend_registry
    backend_registry.resolve(args.backend)  # unknown names fail here

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.routing_mode is not None:
        cfg = dataclasses.replace(
            cfg, sla=cfg.sla.replace(routing_mode=args.routing_mode))
    if (args.prefill_chunk is not None
            and cfg.sla.col_capacity_factor is not None):
        # chunk plan rows are sliced from the full classification, which
        # the column-capacity demotion couples across rows; lifting the
        # cap keeps strictly more critical blocks, a valid SLA plan that
        # blocking admission applies alike
        print("--prefill-chunk: lifting sla.col_capacity_factor "
              f"({cfg.sla.col_capacity_factor} -> None); chunked "
              "classification is row-decomposable only uncapped")
        cfg = dataclasses.replace(
            cfg, sla=cfg.sla.replace(col_capacity_factor=None))
    cfg.sla.validate()
    device = resolve_device(args.device)
    rs = np.random.default_rng(args.seed)
    if args.workload == "dit":
        if cfg.family != "dit":
            ap.error(f"--arch {args.arch} is not a DiT")
        from repro_torch.models import dit
        gen = torch.Generator(device=device).manual_seed(args.seed)
        return _run_dit(args, cfg, dit.init(gen, cfg, device=device), rs,
                        device)
    if cfg.family == "dit":
        ap.error(f"--arch {args.arch} is a DiT; serve it with --workload "
                 "dit")
    return _run_lm(args, cfg, rs, device)


def _run_lm(args, cfg, rs, device):
    """Synthetic prompts through the static ServingEngine, the continuous
    Scheduler (`--stream`: events printed as they happen), the engine's
    continuous wrapper or the disaggregated pools (`--disagg`)."""
    from repro_torch.models import registry
    from repro_torch.serving.engine import Request, ServingEngine

    mdl = registry.get_model(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = mdl.init(gen, cfg, device=device)
    max_len = args.prompt_len + args.max_new + 8
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if args.disagg:
        return _run_disagg(args, cfg, params, rs, max_len, device)
    if args.scheduler == "continuous" and args.stream:
        from repro_torch.serving.api import SamplingParams, Scheduler
        sched = Scheduler(cfg, params, num_slots=args.batch,
                          max_len=max_len, backend=args.backend,
                          decode_sla=args.decode_sla or None,
                          plan_reuse=args.plan_reuse,
                          drift_threshold=args.drift_threshold,
                          paged=args.paged or None,
                          pool_pages=args.pool_pages,
                          prefill_chunk_blocks=args.prefill_chunk)
        t0 = time.time()
        for _ in range(args.requests):
            sched.submit(rs.integers(0, cfg.vocab_size,
                                     size=args.prompt_len).astype(np.int32),
                         SamplingParams(max_new_tokens=args.max_new))
        for ev in sched.stream():
            if ev.kind == "token":
                print(f"  [{ev.t - t0:7.3f}s] req {ev.rid} "
                      f"token[{ev.index}] = {ev.token}")
            else:
                print(f"  [{ev.t - t0:7.3f}s] req {ev.rid} {ev.kind}")
        done = sched.drain()
        _print_stats(args, sched.stats, len(done), time.time() - t0,
                     [r.metrics for r in done], sched.drift_threshold,
                     device)
        _stats_json(args, "continuous", sched.stats, done)
        return done
    reqs = [Request(rid=i, prompt=rs.integers(0, cfg.vocab_size,
                                              size=args.prompt_len)
                    .astype(np.int32), max_new_tokens=args.max_new)
            for i in range(args.requests)]
    engine = ServingEngine(cfg, params, batch_size=args.batch,
                           max_len=max_len, backend=args.backend,
                           plan_reuse=args.plan_reuse,
                           drift_threshold=args.drift_threshold,
                           decode_sla=args.decode_sla,
                           scheduler=args.scheduler,
                           paged=args.paged or None,
                           pool_pages=args.pool_pages,
                           prefill_chunk_blocks=args.prefill_chunk)
    t0 = time.time()
    done = engine.run(reqs)
    _print_stats(args, engine.stats, len(done), time.time() - t0,
                 [r.metrics for r in done if r.metrics is not None],
                 engine.drift_threshold, device)
    _stats_json(args, args.scheduler, engine.stats, done)
    return done


def _run_disagg(args, cfg, params, rs, max_len, device):
    """`--disagg`: synthetic prompts through the DisaggScheduler; prints
    the pools' occupancy, the fault counters and one row per decode
    worker."""
    from repro_torch.serving.api import SamplingParams
    from repro_torch.serving.api import percentile as pct
    from repro_torch.serving.disagg import DisaggScheduler

    ds = DisaggScheduler(cfg, params, prefill_workers=args.prefill_workers,
                         decode_workers=args.decode_workers,
                         slots_per_worker=args.batch, max_len=max_len,
                         backend=args.backend,
                         decode_sla=args.decode_sla or None,
                         paged=args.paged or None,
                         pool_pages=args.pool_pages,
                         prefill_chunk_blocks=args.prefill_chunk)
    t0 = time.time()
    for _ in range(args.requests):
        ds.submit(rs.integers(0, cfg.vocab_size,
                              size=args.prompt_len).astype(np.int32),
                  SamplingParams(max_new_tokens=args.max_new))
    done = ds.drain()
    wall = time.time() - t0
    st = ds.stats
    print(f"{st.completed}/{st.submitted} requests in {wall:.1f}s over "
          f"{st.ticks} ticks | prefill pool {args.prefill_workers}w occ "
          f"{st.prefill_occupancy():.2f} ({st.prefill_tokens} tok, "
          f"{st.prefill_chunks} chunks) | decode pool "
          f"{args.decode_workers}w occ {ds.decode_occupancy():.2f}")
    print(f"faults: {st.kills} kills, {st.requeues} requeues, "
          f"{st.straggler_drains} straggler drains, {st.retries} retries | "
          f"{st.handoffs} handoffs")
    for row in ds.pool_stats()["decode"]:
        print(f"  {row['worker']}: admitted {row['admitted']}, occupancy "
              f"{row['occupancy']:.2f}, {row['decode_tokens']} decode tokens"
              + (" [draining]" if row["draining"] else "")
              + ("" if row["alive"] else " [dead]"))
    ttfts = [r.metrics.ttft_s for r in done if r.metrics.ttft_s is not None]
    if ttfts:
        print(f"per-request: TTFT p50 {pct(ttfts, 0.5)*1e3:.0f}ms / p95 "
              f"{pct(ttfts, 0.95)*1e3:.0f}ms")
    if device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(device)} | peak memory "
              f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
    _stats_json(args, "disagg", st, done)
    return done


def _print_stats(args, st, n_done, wall, metrics, drift_threshold, device):
    print(f"{n_done} requests in {wall:.1f}s | prefill "
          f"{st.prefill_tokens} tok / {st.prefill_s:.2f}s | decode "
          f"{st.decode_tokens} tok / {st.decode_s:.2f}s")
    from repro_torch.serving.api import percentile as pct
    ttfts = [m.ttft_s for m in metrics if m.ttft_s is not None]
    lats = [m.latency_s for m in metrics if m.latency_s is not None]
    if ttfts and lats:
        print(f"per-request: TTFT p50 {pct(ttfts, 0.5)*1e3:.0f}ms / p95 "
              f"{pct(ttfts, 0.95)*1e3:.0f}ms | latency p50 "
              f"{pct(lats, 0.5)*1e3:.0f}ms / p95 {pct(lats, 0.95)*1e3:.0f}ms")
    if st.slot_steps_total:
        print(f"scheduler: {st.admissions} admissions | decode-slot "
              f"occupancy {st.occupancy():.2f} ({st.slot_steps_active}/"
              f"{st.slot_steps_total} slot-steps)")
    if args.paged:
        print(f"paged KV: {st.pages_in_use} pages in use "
              f"(peak {st.pages_peak}) | {st.page_allocs} allocs, "
              f"{st.cow_copies} CoW copies | prefix cache "
              f"{st.prefix_hits} page hits / {st.prefix_misses} misses, "
              f"{st.prefix_full_hits} full-prompt hits")
    if args.prefill_chunk:
        print(f"chunked admission: {st.chunked_admissions} requests in "
              f"{st.prefill_chunks} chunks | max inter-token gap "
              f"{st.max_decode_gap_s * 1e3:.0f}ms")
    if args.plan_reuse != "off":
        print(f"plan reuse: {st.plan_builds} built, {st.plan_reuses} "
              f"reused, {st.plan_replans} drift re-plans | retention "
              f"{st.last_retention:.3f} (threshold: drift >= "
              f"{drift_threshold})")
    if args.decode_sla:
        print(f"decode plans: {st.decode_plan_builds} layer plans built at "
              f"prefill, {st.decode_plan_extends} rows extended, "
              f"{st.decode_plan_reuses} live rows reused, "
              f"{st.decode_plan_replans} drift re-plans | retention "
              f"{st.decode_last_retention:.3f}")
    if device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(device)} | peak memory "
              f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")


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
        plan_cache=args.plan_cache, t_buckets=args.t_buckets,
        cache_entries=args.cache_entries, device=device)
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
    if sched.cache is not None:
        print(f"plan cache: {st.plan_cache_hits} hits / "
              f"{st.plan_cache_misses} misses, "
              f"{st.plan_cache_invalidations} drift invalidations, "
              f"{st.plan_cache_evictions} evictions "
              f"({len(sched.cache)} entries)")
    lats = [r.metrics.latency_s for r in done
            if r.metrics.latency_s is not None]
    if lats:
        print(f"per-request: latency p50 {pct(lats, 0.5)*1e3:.0f}ms / "
              f"p95 {pct(lats, 0.95)*1e3:.0f}ms")
    if device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(device)} | peak "
              f"memory {torch.cuda.max_memory_allocated(device) / 2**30:.2f}"
              f" GiB")
    _stats_json(args, "dit", st, done)
    return done


def _stats_json(args, mode, st, requests):
    """--stats-json: ServeStats + per-request metrics as JSON."""
    if not args.stats_json:
        return
    from repro_torch.serving.api import stats_json_payload
    with open(args.stats_json, "w") as f:
        json.dump(stats_json_payload(mode, st, requests), f, indent=2,
                  default=float)
    print(f"stats json -> {args.stats_json}")


if __name__ == "__main__":
    main()
