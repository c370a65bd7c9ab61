#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py             # the check, on one card
    python3 chip_smoke.py --profile   # also profile one full-width forward

Phases, in order; any failure exits non-zero before the result line:
  1. card: nvidia-smi name and power limit; TF32 off for matmul and cuDNN.
  2. build: every CUDA kernel of the port from its source, with the
     -Xptxas -v report.
  3. kernel vs plain twin: `sla_fwd` against `sla_fwd_plain` on the same
     card tensors at the Wan2.1 shape (B=1, H=12, N=32768, D=128) and the
     LightningDiT shape (H=16, N=1024, D=108), 64x64 blocks, LUTs from
     `plan_attention`, in f32 and bf16: max abs error on o_s, o_l and lse
     against 5e-5 in both dtypes (kernel and twin read the same inputs and
     accumulate in f32); CUDA-event times of the kernel, the
     plain twin, the gather backend, and dense scaled_dot_product_attention
     (a yardstick for dense attention, not the same function).
  4. main path: the DiffusionScheduler serving wan2_1_1_3b at full width
     and depth (30 layers, random seeded weights) on the kernel backend in
     f32: 3 requests at seq_len 32768 (t_start 1.0, 0.75, 1.0; 4 steps
     each) through 2 slots. Checks every request finished with finite
     latents and that the kernel ran 30 times per forward.
  5. cross-check: one full-width forward on the kernel backend and again
     on the gather backend with the same inputs and plans (1e-4 of max
     |v|); then the kernel against its twin (5e-5) on that forward's own
     sparse, uneven LUTs of the first and last layer at the Wan shape.
  6. the kernels line (JSON), then the result line.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import phi as phi_lib  # noqa: E402
from repro_torch.core import plan as plan_lib  # noqa: E402
from repro_torch.core.block_sparse_xla import sla_forward_gather  # noqa: E402
from repro_torch.kernels import _build, ops, sla_fwd  # noqa: E402
from repro_torch.models import dit  # noqa: E402
from repro_torch.models.common import dense_init  # noqa: E402
from repro_torch.serving.diffusion import (DenoiseParams,  # noqa: E402
                                           DiffusionScheduler)

# Kernel vs plain twin: both read the same (possibly bf16) inputs and
# accumulate in f32, so bf16 is held to the f32 limit too; the 5e-2 of
# tests/test_conformance.py is for the port's bf16 path against JAX's.
TWIN_TOL = 5e-5
FWD_TOL = 1e-4  # kernel vs gather velocity, relative to max(1, max |v|)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {torch.float32: 67e12,  # f32 FMA on CUDA cores
              torch.bfloat16: 989e12}  # bf16 dense tensor cores
SHAPES = {  # name: (arch, heads, seq_len, head_dim)
    "wan2_1_1_3b": ("wan2_1_1_3b", 12, 32768, 128),
    "lightningdit_1b": ("lightningdit_1b", 16, 1024, 108),
}
MAIN_SEQ, MAIN_SLOTS, MAIN_STEPS = 32768, 2, 4
MAIN_T_STARTS = (1.0, 0.75, 1.0)
DEV = torch.device("cuda")


def say(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() from CUDA events over `reps` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------------------
def phase_card() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    say(f"[1 card] torch {torch.__version__} (CUDA {torch.version.cuda}) | "
        f"{torch.cuda.get_device_name(0)} | {torch.cuda.device_count()} "
        f"device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build():
    t0 = time.time()
    logs = {name: _build.build(name) for name in _build.kernel_names()}
    say(f"[2 build] {len(logs)} kernel source(s) in {time.time() - t0:.1f}s")
    for name, log in logs.items():
        for line in log.splitlines():
            if re.search(r"registers|spill|smem|stack frame", line):
                say(f"  {name}: {line.strip()}")


# --------------------------------------------------------------------------
def _kernel_inputs(arch: str, h: int, n: int, d: int, seed: int):
    """Seeded q/k/v at one shape and the port's plan for them."""
    cfg = get_arch(arch)
    sla = cfg.sla.replace(causal=False)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    q, k, v = (torch.randn((1, h, n, d), generator=gen, device=DEV)
               for _ in range(3))
    plan = plan_lib.plan_attention(q, k, sla)
    return sla, q, k, v, plan


def _operands(sla, q, k, v, marginal, lut, counts, dtype):
    """The kernel's flattened operands in `dtype` for one plan's
    (B, H, ...) marginal / lut / counts, with hi/zi aggregated as the
    kernel backend does, plus the 4-D inputs for the backends."""
    q, k, v = (x.to(dtype) for x in (q, k, v))
    qp, kp = phi_lib.phi(q, sla.phi), phi_lib.phi(k, sla.phi)
    fq, fk, fv, fqp, fkp = map(ops._flat, (q, k, v, qp, kp))
    a, lut, counts = map(ops._flat, (marginal, lut, counts))
    hb, zb = ops._hz_blocks(fkp, fv, sla.block_kv)
    hi, zi = ops._aggregate(a, hb, zb)
    args = (lut, counts, fq, fk, fv, fqp, hi, zi)
    kw = dict(scale=q.shape[-1] ** -0.5, causal=False,
              block_q=sla.block_q, block_kv=sla.block_kv)
    return args, kw, (q, k, v, qp, kp)


def _bound(args, kw, dtype):
    """Least time for this call: the larger of bytes (each input read
    once, each output written once) over HBM bandwidth and this data's
    operations (live critical tiles + linear merge) over the peak rate."""
    lut, counts, q, k, v, qp, hi, zi = args
    bh, nq, d = q.shape
    bq, bkv = kw["block_q"], kw["block_kv"]
    nbytes = sum(t.numel() * t.element_size() for t in args)
    nbytes += 2 * bh * nq * d * 4 + bh * nq * 4  # o_s, o_l, lse
    live = int(torch.clamp(counts, max=lut.shape[-1]).sum())
    flops = live * 4 * bq * bkv * d + (nq // bq) * bh * (2 * bq * d * d
                                                        + 2 * bq * d)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", flops, nbytes,
            live)


def _twin_errors(args, kw, what: str):
    """Max abs error of the kernel against its plain twin on o_s, o_l and
    lse for the same card operands; raises on a non-finite output."""
    got = sla_fwd.sla_fwd(*args, **kw)
    want = sla_fwd.sla_fwd_plain(*args, **kw)
    torch.cuda.synchronize()
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    if not all(np.isfinite(errs)):
        raise RuntimeError(f"{what}: non-finite output")
    return errs


def phase_kernel_vs_plain():
    rows = []
    for shape, (arch, h, n, d) in SHAPES.items():
        sla, q, k, v, plan = _kernel_inputs(arch, h, n, d, seed=1)
        for dtype in (torch.float32, torch.bfloat16):
            args, kw, (qd, kd, vd, qpd, kpd) = _operands(
                sla, q, k, v, plan.marginal, plan.lut, plan.counts, dtype)
            errs = _twin_errors(args, kw, f"{shape} {dtype}")
            err = max(errs)
            ok = err <= TWIN_TOL
            ms = cuda_ms(lambda: sla_fwd.sla_fwd(*args, **kw), 20)
            plain_ms = cuda_ms(lambda: sla_fwd.sla_fwd_plain(*args, **kw),
                               10, warmup=1)
            gather_ms = cuda_ms(lambda: sla_forward_gather(
                qd, kd, vd, qpd, kpd, plan, sla), 10, warmup=1)
            backend_ms = cuda_ms(lambda: ops.sla_attention_core(
                qd, kd, vd, qpd, kpd, plan, sla), 10, warmup=1)
            sdpa_ms = cuda_ms(lambda: torch.nn.functional
                              .scaled_dot_product_attention(qd, kd, vd),
                              10, warmup=1)
            bound_ms, bound_by, flops, nbytes, live = _bound(args, kw, dtype)
            dname = "f32" if dtype == torch.float32 else "bf16"
            say(f"[3 kernel] {shape} {dname} (BH={args[2].shape[0]}, "
                f"N={n}, D={d}, K={plan.k_sel}, live tiles {live}): max abs "
                f"err o_s {errs[0]:.3g} o_l {errs[1]:.3g} lse {errs[2]:.3g} "
                f"(tol {TWIN_TOL:g}) {'OK' if ok else 'FAIL'}")
            say(f"  kernel {ms:.3f} ms | bound {bound_ms:.3f} ms by "
                f"{bound_by} ({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.0f} MB)"
                f" | plain twin {plain_ms:.3f} ms | gather backend "
                f"{gather_ms:.3f} ms | kernel backend (h/z + aggregate + "
                f"kernel) {backend_ms:.3f} ms | dense SDPA yardstick (not "
                f"the same function) {sdpa_ms:.3f} ms")
            rows.append(dict(shape=shape, dtype=dname, bh=args[2].shape[0],
                             n=n, d=d, k_sel=plan.k_sel, live_tiles=live,
                             max_abs_err=err, tol=TWIN_TOL, ok=ok, ms=ms,
                             plain_ms=plain_ms, gather_ms=gather_ms,
                             kernel_backend_ms=backend_ms,
                             dense_sdpa_ms=sdpa_ms, bound_ms=bound_ms,
                             bound_by=bound_by, gflop=flops / 1e9,
                             mbytes=nbytes / 1e6))
            del args
        del q, k, v, plan
        torch.cuda.empty_cache()
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"kernel disagrees with its plain twin: {bad}")
    return rows


# --------------------------------------------------------------------------
def _main_model(seed: int):
    """Full-width wan2_1_1_3b with random weights from a seeded generator.
    The zero-initialized output projection and SLA Proj (AdaLN-zero and
    the paper's Proj init) are redrawn so that the velocity and the
    linear branch are not identically zero."""
    cfg = get_arch("wan2_1_1_3b")
    gen = torch.Generator(device=DEV).manual_seed(seed)
    params = dit.init(gen, cfg, device=DEV)
    with torch.no_grad():
        params.patch_out.copy_(dense_init(gen, cfg.d_model, cfg.patch_dim,
                                          device=DEV))
        for layer in params.layers:
            layer.sla_proj.copy_(0.1 * torch.randn(
                layer.sla_proj.shape, generator=gen, device=DEV))
    return cfg, params


def phase_main_path(cfg, params):
    rs = np.random.default_rng(0)
    sched = DiffusionScheduler(cfg, params, num_slots=MAIN_SLOTS,
                               seq_len=MAIN_SEQ, backend="kernel",
                               compute_dtype=torch.float32, device=DEV)
    for t_start in MAIN_T_STARTS:
        sched.submit(rs.standard_normal((MAIN_SEQ, cfg.patch_dim),
                                        dtype=np.float32),
                     DenoiseParams(num_steps=MAIN_STEPS, t_start=t_start),
                     cond=rs.standard_normal((cfg.cond_len, cfg.d_model),
                                             dtype=np.float32))
    forwards = 0
    orig_forward = dit.forward

    def counted_forward(*a, **kw):
        nonlocal forwards
        forwards += 1
        return orig_forward(*a, **kw)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sla_fwd.LAUNCHES = 0
    dit.forward = counted_forward
    t0 = time.time()
    try:
        done = sched.drain()
    finally:
        dit.forward = orig_forward
    wall = time.time() - t0
    launches = sla_fwd.LAUNCHES
    peak = torch.cuda.max_memory_allocated() / 2**30
    st = sched.stats
    ticks = st.slot_steps_total // MAIN_SLOTS
    say(f"[4 main] {len(done)} requests x {MAIN_STEPS} steps at seq_len "
        f"{MAIN_SEQ} through {MAIN_SLOTS} slots in {wall:.2f}s | "
        f"{st.admissions} admissions + {ticks} ticks = {forwards} forwards "
        f"| plans built {st.plan_builds}, reused {st.plan_reuses}, "
        f"re-planned {st.plan_replans} | peak memory {peak:.2f} GiB")
    lat = []
    for r in done:
        m = r.metrics
        lat.append(m.latency_s)
        finite = r.result is not None and bool(np.isfinite(r.result).all())
        say(f"  request {r.rid} (t_start {r.params.t_start}): latency "
            f"{m.latency_s:.3f}s, queue {m.queue_s:.3f}s, first step "
            f"{m.ttft_s:.3f}s, {m.decode_tokens} steps, state "
            f"{r.state.value}, latent finite {finite}, |latent| max "
            f"{float(np.abs(r.result).max()):.3f}")
        if r.state.value != "finished" or not finite \
                or r.result.shape != (MAIN_SEQ, cfg.patch_dim):
            raise RuntimeError(f"request {r.rid} did not finish with a "
                               f"finite latent of the expected shape")
    want = cfg.num_layers * forwards
    say(f"  sla_fwd launches {launches} (expected {cfg.num_layers} x "
        f"{forwards} forwards = {want})")
    if launches != want or launches == 0:
        raise RuntimeError(f"main path launched sla_fwd {launches} times, "
                           f"expected {want}")
    return dict(launches=launches, forwards=forwards, wall_s=wall,
                peak_gib=peak, latency_s=lat, ticks=ticks,
                plan_builds=st.plan_builds, plan_replans=st.plan_replans,
                plan_reuses=st.plan_reuses)


def phase_cross_check(cfg, params, profile: bool):
    rs = np.random.default_rng(1)
    lat = torch.from_numpy(rs.standard_normal(
        (1, MAIN_SEQ, cfg.patch_dim), dtype=np.float32)).to(DEV)
    cond = torch.from_numpy(rs.standard_normal(
        (1, cfg.cond_len, cfg.d_model), dtype=np.float32)).to(DEV)
    t = torch.full((1,), 0.6, device=DEV)

    def run(backend, **kw):
        torch.cuda.synchronize()
        t0 = time.time()
        with torch.no_grad():
            out = dit.forward(params, cfg, lat, t, cond, torch.float32,
                              backend, **kw)
        torch.cuda.synchronize()
        return out, time.time() - t0

    (vel_k, plans), s_plan = run("kernel", return_plans=True)
    vel_k2, s_k = run("kernel", plans=plans)
    vel_g, s_g = run("gather", plans=plans)
    diff = float((vel_k2 - vel_g).abs().max())
    scale = float(vel_g.abs().max())
    replay = float((vel_k2 - vel_k).abs().max())
    ok = bool(np.isfinite(diff)) and diff <= FWD_TOL * max(1.0, scale)
    k_sel = plans.lut.shape[-1]
    live = int(torch.clamp(plans.counts, max=k_sel).sum())
    say(f"[5 plans] the forward's plans hold {live} live critical tiles over "
        f"{cfg.num_layers} layers ({live / plans.counts.numel():.2f} per "
        f"query block of at most K={k_sel}; "
        f"{float((plans.mc == 1).float().mean()):.4f} critical, "
        f"{float((plans.mc == 0).float().mean()):.4f} marginal)")
    say(f"[5 cross-check] full-width forward (B=1, N={MAIN_SEQ}): kernel "
        f"vs gather max |dv| {diff:.3g} (max |v| {scale:.3g}, tol "
        f"{FWD_TOL:g} x max(1, max |v|)) {'OK' if ok else 'FAIL'} | kernel "
        f"with given plans vs with inline planning {replay:.3g} | forward "
        f"wall: kernel+planning {s_plan:.3f}s, kernel {s_k:.3f}s, gather "
        f"{s_g:.3f}s")
    if not ok:
        raise RuntimeError("kernel and gather backends disagree on the "
                           "full-width forward")
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            run("kernel", plans=plans)
        say(prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=15))
    return plans, dict(max_abs_diff=diff, max_abs_v=scale,
                       kernel_fwd_s=s_k, gather_fwd_s=s_g,
                       plan_fwd_s=s_plan, live_tiles=live)


def phase_kernel_on_path_plans(cfg, plans):
    """The kernel against its twin on the LUTs the full-width forward
    built (sparse, uneven counts after the column cap), at the Wan shape
    with seeded q/k/v: the first and the last layer, f32 and bf16."""
    sla = cfg.sla
    h, n, d = cfg.num_heads, MAIN_SEQ, cfg.head_dim
    gen = torch.Generator(device=DEV).manual_seed(2)
    q, k, v = (torch.randn((1, h, n, d), generator=gen, device=DEV)
               for _ in range(3))
    rows = []
    for layer in (0, cfg.num_layers - 1):
        lp = [x[layer] for x in (plans.marginal, plans.lut, plans.counts)]
        live = int(torch.clamp(lp[2], max=lp[1].shape[-1]).sum())
        for dtype in (torch.float32, torch.bfloat16):
            args, kw, _ = _operands(sla, q, k, v, *lp, dtype)
            what = f"layer {layer} plans {dtype}"
            errs = _twin_errors(args, kw, what)
            err = max(errs)
            ok = err <= TWIN_TOL
            ms = cuda_ms(lambda: sla_fwd.sla_fwd(*args, **kw), 20)
            bound_ms, bound_by, _, _, _ = _bound(args, kw, dtype)
            dname = "f32" if dtype == torch.float32 else "bf16"
            say(f"[5 path plans] wan2_1_1_3b layer {layer} {dname} (live "
                f"tiles {live} of {lp[1].numel()}): max abs err o_s "
                f"{errs[0]:.3g} o_l {errs[1]:.3g} lse {errs[2]:.3g} (tol "
                f"{TWIN_TOL:g}) {'OK' if ok else 'FAIL'} | kernel {ms:.3f} "
                f"ms | bound {bound_ms:.3f} ms by {bound_by}")
            rows.append(dict(shape=f"wan2_1_1_3b layer {layer} plans",
                             dtype=dname, live_tiles=live, max_abs_err=err,
                             tol=TWIN_TOL, ok=ok, ms=ms, bound_ms=bound_ms,
                             bound_by=bound_by))
            del args
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"kernel disagrees with its plain twin on the "
                           f"path's plans: {bad}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also run torch.profiler over one full-width "
                         "forward and print the top device-time entries")
    args = ap.parse_args(argv)
    t_all = time.time()
    phase_card()
    phase_build()
    rows = phase_kernel_vs_plain()
    cfg, params = _main_model(seed=0)
    main_run = phase_main_path(cfg, params)
    plans, cross = phase_cross_check(cfg, params, args.profile)
    rows += phase_kernel_on_path_plans(cfg, plans)
    wan32 = next(r for r in rows
                 if r["shape"] == "wan2_1_1_3b" and r["dtype"] == "f32")
    kernels = [{
        "name": "sla_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sla_fwd.cu",
        "replaces": "src/repro/kernels/sla_fwd.py:34",
        "launches": main_run["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": wan32["ms"], "plain_ms": wan32["plain_ms"],
        "bound_ms": wan32["bound_ms"], "bound_by": wan32["bound_by"],
        "library_ms": None,
        "dense_sdpa_ms": wan32["dense_sdpa_ms"],
        "gather_ms": wan32["gather_ms"],
        "cases": rows,
    }]
    say(f"[6] main path {main_run} | cross-check {cross} | total "
        f"{time.time() - t_all:.1f}s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
