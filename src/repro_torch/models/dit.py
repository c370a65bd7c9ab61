"""Diffusion Transformer (the paper's home architecture).

Wan2.1-style video DiT: patchified latent tokens, AdaLN-zero timestep
modulation, bidirectional SLA self-attention, optional cross-attention to
text conditioning. Covers `wan2_1_1_3b` (video, seq ~32K) and
`lightningdit_1b` (image, seq 1024).

Counterpart of `repro.models.dit`. The parameters live in `nn.Module`s in
the reference's layout (`x @ W`, W of shape (in, out)); the reference's
layer-stacked params are an `nn.ModuleList`, its `lax.scan` over layers
and steps and its `lax.cond` are Python loops and branches. Plans carry a
leading layer axis, as in the reference.

Under `distributed.ctx.activation_sharding(remat=True)` each layer is
rematerialized, as the reference's `ctx.maybe_remat` scan body: its
activations are recomputed in the backward. The recompute reuses the
block plan the first pass built (and any drift re-plan it made), so a
layer is planned once per forward whether or not it is recomputed, and
the recompute attends over the same blocks.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core import masks as masks_lib
from repro_torch.core import plan as plan_lib
from repro_torch.distributed import ctx, serving
from repro_torch.models.common import (attention, dense_init, kv_kind,
                                       local_kv_heads, mse_loss, rms_norm)


class DiTLayer(nn.Module):
    """One DiT block's parameters (the reference's `layers` leaves at one
    layer index)."""

    def __init__(self, cfg: ArchConfig, generator=None, dtype=torch.float32,
                 device=None):
        super().__init__()
        d, h, dh, hkv = cfg.d_model, cfg.num_heads, cfg.head_dim, \
            cfg.num_kv_heads

        def dense(i, o):
            return nn.Parameter(dense_init(generator, i, o, dtype, device))

        def zeros(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=dtype,
                                            device=device))

        self.ln1, self.ln2 = zeros(d), zeros(d)
        self.wq, self.wk = dense(d, h * dh), dense(d, hkv * dh)
        self.wv, self.wo = dense(d, hkv * dh), dense(h * dh, d)
        self.sla_proj = zeros(h, dh, dh)
        self.mlp_wi, self.mlp_wo = dense(d, 2 * cfg.d_ff), dense(cfg.d_ff, d)
        # AdaLN-zero: 6 modulation vectors from the timestep embedding
        self.ada = nn.Parameter((torch.randn(
            (d, 6 * d), generator=generator, dtype=torch.float32,
            device=device) * 0.01).to(dtype))
        if cfg.sla.routing_mode == "learned":
            r = masks_lib.routing_init(h, dh, dtype, device)
            self.routing = nn.ParameterDict(
                {name: nn.Parameter(w) for name, w in r.items()})
        if cfg.cross_attn:
            self.ln_x = zeros(d)
            self.xq, self.xk = dense(d, h * dh), dense(d, hkv * dh)
            self.xv, self.xo = dense(d, hkv * dh), dense(h * dh, d)


class DiT(nn.Module):
    """The DiT's parameters; `DiT.forward` runs `models.dit.forward`."""

    def __init__(self, cfg: ArchConfig, generator=None, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.layers = nn.ModuleList(
            DiTLayer(cfg, generator, dtype, device)
            for _ in range(cfg.num_layers))
        self.patch_in = nn.Parameter(
            dense_init(generator, cfg.patch_dim, d, dtype, device))
        self.t_embed = nn.Parameter(
            dense_init(generator, 256, d, dtype, device))
        self.ln_f = nn.Parameter(torch.zeros(d, dtype=dtype, device=device))
        self.patch_out = nn.Parameter(
            torch.zeros((d, cfg.patch_dim), dtype=dtype, device=device))

    def forward(self, latents, t, cond=None, **kw):
        return forward(self, self.cfg, latents, t, cond, **kw)


def init(generator: Optional[torch.Generator], cfg: ArchConfig,
         dtype=torch.float32, device=None) -> DiT:
    """Random DiT parameters drawn from `generator` (which must live on
    the target device). Entry point: runs on CUDA unless `device` says
    otherwise. Not bitwise the reference's init (JAX and torch random
    streams differ); tests carry the reference's weights over with
    `repro_torch.bridge`."""
    dev = resolve_device(device)
    return DiT(cfg, generator, dtype, dev)


def _timestep_embedding(t: torch.Tensor, dim: int = 256) -> torch.Tensor:
    half = dim // 2
    log_base = torch.log(torch.tensor(10000.0, dtype=torch.float32,
                                      device=t.device))
    idx = torch.arange(half, dtype=torch.float32, device=t.device)
    freq = torch.exp(-log_base * idx / half)
    ang = t.float()[:, None] * freq[None, :]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def forward(params: DiT, cfg: ArchConfig, latents: torch.Tensor, t,
            cond: Optional[torch.Tensor] = None,
            compute_dtype=torch.bfloat16, backend: str = "gather",
            sla_mode: Optional[str] = None, plans=None,
            return_plans: bool = False, drift_threshold=None,
            per_sample_refresh: bool = False):
    """latents: (B, N, patch_dim); t: per-sample (B,) diffusion time in
    [0, 1], or a scalar broadcast to the batch. cond: (B, Lc, d) text
    embeddings. Returns the velocity prediction, shaped like latents.
    `params` is the DiT module or a tree of its tensors with the same
    attributes (`launch.steps.cast_params_bf16`).

    `return_plans=True` also returns the per-layer SLAPlan stack (leading
    axis = layer); pass it back as `plans=` to skip planning. With `plans`
    AND `drift_threshold` (scalar or per-layer (L,)), each layer measures
    its reused plan's drift and re-plans only when drift reaches its
    threshold; the return gains {"retention": (L,), "replanned": (L,)}.
    `per_sample_refresh=True` makes that decision per batch row
    (thresholds broadcast to (L, B), info entries (L, B)).

    Under `activation_sharding(mesh, ...)` the inputs are the global
    batch: this rank keeps its rows of it (data parallelism) or of the
    sequence (context parallelism), runs its heads and FFN columns of
    every layer (`distributed.ctx`) and returns the velocity of its rows.
    Its plans are its part of the stack: leaves (L, B_local, H_local,
    ...), B_local its data rows (the whole batch under context
    parallelism, where q and k are gathered to the whole sequence, so the
    block grid is the whole sequence's) and H_local its "model" heads;
    `plans=` takes that part (anything else raises a ValueError naming
    the expected shape) and `return_plans=True` returns it. Per-sample
    thresholds are the global batch's (L, B). The drift gate's MIN
    crosses the ranks that hold the rest of a decision
    (`core.plan.refresh_plan`), so the info holds the global decisions:
    (L,), or (L, B_local) per sample for this rank's rows.
    """
    dev = latents.device
    t = torch.as_tensor(t, dtype=torch.float32, device=dev)
    if t.ndim == 0:
        t = t.expand(latents.shape[0])
    batch, seq = latents.shape[:2]
    latents = ctx.seq_rows(ctx.batch_rows(latents))
    t, cond = ctx.batch_rows(t), ctx.batch_rows(cond)
    b, n = latents.shape[:2]
    cd = compute_dtype
    x = latents.to(cd) @ ctx.fsdp_gather(params.patch_in, "rep").to(cd)
    temb = _timestep_embedding(t * 1000.0) \
        @ ctx.fsdp_gather(params.t_embed, "rep").float()
    temb = F.silu(temb).to(cd)
    _, m = ctx.model_rank_size()
    h, hkv, dh = cfg.num_heads // m, cfg.num_kv_heads, cfg.head_dim
    kvk = kv_kind(hkv)
    hk = hkv // m if kvk == "col" else hkv

    def kv_heads(t):
        return local_kv_heads(t, cfg.num_heads, hkv)
    sla_cfg = dataclasses.replace(cfg.sla, causal=False)
    if sla_mode is not None:
        sla_cfg = dataclasses.replace(sla_cfg, mode=sla_mode)
    kind = "sla" if (cfg.attention_kind == "sla" or sla_mode is not None) \
        else cfg.attention_kind
    # Self-attention needs a block plan only in the sparse SLA modes.
    plan_needed = kind == "sla" and sla_cfg.mode not in ("full",
                                                         "linear_only")
    adaptive = (drift_threshold is not None and plans is not None
                and plan_needed)
    if plans is not None and plan_needed:
        plan_lib.check_stack(plans, cfg.num_layers, b, h,
                             seq // sla_cfg.block_q, seq // sla_cfg.block_kv)
    if adaptive:
        thr_shape = ((cfg.num_layers, batch) if per_sample_refresh
                     else (cfg.num_layers,))
        thresholds = torch.broadcast_to(
            torch.as_tensor(drift_threshold, dtype=torch.float32,
                            device=dev), thr_shape)
        if per_sample_refresh:  # this rank's rows
            thresholds = ctx.batch_rows(thresholds.T).T

    def layer(x, p, given, thr, kept):
        """One DiT block. Planning (or the drift-gated refresh of a given
        plan) runs on the first call only and is kept in `kept`, so a
        rematerializing recompute attends over the same blocks. Under
        context parallelism q, k and v are gathered to the whole sequence
        (planning ranks every query row); this rank keeps its rows."""
        mod = temb @ ctx.fsdp_gather(p.ada, "rep").to(temb.dtype)
        sh1, sc1, g1, sh2, sc2, g2 = mod.chunk(6, dim=-1)
        xn = rms_norm(x, ctx.fsdp_gather(p.ln1, "rep")) \
            * (1 + sc1[:, None]) + sh1[:, None]
        xn = ctx.to_tp(xn)
        q = (xn @ ctx.fsdp_gather(p.wq, "col").to(x.dtype)) \
            .reshape(b, n, h, dh).transpose(1, 2)
        k = kv_heads((xn @ ctx.fsdp_gather(p.wk, kvk).to(x.dtype))
                     .reshape(b, n, hk, dh).transpose(1, 2))
        v = kv_heads((xn @ ctx.fsdp_gather(p.wv, kvk).to(x.dtype))
                     .reshape(b, n, hk, dh).transpose(1, 2))
        q, k, v = (ctx.gather_seq(t, 2) for t in (q, k, v))
        routing = ({name: ctx.fsdp_gather(w, "row")
                    for name, w in p.routing.items()}
                   if sla_cfg.routing_mode == "learned" else None)
        if "plan" not in kept:
            # Tensors the planning ops save for the backward (the learned
            # router's straight-through gates) stay out of the remat
            # checkpoint, whose recompute does not plan again.
            with torch.autograd.graph.saved_tensors_hooks(
                    lambda t: t.detach(), lambda t: t):
                kept["plan"] = plan_layer(q, k, routing, given, thr)
        layer_plan = kept["plan"][0]
        o = attention({"proj": ctx.fsdp_gather(p.sla_proj, "row")}, q, k,
                      v, kind, sla_cfg, causal=False, backend=backend,
                      plan=layer_plan if plan_needed else None,
                      routing=routing)
        o = ctx.seq_rows(o, dim=2).transpose(1, 2).reshape(b, n, h * dh)
        o = ctx.from_tp(o @ ctx.fsdp_gather(p.wo, "row").to(x.dtype))
        x = ctx.shard_residual(x + g1[:, None] * o)
        if cfg.cross_attn and cond is not None:
            cx = ctx.to_tp(cond.to(x.dtype))
            lc = cx.shape[1]
            xq = (ctx.to_tp(rms_norm(x, ctx.fsdp_gather(p.ln_x, "rep")))
                  @ ctx.fsdp_gather(p.xq, "col").to(x.dtype)) \
                .reshape(b, n, h, dh).transpose(1, 2)
            xk = kv_heads((cx @ ctx.fsdp_gather(p.xk, kvk).to(x.dtype))
                          .reshape(b, lc, hk, dh).transpose(1, 2))
            xv = kv_heads((cx @ ctx.fsdp_gather(p.xv, kvk).to(x.dtype))
                          .reshape(b, lc, hk, dh).transpose(1, 2))
            xo = attention(None, xq, xk, xv, "full", sla_cfg, causal=False)
            xo = xo.transpose(1, 2).reshape(b, n, h * dh)
            x = x + ctx.from_tp(xo @ ctx.fsdp_gather(p.xo, "row")
                                .to(x.dtype))
        xn2 = rms_norm(x, ctx.fsdp_gather(p.ln2, "rep")) \
            * (1 + sc2[:, None]) + sh2[:, None]
        g, u = (ctx.to_tp(xn2) @ ctx.fsdp_gather(p.mlp_wi, "col", chunks=2)
                .to(x.dtype)).chunk(2, dim=-1)
        f = ctx.from_tp((F.silu(g) * u)
                        @ ctx.fsdp_gather(p.mlp_wo, "row").to(x.dtype))
        return ctx.shard_residual(x + g2[:, None] * f)

    def plan_layer(q, k, routing, layer_plan, thr):
        """(plan, retention, replanned) for one layer."""
        if adaptive and per_sample_refresh:
            retention = torch.ones((b,), dtype=torch.float32, device=dev)
            replanned = torch.zeros((b,), dtype=torch.bool, device=dev)
        else:
            retention = torch.ones((), dtype=torch.float32, device=dev)
            replanned = torch.zeros((), dtype=torch.bool, device=dev)
        if plan_needed and layer_plan is None:
            layer_plan = plan_lib.plan_attention(q, k, sla_cfg,
                                                 routing=routing)
        elif adaptive:
            refresh = (plan_lib.refresh_plan_per_sample
                       if per_sample_refresh else plan_lib.refresh_plan)
            layer_plan, retention, replanned = refresh(
                layer_plan, q, k, sla_cfg, thr, routing=routing)
        return layer_plan, retention, replanned

    out_plans, rets, reps = [], [], []
    for li, p in enumerate(params.layers):
        given = (None if plans is None
                 else plan_lib.plan_map(lambda leaf: leaf[li], plans))
        kept = {}
        x = ctx.maybe_remat(functools.partial(
            layer, p=p, given=given, thr=thresholds[li] if adaptive
            else None, kept=kept))(x)
        layer_plan, retention, replanned = kept["plan"]
        if return_plans and plan_needed:
            out_plans.append(layer_plan)
        if adaptive:
            rets.append(retention)
            reps.append(replanned)
    x = rms_norm(x, ctx.fsdp_gather(params.ln_f, "rep"))
    out = x @ ctx.fsdp_gather(params.patch_out, "rep").to(x.dtype)
    result = (out,)
    if return_plans:
        result += (plan_lib.plan_map(lambda *ls: torch.stack(ls), *out_plans)
                   if out_plans else None,)
    if adaptive:
        result += ({"retention": torch.stack(rets),
                    "replanned": torch.stack(reps)},)
    return result if len(result) > 1 else out


@torch.no_grad()
def sample(params: DiT, cfg: ArchConfig, noise: torch.Tensor, *,
           num_steps: int = 8, cond: Optional[torch.Tensor] = None,
           compute_dtype=torch.bfloat16, backend: str = "gather",
           refresh_interval: Optional[int] = None,
           refresh_mode: Optional[str] = None, drift_threshold=None,
           t_start=None, return_trace: bool = False):
    """Euler rectified-flow sampler with cross-timestep plan reuse.

    Integrates dx/dt = v(x, t) from t = 1 (or a per-sample `t_start`) down
    to 0 over `num_steps` uniform steps. Plan refresh ("fixed": re-plan
    every `refresh_interval` steps; "adaptive": re-plan a layer when its
    drift reaches `drift_threshold`) as in the reference. With
    `return_trace=True` also returns {"retention": (S-1, L), "replanned":
    (S-1, L), "replan_count": (L,)}; counts exclude step 0's planning.

    Under `activation_sharding(mesh, ...)` every rank holds the global
    latents and advances them alike: each step's velocity of this rank's
    rows is gathered over the data ranks (`ctx.gather_tokens`) before the
    Euler step, and each rank reuses its own part of the plans. The trace
    holds the global decisions, the one-device run's.
    """
    mode = (cfg.sla.plan_refresh_mode if refresh_mode is None
            else refresh_mode)
    if mode not in ("fixed", "adaptive"):
        raise ValueError(f"unknown plan_refresh_mode {mode!r}; "
                         "expected 'fixed' or 'adaptive'")
    dev = noise.device
    b = noise.shape[0]
    x = noise
    nl = cfg.num_layers
    f32 = dict(dtype=torch.float32, device=dev)

    if t_start is None:
        dt = torch.tensor(1.0 / num_steps, **f32)

        def tvec(step):
            return (torch.full((b,), 1.0, **f32)
                    - torch.tensor(float(step), **f32) * dt)

        def euler(x, vel):
            return x - dt * vel.to(x.dtype)
    else:
        # t(step) = t0 - step * (t0 / num_steps), computed positionally so
        # the serving scheduler's host-side f32 bookkeeping matches it
        t0 = torch.broadcast_to(torch.as_tensor(t_start, **f32), (b,))
        dtv = t0 / torch.tensor(float(num_steps), **f32)

        def tvec(step):
            return t0 - torch.tensor(float(step), **f32) * dtv

        def euler(x, vel):
            return x - dtv[:, None, None] * vel.to(x.dtype)

    def fwd(step, **kw):
        """The forward at `step`, its velocity of the global batch."""
        out = forward(params, cfg, x, tvec(step), cond, compute_dtype,
                      backend, **kw)
        if isinstance(out, tuple):
            return (ctx.gather_tokens(out[0]),) + out[1:]
        return ctx.gather_tokens(out)

    def static_trace(flags):
        rep = torch.tensor(flags, dtype=torch.bool, device=dev)[:, None] \
            .repeat(1, nl).reshape(num_steps - 1, nl)
        return {"retention": torch.ones((num_steps - 1, nl), **f32),
                "replanned": rep, "replan_count": rep.sum(dim=0)}

    if mode == "fixed":
        k_refresh = max(1, int(cfg.sla.plan_refresh_interval
                               if refresh_interval is None
                               else refresh_interval))
        vel, plans = fwd(0, return_plans=True)
        x = euler(x, vel)
        for step in range(1, num_steps):
            if step % k_refresh == 0:
                vel, plans = fwd(step, return_plans=True)
            else:
                vel = fwd(step, plans=plans)
            x = euler(x, vel)
        if return_trace:
            return x, static_trace([s % k_refresh == 0
                                    for s in range(1, num_steps)])
        return x

    thr = (cfg.sla.plan_drift_threshold if drift_threshold is None
           else drift_threshold)
    plan_needed = (cfg.attention_kind == "sla"
                   and cfg.sla.mode not in ("full", "linear_only"))
    if not plan_needed:
        for step in range(num_steps):
            x = euler(x, fwd(step))
        if return_trace:
            return x, static_trace([False] * (num_steps - 1))
        return x

    vel, plans = fwd(0, return_plans=True)
    x = euler(x, vel)
    rets, reps = [], []
    for step in range(1, num_steps):
        vel, plans, info = fwd(step, plans=plans, return_plans=True,
                               drift_threshold=thr)
        x = euler(x, vel)
        rets.append(info["retention"])
        reps.append(info["replanned"])
    if return_trace:
        rep = (torch.stack(reps) if reps
               else torch.zeros((0, nl), dtype=torch.bool, device=dev))
        ret = torch.stack(rets) if rets else torch.ones((0, nl), **f32)
        return x, {"retention": ret, "replanned": rep,
                   "replan_count": rep.sum(dim=0)}
    return x


# ---------------------------------------------------------------------------
# serving slot surgery (serving/diffusion.py). Unlike the reference's
# functional updates these write into the live pool in place, which saves
# a copy of every per-layer plan leaf per admission. Under a mesh they act
# on this rank's part of the plan pool, in the scope of the pool's layout
# (the tick's: `activation_sharding(mesh, default_residual_spec(mesh,
# slots, seq_len))`): under data parallelism slot j's rows live on one
# data rank; its heads' rows are the rank's own.
# ---------------------------------------------------------------------------
def _slot_rows(plans, slot: int):
    """(whether this rank holds slot `slot`'s plan rows, their index in
    its part of the pool)."""
    lay = ctx.layout()
    if lay is None or lay.dp == 1:
        return True, slot
    n = plans.mc.shape[1]
    return slot // n == lay.data_rank, slot % n


def insert_denoise_slot(latents, plans, slot: int, latent_row, plan_row):
    """Write one admitted request into batch slot `slot`, in place.

    latents: (B, N, P) live pool; latent_row: (1, N, P). plans: per-layer
    plan stack with leaves (L, B, ...); plan_row: leaves (L, 1, ...).
    Either plan argument may be None. Returns (latents, plans). Under a
    mesh the latents are the global pool on every rank and the plans this
    rank's part; plan_row holds the request's rows of this rank's heads
    (a batch-1 admission runs under context parallelism, where every
    data rank holds them), which the slot's owner copies in."""
    latents[slot] = latent_row[0].to(latents.dtype)
    if plans is not None and plan_row is not None:
        mine, row = _slot_rows(plans, slot)
        if mine:
            for name in plan_lib.PLAN_LEAVES:
                full = getattr(plans, name)
                full[:, row] = getattr(plan_row, name)[:, 0].to(full.dtype)
    return latents, plans


def retire_denoise_slot(latents, slot: int):
    """Read a finished request's final latent (N, P) out of the pool."""
    return latents[slot]


def take_slot_plans(plans, slot: int):
    """One slot's per-layer plan rows (leaves (L, 1, ...)). Under data
    parallelism the owner's rows of this rank's heads, gathered to every
    data rank (every rank of the pool's layout calls it)."""
    lay = ctx.layout()
    if lay is None or lay.dp == 1:
        return plan_lib.plan_map(lambda leaf: leaf[:, slot:slot + 1],
                                 plans)
    return plan_lib.plan_map(lambda leaf: serving.read_row(
        leaf, 1, slot, "data", lay.mesh).unsqueeze(1), plans)


def loss_fn(params: DiT, cfg: ArchConfig, batch, compute_dtype=torch.bfloat16,
            backend: str = "gather", sla_mode: Optional[str] = None
            ) -> torch.Tensor:
    """Flow-matching (rectified flow): x_t = (1-t) x0 + t noise; the model
    predicts the velocity (noise - x0). batch: latents (B, N, P), noise,
    t (B,), cond (optional) tensors; under a mesh the global batch, of
    which `forward` keeps this rank's rows, and the loss the global
    mean."""
    x0, noise, t = batch["latents"], batch["noise"], batch["t"]
    xt = (1.0 - t[:, None, None]) * x0 + t[:, None, None] * noise
    pred = forward(params, cfg, xt, t, batch.get("cond"), compute_dtype,
                   backend, sla_mode)
    return mse_loss(pred, ctx.seq_rows(ctx.batch_rows(noise - x0)))


def distill_loss_fn(params: DiT, cfg: ArchConfig, batch,
                    compute_dtype=torch.bfloat16, backend: str = "gather"
                    ) -> torch.Tensor:
    """End-to-end distillation (paper Sec. 5): MSE between the SLA
    student's velocity and an exact-attention teacher running the same
    params on the same noised latents. The teacher runs under
    `torch.no_grad()` (the reference's stop_gradient). Routing parameters
    get their straight-through gradients only on the autodiff backends
    ("gather", "reference"): the kernel backend treats the plan as a
    constant."""
    x0, noise, t = batch["latents"], batch["noise"], batch["t"]
    xt = (1.0 - t[:, None, None]) * x0 + t[:, None, None] * noise
    with torch.no_grad():
        teacher = forward(params, cfg, xt, t, batch.get("cond"),
                          compute_dtype, backend, sla_mode="full")
    student = forward(params, cfg, xt, t, batch.get("cond"), compute_dtype,
                      backend)
    return mse_loss(student, teacher)
