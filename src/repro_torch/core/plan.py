"""SLA planning subsystem: classify once, execute many times.

`plan_attention(q, k, cfg)` returns an `SLAPlan` carrying every derived
structure a backend (reference / gather / CUDA kernel) needs, so a plan
computed at one diffusion timestep can be reused for the next steps and
refreshed only when its drift says so.

Counterpart of `repro.core.plan`. This is the only place LUTs are built;
`core/masks.py` keeps the classification math and `core/backends.py` the
execution. `plan_extend` and plan serialization arrive with later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from repro_torch.core.config import SLAConfig
from repro_torch.core.masks import (classify_blocks, routing_gates,
                                    score_map, sparsity_stats)

EPS = 1e-12
PLAN_LEAVES = ("mc", "lut", "counts", "col_lut", "col_counts", "marginal")


@dataclasses.dataclass(frozen=True)
class SLAPlan:
    """Immutable result of SLA block planning.

    Shapes (B = batch, H = q heads, Tm/Tn = q/kv block counts):
      mc:         (B, H, Tm, Tn) int8   three-way classification (Eq. 3)
      lut:        (B, H, Tm, K)  int32  critical block ids per query row
      counts:     (B, H, Tm)     int32  live entries per row LUT
      col_lut:    (B, H, Tn, W)  int32  critical row ids per KV column
      col_counts: (B, H, Tn)     int32  live entries per column LUT
      marginal:   (B, H, Tm, Tn) f32    aggregation matrix A (1 where a
                                        block is marginal)

    A per-layer stack of plans (what `models.dit.forward` returns) has one
    more leading axis on every leaf; `plan_map` slices and stacks them.
    """

    mc: torch.Tensor
    lut: torch.Tensor
    counts: torch.Tensor
    col_lut: torch.Tensor
    col_counts: torch.Tensor
    marginal: torch.Tensor

    @property
    def k_sel(self) -> int:
        return self.lut.shape[-1]

    @property
    def w_col(self) -> int:
        return self.col_lut.shape[-1]

    @property
    def num_q_blocks(self) -> int:
        return self.mc.shape[-2]

    @property
    def num_kv_blocks(self) -> int:
        return self.mc.shape[-1]

    def stats(self) -> dict:
        """Sparsity statistics (fractions of each block class)."""
        return sparsity_stats(self.mc)


def plan_map(fn: Callable, *plans: SLAPlan) -> SLAPlan:
    """Apply `fn` leaf by leaf across plans (the port's tree_map)."""
    return SLAPlan(**{name: fn(*(getattr(p, name) for p in plans))
                      for name in PLAN_LEAVES})


def build_lut(mc: torch.Tensor, k_sel: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static-shape critical-block lookup table.

    Returns lut (..., Tm, k_sel) int32 — critical block indices,
    ascending, padded with the row's first critical index — and counts
    (..., Tm) int32, the number of live entries per row.
    """
    tn = mc.shape[-1]
    is_crit = (mc == 1).to(torch.int32)
    counts = is_crit.sum(dim=-1, dtype=torch.int32)
    j = torch.arange(tn, dtype=torch.int32, device=mc.device)
    key = is_crit * (2 * tn) - j  # critical blocks first, ascending j
    idx = torch.argsort(-key, dim=-1, stable=True)[..., :k_sel]
    idx = idx.to(torch.int32)
    slot = torch.arange(k_sel, dtype=torch.int32, device=mc.device)
    live = slot < counts[..., None]
    pad = idx[..., :1]  # first critical index — always a real block
    return torch.where(live, idx, pad), counts


def build_col_lut(mc: torch.Tensor, w_col: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Column LUT (dK/dV kernel): per KV column, the critical row ids.
    Returns (col_lut (..., Tn, w_col) int32, col_counts (..., Tn) int32)."""
    tm = mc.shape[-2]
    is_crit = (mc == 1).to(torch.int32)
    counts = is_crit.sum(dim=-2, dtype=torch.int32)
    i = torch.arange(tm, dtype=torch.int32, device=mc.device)[:, None]
    key = is_crit * (2 * tm) - i
    idx = torch.argsort(-key, dim=-2, stable=True)[..., :w_col, :]
    idx = idx.to(torch.int32).transpose(-1, -2)  # (..., Tn, w_col)
    slot = torch.arange(w_col, dtype=torch.int32, device=mc.device)
    live = slot < counts[..., None]
    pad = idx[..., :1]
    return torch.where(live, idx, pad).contiguous(), counts


def plan_from_mask(mc: torch.Tensor, cfg: SLAConfig,
                   col_width: Optional[int] = None,
                   pc: Optional[torch.Tensor] = None) -> SLAPlan:
    """Derive every execution structure from a classification M_c.

    `col_width` overrides the column-LUT width (cfg.col_capacity). `pc`
    (learned routing only): the score map `mc` came from, so the marginal
    matrix carries the straight-through gates."""
    tm, tn = mc.shape[-2], mc.shape[-1]
    lut, counts = build_lut(mc, cfg.num_critical(tn))
    col_lut, col_counts = build_col_lut(
        mc, cfg.col_capacity(tm, tn) if col_width is None else col_width)
    if pc is not None and cfg.routing_mode == "learned":
        marginal = routing_gates(pc, mc, cfg)
    else:
        marginal = (mc == 0).float()
    return SLAPlan(mc=mc, lut=lut, counts=counts, col_lut=col_lut,
                   col_counts=col_counts, marginal=marginal)


def repeat_kv(x: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    """GQA: broadcast KV heads to match Q heads (the layout of
    `jnp.repeat`). (B, Hkv, N, D) -> (B, H, N, D)."""
    hkv = x.shape[1]
    if hkv == num_q_heads:
        return x
    if num_q_heads % hkv:
        raise ValueError(f"{num_q_heads} q heads are not a multiple of "
                         f"{hkv} kv heads")
    return torch.repeat_interleave(x, num_q_heads // hkv, dim=1)


def plan_attention(q: torch.Tensor, k: torch.Tensor, cfg: SLAConfig,
                   scale: Optional[float] = None,
                   routing: Optional[dict] = None) -> SLAPlan:
    """Build an SLAPlan from (q, k): score map -> M_c -> LUTs -> A.

    q: (B, H, N, D); k: (B, Hkv, N, D) with Hkv | H (GQA heads are
    broadcast so the plan has one row of structure per q head). (q, k)
    are gradient-stopped: the block structure is a constant.
    """
    cfg.validate()
    k = repeat_kv(k, q.shape[1])
    pc = score_map(routing, q.detach(), k.detach(), cfg, scale)
    return plan_from_mask(classify_blocks(pc, cfg), cfg, pc=pc)


def empty_plan(cfg: SLAConfig, batch: int, heads: int, tm: int, tn: int,
               device=None) -> SLAPlan:
    """All-negligible plan over a static (tm, tn) block grid — the
    placeholder a serving slot holds before its first request."""
    mc = torch.full((batch, heads, tm, tn), -1, dtype=torch.int8,
                    device=device)
    return plan_from_mask(mc, cfg)


# ---------------------------------------------------------------------------
# plan lifetime: drift measurement + refresh
# ---------------------------------------------------------------------------
def plan_retention(plan: SLAPlan, q: torch.Tensor, k: torch.Tensor,
                   cfg: SLAConfig, scale: Optional[float] = None,
                   routing: Optional[dict] = None) -> torch.Tensor:
    """Critical-mass retention of a (possibly stale) plan at (q, k):

        r = sum(P_c * [mc_stale == +1]) / sum(P_c * [mc_fresh == +1])

    clipped to [0, 1]; (B, H) float32."""
    return _retention_and_fresh_mc(plan, q, k, cfg, scale, routing)[0]


def _retention_and_fresh_mc(plan, q, k, cfg, scale=None, routing=None):
    """Retention (B, H), the fresh classification it was measured
    against, and (learned routing only) the score map itself."""
    k = repeat_kv(k, q.shape[1])
    learned = cfg.routing_mode == "learned"
    pc = score_map(routing, q.detach(), k.detach(), cfg, scale)
    if pc.shape[-2:] != plan.mc.shape[-2:]:
        raise ValueError(
            f"stale SLAPlan: plan is for {tuple(plan.mc.shape[-2:])} "
            f"blocks but (q, k) pool to {tuple(pc.shape[-2:])} — shapes "
            f"must match to measure drift")
    stale = (pc * (plan.mc == 1)).sum(dim=(-2, -1))
    mc_fresh = classify_blocks(pc, cfg)
    fresh = (pc * (mc_fresh == 1)).sum(dim=(-2, -1))
    r = stale / torch.clamp(fresh, min=EPS)
    return r.clamp(0.0, 1.0), mc_fresh, (pc if learned else None)


def plan_drift(plan: SLAPlan, q: torch.Tensor, k: torch.Tensor,
               cfg: SLAConfig, scale: Optional[float] = None,
               routing: Optional[dict] = None) -> torch.Tensor:
    """Plan drift `1 - plan_retention(...)` in [0, 1], shape (B, H)."""
    return 1.0 - plan_retention(plan, q, k, cfg, scale, routing)


def refresh_plan(plan: SLAPlan, q: torch.Tensor, k: torch.Tensor,
                 cfg: SLAConfig, threshold, scale: Optional[float] = None,
                 routing: Optional[dict] = None
                 ) -> Tuple[SLAPlan, torch.Tensor, torch.Tensor]:
    """Drift-gated re-plan: keep `plan` while it retains critical mass.

    Drift is max-reduced over batch and heads; the plan is rebuilt when
    drift >= threshold (0.0 re-plans every call, >= 1.0 never). The
    decision is read on the host, where JAX branches under `lax.cond`.
    Returns (plan', retention scalar f32, replanned bool tensor).
    """
    r, mc_fresh, pc = _retention_and_fresh_mc(plan, q, k, cfg, scale,
                                              routing)
    retention = r.min()
    thr = torch.as_tensor(threshold, dtype=torch.float32,
                          device=retention.device)
    replanned = ((1.0 - retention) >= thr) & (thr < 1.0)
    if bool(replanned):
        plan = plan_from_mask(mc_fresh, cfg, pc=pc)
    return plan, retention, replanned


def refresh_plan_per_sample(plan: SLAPlan, q: torch.Tensor, k: torch.Tensor,
                            cfg: SLAConfig, thresholds,
                            scale: Optional[float] = None,
                            routing: Optional[dict] = None
                            ) -> Tuple[SLAPlan, torch.Tensor, torch.Tensor]:
    """Per-sample drift-gated re-plan: each batch row decides alone.

    Retention is reduced over heads only, giving a (B,) decision;
    replanned rows take the freshly classified structure, kept rows keep
    their old leaves unchanged. `thresholds`: (B,) (or a scalar) — 0.0
    forces a row's re-plan, >= 1.0 pins reuse. The rebuild always runs.

    Returns (plan', retention (B,), replanned (B,) bool).
    """
    r, mc_fresh, pc = _retention_and_fresh_mc(plan, q, k, cfg, scale,
                                              routing)
    retention = r.min(dim=-1).values
    thr = torch.as_tensor(thresholds, dtype=torch.float32,
                          device=retention.device)
    thr = torch.broadcast_to(thr, retention.shape)
    replanned = ((1.0 - retention) >= thr) & (thr < 1.0)
    fresh = plan_from_mask(mc_fresh, cfg, pc=pc)

    def sel(new_leaf, old_leaf):
        m = replanned.reshape(replanned.shape
                              + (1,) * (new_leaf.ndim - replanned.ndim))
        return torch.where(m, new_leaf, old_leaf)

    return plan_map(sel, fresh, plan), retention, replanned
