"""Dense reference (oracle) for SLA — exact Algorithm 1 semantics.

Validates the kernel and the gather backend at small sizes; never on the
main path on the card (it materializes the N x N score matrix). All
accumulation in f32. Counterpart of `repro.core.reference`.

Shapes: q, k, v: (B, H, N, D); qp = phi(q), kp = phi(k) same shape (f32).
mc: (B, H, Tm, Tn) int8 in {-1, 0, +1}.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.config import SLAConfig
from repro_torch.core.masks import NEG_INF, expand_mask

EPS = 1e-6


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num/den with 0 where den <= EPS (the untaken branch stays finite)."""
    live = den > EPS
    safe = torch.where(live, den, torch.ones_like(den))
    return torch.where(live, num / safe, torch.zeros_like(num))


def sparse_component(q, k, v, mc, cfg: SLAConfig,
                     scale: Optional[float] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """O^s: softmax attention restricted to critical blocks.
    Returns (o_s (B,H,N,D) f32, lse (B,H,N) f32)."""
    d = q.shape[-1]
    scale = (d**-0.5) if scale is None else scale
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    keep = expand_mask(mc == 1, cfg.block_q, cfg.block_kv)
    if cfg.causal:
        n, m = s.shape[-2], s.shape[-1]
        keep = keep & torch.ones((n, m), dtype=torch.bool,
                                 device=s.device).tril()
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o_s = torch.matmul(p / l, v.float())
    return o_s, (m + torch.log(l))[..., 0]


def linear_component(qp, kp, v, mc, cfg: SLAConfig,
                     a: Optional[torch.Tensor] = None):
    """O^l: per-row-aggregated linear attention over marginal blocks (Eq. 5).

    Returns (o_l (B,H,N,D) f32, H (B,H,Tm,D,D) f32, Z (B,H,Tm,D) f32).
    `a` overrides the aggregation matrix (a plan's `marginal` leaf)."""
    bq, bkv = cfg.block_q, cfg.block_kv
    n, d = v.shape[-2], v.shape[-1]
    tn = n // bkv
    kpb = kp.float().reshape(*kp.shape[:-2], tn, bkv, d)
    vb = v.float().reshape(*v.shape[:-2], tn, bkv, d)
    h = torch.matmul(kpb.transpose(-1, -2), vb)  # (..., Tn, D, D)
    z = kpb.sum(dim=-2)
    if a is None:
        a = (mc == 0).float()
    hi = torch.einsum("...mn,...nde->...mde", a, h)
    zi = torch.einsum("...mn,...nd->...md", a, z)
    tm = hi.shape[-3]
    qpb = qp.float().reshape(*qp.shape[:-2], tm, bq, d)
    num = torch.matmul(qpb, hi)
    den = torch.matmul(qpb, zi[..., None])
    o_l = _safe_div(num, den).reshape(*qp.shape[:-2], n, d)
    return o_l, hi, zi


def full_linear(qp, kp, v) -> torch.Tensor:
    """Standard O(N d^2) linear attention over ALL tokens (baselines)."""
    kp32, v32, qp32 = kp.float(), v.float(), qp.float()
    h = torch.matmul(kp32.transpose(-1, -2), v32)
    z = kp32.sum(dim=-2)
    num = torch.matmul(qp32, h)
    den = torch.matmul(qp32, z[..., None])
    return _safe_div(num, den)


def full_attention(q, k, v, causal: bool,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact softmax attention (f32), the quality reference."""
    d = q.shape[-1]
    scale = (d**-0.5) if scale is None else scale
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        n, m = s.shape[-2], s.shape[-1]
        tri = torch.ones((n, m), dtype=torch.bool, device=s.device).tril()
        s = torch.where(tri, s, torch.full_like(s, NEG_INF))
    return torch.matmul(torch.softmax(s, dim=-1), v.float())


def sla_forward_reference(q, k, v, qp, kp, mc, cfg: SLAConfig,
                          scale: Optional[float] = None,
                          marginal: Optional[torch.Tensor] = None):
    """Reference forward: returns (O^s, O^l), both (B, H, N, D) f32.
    The caller combines them as O = O^s + Proj(O^l) (Eq. 6)."""
    o_s, _ = sparse_component(q, k, v, mc, cfg, scale)
    o_l, _, _ = linear_component(qp, kp, v, mc, cfg, a=marginal)
    return o_s, o_l
