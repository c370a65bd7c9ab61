"""SLA attention op around the fused CUDA forward kernel (Alg. 1).

`sla_attention_core(q, k, v, qp, kp, plan, cfg)` returns (O^s, O^l); the
caller applies Proj and the sum (Eq. 6). Counterpart of
`repro.kernels.ops`, forward half.

Division of labor:
  * sparse fwd + linear merge ........ CUDA kernel (kernels/sla_fwd.py)
  * per-block h_j, z_j + marginal agg  torch matmuls (the reference leaves
    them to XLA einsums: the paper's App. A.3 pre-aggregation in its
    dense-matmul form)

This slice is forward-only: `sla_attention_core` refuses inputs that
require grad. The `torch.autograd.Function` with the dQ / dK,dV kernels
arrives with the training slice (ROADMAP.md queue 1, item 11).
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.core.config import SLAConfig
from repro_torch.core.plan import SLAPlan, plan_from_mask
from repro_torch.kernels.sla_fwd import sla_fwd


def _flat(x: torch.Tensor) -> torch.Tensor:
    """(B, H, ...) -> (B*H, ...), contiguous."""
    b, h = x.shape[:2]
    return x.reshape(b * h, *x.shape[2:]).contiguous()


def _block(x: torch.Tensor, blk: int) -> torch.Tensor:
    """(BH, N, D) -> (BH, T, blk, D)."""
    bh, n, d = x.shape
    return x.reshape(bh, n // blk, blk, d)


def _hz_blocks(kp: torch.Tensor, v: torch.Tensor, block_kv: int):
    """Per-KV-block linear-attention state: h_j = phi(K_j)^T V_j, z_j."""
    kpb = _block(kp.float(), block_kv)
    vb = _block(v.float(), block_kv)
    return torch.matmul(kpb.transpose(-1, -2), vb), kpb.sum(dim=-2)


def _aggregate(a: torch.Tensor, h: torch.Tensor, z: torch.Tensor):
    """H_i = sum_{j marginal} h_j, Z_i likewise (dense-matmul form)."""
    g, tn, d, _ = h.shape
    hi = torch.matmul(a, h.reshape(g, tn, d * d)).reshape(g, -1, d, d)
    return hi, torch.matmul(a, z)


def _fwd_impl(q, k, v, qp, kp, marginal, lut, counts, cfg: SLAConfig,
              scale: float):
    fq, fk, fv, fqp, fkp = map(_flat, (q, k, v, qp, kp))
    a, flut, fcounts = map(_flat, (marginal, lut, counts))
    hb, zb = _hz_blocks(fkp, fv, cfg.block_kv)
    hi, zi = _aggregate(a, hb, zb)
    o_s, o_l, lse = sla_fwd(flut, fcounts, fq, fk, fv, fqp, hi, zi,
                            scale=scale, causal=cfg.causal,
                            block_q=cfg.block_q, block_kv=cfg.block_kv)
    return o_s, o_l, lse, a, hi, zi, flut, fcounts


def sla_attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       qp: torch.Tensor, kp: torch.Tensor,
                       plan: Union[SLAPlan, torch.Tensor], cfg: SLAConfig,
                       scale: Optional[float] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused-kernel SLA core. q, k, v, qp, kp: (B, H, N, D); `plan` is an
    SLAPlan (or a raw (B, H, Tm, Tn) int8 M_c, from which a plan is
    derived). Returns (O^s, O^l) f32, (B, H, N, D)."""
    if not isinstance(plan, SLAPlan):
        plan = plan_from_mask(plan, cfg)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, qp, kp, plan.marginal)):
        raise RuntimeError(
            "the kernel backend is forward-only in this version: an input "
            "requires grad. Run under torch.no_grad(), or use the 'gather' "
            "or 'reference' backend for gradients (the backward kernels "
            "arrive with the training slice, ROADMAP.md queue 1, item 11)")
    scale = float(q.shape[-1] ** -0.5) if scale is None else float(scale)
    o_s, o_l = _fwd_impl(q, k, v, qp, kp, plan.marginal, plan.lut,
                         plan.counts, cfg, scale)[:2]
    return o_s.reshape(q.shape), o_l.reshape(q.shape)
