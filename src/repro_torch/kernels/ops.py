"""SLA attention op around the CUDA kernels (Alg. 1 + Alg. 2).

`sla_attention_core(q, k, v, qp, kp, plan, cfg)` returns (O^s, O^l); the
caller applies Proj and the sum (Eq. 6). `sla_attention_rows` is its
forward-only form over a span of query-row blocks (chunked prefill). Differentiable with respect to
q, k, v, qp and kp through a `torch.autograd.Function`; the plan is a
constant, as in the paper (TopK is not differentiated), so `marginal`
gets a zero gradient. Counterpart of `repro.kernels.ops` (`_sla_core`
and its custom_vjp).

The plan's row LUT feeds the forward and dQ kernels, its column LUT the
dK/dV kernel; both ride the Function's saved tensors, so the backward
consumes the forward's plan verbatim.

Division of labor:
  * sparse fwd + linear merge ........ CUDA kernel (kernels/sla_fwd.py)
  * sparse bwd dQ / dK,dV ............ CUDA kernels (kernels/sla_bwd.py)
  * per-block h_j, z_j + marginal agg  torch matmuls (the reference leaves
    them to XLA einsums: the paper's App. A.3 pre-aggregation in its
    dense-matmul form)
  * linear-branch gradients .......... torch matmuls (Alg. 2 lines 4-5, 17)
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch.autograd.function import once_differentiable

from repro_torch.core.config import SLAConfig
from repro_torch.core.plan import SLAPlan, plan_from_mask
from repro_torch.kernels.sla_bwd import sla_bwd_dkv, sla_bwd_dq
from repro_torch.kernels.sla_fwd import EPS, sla_fwd


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


def _linear_bwd(do_l, qp, hi, zi, a, kp, v, block_q, block_kv):
    """Linear-branch gradients (Alg. 2 lines 2, 4-5, 14, 17): flat
    (BH, N, D) dO^l, phi(Q), phi(K), V and the forward's H_i, Z_i, A ->
    (dqp, dkp, dv_l), each (BH, N, D) f32."""
    qpb = _block(qp.float(), block_q)  # (g, Tm, bq, d)
    num = torch.matmul(qpb, hi)
    den = torch.matmul(qpb, zi[..., None])  # (g, Tm, bq, 1)
    live = den > EPS
    sden = torch.where(live, den, torch.ones_like(den))
    o_l = torch.where(live, num / sden, torch.zeros_like(num))
    dob = _block(do_l.float(), block_q)
    dob = torch.where(live, dob, torch.zeros_like(dob))
    d_l = (dob * o_l).sum(dim=-1, keepdim=True)  # D^l (g, Tm, bq, 1)
    qp_over = torch.where(live, qpb / sden, torch.zeros_like(qpb))
    dhi = torch.matmul(qp_over.transpose(-1, -2), dob)  # (g, Tm, d, d)
    dzi = -torch.matmul(qp_over.transpose(-1, -2), d_l)[..., 0]
    dqp = torch.matmul(dob, hi.transpose(-1, -2)) - d_l * zi[..., None, :]
    dqp = torch.where(live, dqp / sden, torch.zeros_like(dqp))
    # Aggregate row gradients back to per-column dh_j, dz_j (A^T matmul).
    g, tm, d, _ = dhi.shape
    at = a.transpose(-1, -2)
    dh = torch.matmul(at, dhi.reshape(g, tm, d * d)).reshape(g, -1, d, d)
    dz = torch.matmul(at, dzi)
    vb = _block(v.float(), block_kv)
    kpb = _block(kp.float(), block_kv)
    dkp = torch.matmul(vb, dh.transpose(-1, -2)) + dz[..., None, :]
    dv_l = torch.matmul(kpb, dh)
    return (dqp.reshape(g, -1, d), dkp.reshape(g, -1, d),
            dv_l.reshape(g, -1, d))


class _SLACore(torch.autograd.Function):
    """(O^s, O^l) through the CUDA kernels, differentiable with respect to
    q, k, v, qp and kp. Saves the reference custom_vjp's residuals: the
    flattened inputs, O^s and L, A, H_i and Z_i, and the row and column
    LUTs with their counts."""

    @staticmethod
    def forward(ctx, q, k, v, qp, kp, marginal, lut, counts, col_lut,
                col_counts, cfg: SLAConfig, scale: float):
        fq, fk, fv, fqp, fkp = map(_flat, (q, k, v, qp, kp))
        a, flut, fcounts = map(_flat, (marginal, lut, counts))
        hb, zb = _hz_blocks(fkp, fv, cfg.block_kv)
        hi, zi = _aggregate(a, hb, zb)
        o_s, o_l, lse = sla_fwd(flut, fcounts, fq, fk, fv, fqp, hi, zi,
                                scale=scale, causal=cfg.causal,
                                block_q=cfg.block_q, block_kv=cfg.block_kv)
        ctx.save_for_backward(fq, fk, fv, fqp, fkp, o_s, lse, a, hi, zi,
                              flut, fcounts, _flat(col_lut),
                              _flat(col_counts))
        ctx.cfg, ctx.scale, ctx.shape = cfg, scale, q.shape
        ctx.dtypes = tuple(x.dtype for x in (q, k, v, qp, kp))
        ctx.set_materialize_grads(False)  # a None cotangent skips a branch
        return o_s.reshape(q.shape), o_l.reshape(q.shape)

    @staticmethod
    @once_differentiable
    def backward(ctx, do_s, do_l):
        (fq, fk, fv, fqp, fkp, o_s, lse, a, hi, zi, flut, fcounts,
         fcol_lut, fcol_counts) = ctx.saved_tensors
        cfg, scale = ctx.cfg, ctx.scale
        dq = dk = dv = dqp = dkp = None  # None: a zero gradient
        if do_s is not None:  # sparse component: the CUDA kernels
            fdo_s = _flat(do_s.float())
            d_s = (fdo_s * o_s).sum(dim=-1)  # D^s = rowsum(dO^s * O^s)
            kw = dict(scale=scale, causal=cfg.causal, block_q=cfg.block_q,
                      block_kv=cfg.block_kv)
            dq = sla_bwd_dq(flut, fcounts, fq, fk, fv, fdo_s, lse, d_s,
                            **kw)
            dk, dv = sla_bwd_dkv(fcol_lut, fcol_counts, fq, fk, fv, fdo_s,
                                 lse, d_s, **kw)
        if do_l is not None:  # linear component: torch matmuls
            dqp, dkp, dv_l = _linear_bwd(_flat(do_l), fqp, hi, zi, a, fkp,
                                         fv, cfg.block_q, cfg.block_kv)
            dv = dv_l if dv is None else dv + dv_l
        grads = tuple(None if g is None else g.reshape(ctx.shape).to(dt)
                      for g, dt in zip((dq, dk, dv, dqp, dkp), ctx.dtypes))
        # the plan is a constant: no routing gradient through the kernels
        d_marginal = None
        if ctx.needs_input_grad[5]:
            d_marginal = torch.zeros(ctx.shape[:2] + a.shape[1:],
                                     dtype=a.dtype, device=a.device)
        return grads + (d_marginal,) + (None,) * 6


def sla_attention_rows(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       qp: torch.Tensor, kp: torch.Tensor,
                       marginal: torch.Tensor, lut: torch.Tensor,
                       counts: torch.Tensor, cfg: SLAConfig,
                       scale: Optional[float] = None, row_offset: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward-only fused kernel over a span of query-row blocks: the
    chunked-prefill entry point. q/qp cover C = Cm * block_q query
    tokens whose first row block is the absolute block `row_offset`;
    k/v/kp cover the full (B, H, N, D) KV bucket; `marginal`
    (B, H, Cm, Tn), `lut` (B, H, Cm, K) and `counts` (B, H, Cm) are the
    span's rows of the full plan. The same steps as the differentiable
    forward (per-block h/z at full bucket width, the aggregation, then
    one kernel launch at base `row_offset`), without autograd: prefill
    chunks are inference-only. Returns (O^s, O^l) f32, q's shape."""
    scale = float(q.shape[-1] ** -0.5) if scale is None else float(scale)
    fq, fk, fv, fqp, fkp = map(_flat, (q, k, v, qp, kp))
    a, flut, fcounts = map(_flat, (marginal, lut, counts))
    hb, zb = _hz_blocks(fkp, fv, cfg.block_kv)
    hi, zi = _aggregate(a, hb, zb)
    del hb, zb
    o_s, o_l, _ = sla_fwd(flut, fcounts, fq, fk, fv, fqp, hi, zi,
                          scale=scale, causal=cfg.causal,
                          block_q=cfg.block_q, block_kv=cfg.block_kv,
                          base=int(row_offset))
    return o_s.reshape(q.shape), o_l.reshape(q.shape)


def sla_attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       qp: torch.Tensor, kp: torch.Tensor,
                       plan: Union[SLAPlan, torch.Tensor], cfg: SLAConfig,
                       scale: Optional[float] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused-kernel SLA core. q, k, v, qp, kp: (B, H, N, D); `plan` is an
    SLAPlan (or a raw (B, H, Tm, Tn) int8 M_c, from which a plan is
    derived). Returns (O^s, O^l) f32, (B, H, N, D), differentiable with
    respect to q, k, v, qp and kp."""
    if not isinstance(plan, SLAPlan):
        plan = plan_from_mask(plan, cfg)
    scale = float(q.shape[-1] ** -0.5) if scale is None else float(scale)
    return _SLACore.apply(q, k, v, qp, kp, plan.marginal, plan.lut,
                          plan.counts, plan.col_lut, plan.col_counts, cfg,
                          scale)
