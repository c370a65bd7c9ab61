"""Gather-based SLA in plain PyTorch (the `gather` backend).

Gathers only the critical KV blocks named by the row LUT, so its work is
the true sparse cost. It is the reference's default backend and the
independent full-width cross-check for the CUDA kernel on the card (the
dense oracle cannot hold the N x N scores at N = 32K).

Counterpart of `repro.core.block_sparse_xla` (the module keeps its JAX
name so each counterpart is easy to find). The query-row loop runs over
chunks of `chunk` row blocks, as the reference's `lax.scan` does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.config import SLAConfig
from repro_torch.core.plan import SLAPlan
from repro_torch.core.reference import _safe_div

NEG_INF = -1e30


def _gather_blocks(xb: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """xb: (B, H, Tn, bkv, D); idx: (B, H, C, K) -> (B, H, C, K, bkv, D)."""
    b, h = xb.shape[:2]
    c, ks = idx.shape[2], idx.shape[3]
    bi = torch.arange(b, device=xb.device)[:, None, None]
    hi = torch.arange(h, device=xb.device)[None, :, None]
    out = xb[bi, hi, idx.reshape(b, h, c * ks).long()]
    return out.reshape(b, h, c, ks, *xb.shape[3:])


def _row_chunk(qc, kg, vg, idxc, cntc, i0, scale, causal, block_q,
               block_kv):
    """Attend one chunk of query-row blocks to their gathered critical
    blocks. qc: (B, H, C, bq, D); kg, vg: (B, H, C, K, bkv, D); idxc:
    (B, H, C, K); cntc: (B, H, C); i0: (C,) absolute row-block ids.
    Returns (o (B, H, C, bq, D), lse (B, H, C, bq))."""
    s = torch.einsum("bhcqd,bhckvd->bhcqkv", qc.float(), kg.float()) * scale
    ks = kg.shape[3]
    slot = torch.arange(ks, device=s.device)
    live = slot[None, None, None, :] < cntc[..., None]  # (B, H, C, K)
    s = torch.where(live[:, :, :, None, :, None], s,
                    torch.full_like(s, NEG_INF))
    if causal:
        rows = (i0[:, None] * block_q
                + torch.arange(block_q, device=s.device)[None, :])
        cols = (idxc[..., None].long() * block_kv
                + torch.arange(block_kv, device=s.device))
        ok = rows[None, None, :, :, None, None] >= cols[:, :, :, None, :, :]
        s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    b, h, c, bq = s.shape[:4]
    sf = s.reshape(b, h, c, bq, ks * kg.shape[4])
    m = sf.amax(dim=-1, keepdim=True)
    p = torch.exp(sf - m)
    l = p.sum(dim=-1, keepdim=True)
    vgf = vg.reshape(b, h, c, ks * vg.shape[4], vg.shape[5]).float()
    o = torch.matmul(p / l, vgf)
    return o, (m + torch.log(l))[..., 0]


def sparse_component_gather(q, k, v, lut, counts, cfg: SLAConfig,
                            scale: Optional[float] = None, chunk: int = 8,
                            row_offset: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """O^s via LUT gather. q: (B, H, Nq, D); k, v: (B, H, N, D); lut:
    (B, H, Tm, K). `row_offset` shifts the absolute query-row-block ids
    the causal mask uses. Returns (o_s (B,H,Nq,D) f32, lse (B,H,Nq) f32)."""
    b, h, n, d = q.shape
    scale = (d**-0.5) if scale is None else scale
    bq, bkv = cfg.block_q, cfg.block_kv
    tm = n // bq
    chunk = min(chunk, tm)
    while tm % chunk:
        chunk -= 1
    kb = k.reshape(b, h, -1, bkv, d)
    vb = v.reshape(b, h, -1, bkv, d)
    qc = q.reshape(b, h, tm // chunk, chunk, bq, d)
    lutc = lut.reshape(b, h, tm // chunk, chunk, -1)
    cntc = counts.reshape(b, h, tm // chunk, chunk)
    i0s = (row_offset + torch.arange(tm, device=q.device)).reshape(
        tm // chunk, chunk)
    outs, lses = [], []
    for c in range(tm // chunk):
        idxc = lutc[:, :, c]
        o, lse = _row_chunk(qc[:, :, c], _gather_blocks(kb, idxc),
                            _gather_blocks(vb, idxc), idxc, cntc[:, :, c],
                            i0s[c], scale, cfg.causal, bq, bkv)
        outs.append(o)
        lses.append(lse)
    o = torch.stack(outs, dim=2).reshape(b, h, n, d)
    lse = torch.stack(lses, dim=2).reshape(b, h, n)
    return o, lse


def sla_forward_gather(q, k, v, qp, kp, plan: SLAPlan, cfg: SLAConfig,
                       scale: Optional[float] = None, chunk: int = 8,
                       row_offset: int = 0):
    """(O^s, O^l) with gather-based sparse part and matmul-aggregated
    linear part; the block structure comes from `plan`. (B, H, N, D)."""
    b, h, n, d = q.shape
    tn = plan.num_kv_blocks
    o_s, _ = sparse_component_gather(q, k, v, plan.lut, plan.counts, cfg,
                                     scale, chunk, row_offset)
    kpb = kp.float().reshape(b, h, tn, cfg.block_kv, d)
    vb = v.float().reshape(b, h, tn, cfg.block_kv, d)
    hb = torch.matmul(kpb.transpose(-1, -2), vb)  # (B, H, Tn, D, D)
    zb = kpb.sum(dim=-2)
    a = plan.marginal
    tm = plan.num_q_blocks
    hi = torch.matmul(a, hb.reshape(b, h, tn, d * d)).reshape(b, h, tm, d, d)
    zi = torch.matmul(a, zb)
    qpb = qp.float().reshape(b, h, tm, cfg.block_q, d)
    num = torch.matmul(qpb, hi)
    den = torch.matmul(qpb, zi[..., None])
    return o_s, _safe_div(num, den).reshape(b, h, n, d)
