"""Chunked decayed linear attention: the compute core of RWKV6 and Mamba2.

Counterpart of `repro.models.linear_scan`. Two execution forms, both O(N)
in sequence length:
  * `decayed_la_scan`    the per-token recurrence (oracle);
  * `decayed_la_chunked` the chunk-parallel form;
and `decayed_la_step`, one decode step.

Shapes: q, k, logw: (B, H, N, Dk); v: (B, H, N, Dv); state: (B, H, Dk, Dv).
RWKV convention ("exclusive + bonus"): o_t = q_t (S_{t-1} + (u*k_t) v_t^T),
S_t = exp(logw_t) S_{t-1} + k_t v_t^T. Mamba convention ("inclusive"):
S_t = exp(loga_t) S_{t-1} + k_t v_t^T, o_t = q_t S_t.

The chunked form computes what the reference's chunk scan computes, term
for term and in its order: the inter-chunk term from the state entering
the chunk, plus the intra-chunk term from the pairwise decay weights
exp(clip(cum_q_t - cum_s, -60, 0)), plus the bonus. It is laid out for a
GPU rather than as one scan body per chunk: the intra-chunk terms of all
chunks are batched matmuls (for a per-channel decay, in groups of chunks
whose (C, C, Dk) pair tensors together stay under `PAIR_ELEMS` elements),
and only the state recurrence S_{c+1} = exp(cC_c) S_c + K_c^T V_c runs
chunk by chunk, a multiply-add of (B, H, Dk, Dv) states. The reference
rematerializes each chunk in the backward; here the models rematerialize
whole layers (`distributed.ctx.maybe_remat`), which bounds the saved pair
tensors to one layer's: at full zamba2-1.2b width (B 1, H 64, N 4096, C
64) a layer's scalar-decay (C, C) weights are 64 MiB in f32, so per-chunk
checkpoints would save little and cost a launch sequence per chunk.

Under context parallelism (the sequence split over the "data" ranks of a
`distributed.ctx` mesh) a scan from no given state runs twice: from zero,
which gives the state this rank's rows leave and their total log decay,
then from the state entering its first row (`ctx.carry_in` folds every
earlier rank's pair). Exact in exact arithmetic.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.distributed import ctx

# the most pair-tensor elements (B * H * chunks * C * C * Dk) a group of
# chunks of the per-channel-decay path builds at once: 512 MiB in f32
PAIR_ELEMS = 1 << 27
CLIP_LO = -60.0


def decayed_la_scan(q, k, v, logw, u: Optional[torch.Tensor] = None,
                    inclusive: bool = False, s0=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-token recurrence (oracle). Returns (o, final_state), f32."""
    b, h, n, dk = q.shape
    dv = v.shape[-1]
    s = (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device)
         if s0 is None else s0)
    q, k, v, logw = (t.float() for t in (q, k, v, logw))
    outs = []
    for t in range(n):
        o, s = decayed_la_step(q[:, :, t], k[:, :, t], v[:, :, t],
                               logw[:, :, t], s, u=u, inclusive=inclusive)
        outs.append(o)
    return torch.stack(outs, dim=2), s


def chunk_size(n: int, chunk: int) -> int:
    """The reference's chunk: the largest size <= `chunk` that divides N
    (N 17 at chunk 64 runs one chunk of 17)."""
    chunk = min(chunk, n)
    while n % chunk:
        chunk -= 1
    return chunk


def _intra(qi, ki, vi, wi, mask, inclusive: bool, scalar_decay: bool,
           in_dtype):
    """One group of g chunks: (o_intra, cum_q, cC, kv), where o_intra
    (B, H, g, C, Dv) f32 is the intra-chunk term, cum_q the cumulative log
    decay each row's inter-chunk term takes, cC each chunk's total, and kv
    (B, H, g, Dk, Dv) each chunk's decayed sum K^T V that enters the state
    after it."""
    cum = torch.cumsum(wi, dim=3)  # inclusive cumulative log decay
    cum_q = cum if inclusive else cum - wi  # decay applied before o_t
    if scalar_decay:
        pair = torch.exp(torch.clamp(
            cum_q[..., :, None] - cum[..., None, :], CLIP_LO, 0.0))
        a = torch.matmul(qi, ki.transpose(-1, -2)) * pair
        a = torch.where(mask, a, torch.zeros_like(a))
        o = torch.matmul(a, vi)
        cc = cum[..., -1]
        kd = ki * torch.exp(cc[..., None, None] - cum[..., None])
    else:
        # pairwise (t, s, d) weights: exponent <= 0, overflow-free. The
        # (C, C) matrix is rounded to the input dtype for the AV product,
        # as the reference does.
        pair = torch.exp(torch.clamp(
            cum_q[..., :, None, :] - cum[..., None, :, :], CLIP_LO, 0.0))
        a = torch.einsum("...tsd,...sd->...ts", qi[..., :, None, :] * pair,
                         ki)
        del pair
        a = torch.where(mask, a, torch.zeros_like(a)).to(in_dtype)
        o = torch.matmul(a, vi.to(in_dtype)).float()
        cc = cum[..., -1, :]
        kd = ki * torch.exp(cc[..., None, :] - cum)
    kv = torch.matmul(kd.transpose(-1, -2), vi)
    return o, cum_q, cc, kv


def decayed_la_chunked(q, k, v, logw, u: Optional[torch.Tensor] = None,
                       inclusive: bool = False, chunk: int = 64, s0=None,
                       scalar_decay: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunk-parallel decayed linear attention. Returns (o, final_state),
    f32.

    scalar_decay: logw is a (B, H, N) per-head scalar (Mamba2) instead of
    (B, H, N, Dk); the intra-chunk weights are then a masked (C, C)
    matrix. The chunk is `chunk_size(N, chunk)`. With bf16 or f16 `v`
    the per-channel path rounds its (C, C) matrix and v to that dtype for
    the AV product (f32 accumulation), as the reference; the scalar path
    stays in f32. Under context parallelism with `s0` None, the scan
    starts from the state entering this rank's rows (module docstring)."""
    b, h, n, dk = q.shape
    dv = v.shape[-1]
    if s0 is None and ctx.seq_parallel():
        zero = torch.zeros((b, h, dk, dv), dtype=torch.float32,
                           device=q.device)
        _, end = decayed_la_chunked(q, k, v, logw, u, inclusive, chunk,
                                    zero, scalar_decay)
        s0 = ctx.carry_in(end, logw.float().sum(dim=2))
    in_dtype = (v.dtype if v.dtype in (torch.bfloat16, torch.float16)
                else torch.float32)
    chunk = chunk_size(n, chunk)
    nc = n // chunk
    dev = q.device
    s = (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=dev)
         if s0 is None else s0.float())
    qc = q.float().reshape(b, h, nc, chunk, dk)
    kc = k.float().reshape(b, h, nc, chunk, dk)
    vc = v.float().reshape(b, h, nc, chunk, dv)
    wshape = (b, h, nc, chunk) if scalar_decay else (b, h, nc, chunk, dk)
    wc = logw.float().reshape(wshape)
    t_idx = torch.arange(chunk, device=dev)
    if inclusive:
        mask = t_idx[:, None] >= t_idx[None, :]  # s <= t
    else:
        mask = t_idx[:, None] > t_idx[None, :]  # s < t

    group = nc
    if not scalar_decay:
        group = max(1, min(nc, PAIR_ELEMS // (b * h * chunk * chunk * dk)))
    parts = [_intra(qc[:, :, g0:g0 + group], kc[:, :, g0:g0 + group],
                    vc[:, :, g0:g0 + group], wc[:, :, g0:g0 + group], mask,
                    inclusive, scalar_decay, in_dtype)
             for g0 in range(0, nc, group)]
    o_intra, cum_q, cc, kv = (torch.cat(t, dim=2) for t in zip(*parts))
    del parts
    # the state recurrence, chunk by chunk: s_in[c] enters chunk c.
    # unbind, not indexing: a select's backward writes a zero tensor of
    # the whole input per chunk, unbind's stacks the chunks' gradients once
    s_in = []
    for dc, kvc in zip(torch.exp(cc).unbind(2), kv.unbind(2)):
        s_in.append(s)
        dc = dc[..., None, None] if scalar_decay else dc[..., :, None]
        s = dc * s + kvc
    s_in = torch.stack(s_in, dim=2)  # (B, H, nc, Dk, Dv)
    if scalar_decay:
        o = torch.exp(cum_q)[..., None] * torch.matmul(qc, s_in)
    else:
        o = torch.matmul(qc * torch.exp(cum_q), s_in)
    o = o + o_intra
    if not inclusive and u is not None:
        bonus = (qc * (u[None, :, None, None, :] * kc)).sum(-1)
        o = o + bonus[..., None] * vc
    return o.reshape(b, h, n, dv), s


def decayed_la_step(qt, kt, vt, wt, s, u: Optional[torch.Tensor] = None,
                    inclusive: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step. qt/kt/wt: (B, H, Dk); vt: (B, H, Dv); s: (B, H,
    Dk, Dv). Returns (o (B, H, Dv), new state), f32."""
    qt, kt, vt, wt = (t.float() for t in (qt, kt, vt, wt))
    kv = kt[..., :, None] * vt[..., None, :]
    if inclusive:
        s = torch.exp(wt)[..., None] * s + kv
        return torch.einsum("bhd,bhde->bhe", qt, s), s
    att = s if u is None else s + (u[None] * kt)[..., None] * vt[..., None, :]
    o = torch.einsum("bhd,bhde->bhe", qt, att)
    s = torch.exp(wt)[..., None] * s + kv
    return o, s
