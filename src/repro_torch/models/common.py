"""Shared model building blocks. Counterpart of `repro.models.common`.

Conventions: weights keep the reference's layout (`x @ W` with W of shape
(in, out)); norms, softmax and losses in f32; attention tensors are
(B, H, N, Dh).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core import reference as sref
from repro_torch.core.block_sparse_xla import sparse_component_gather
from repro_torch.core.config import SLAConfig
from repro_torch.core.masks import NEG_INF
from repro_torch.core.plan import repeat_kv
from repro_torch.core.sla import sla_attention
from repro_torch.distributed import ctx


def dense_init(generator: Optional[torch.Generator], in_dim: int,
               out_dim: int, dtype=torch.float32, device=None
               ) -> torch.Tensor:
    scale = (2.0 / (in_dim + out_dim)) ** 0.5
    w = torch.randn((in_dim, out_dim), generator=generator,
                    dtype=torch.float32, device=device) * scale
    return w.to(dtype)


def embed_init(generator: Optional[torch.Generator], vocab: int, dim: int,
               dtype=torch.float32, device=None) -> torch.Tensor:
    return (torch.randn((vocab, dim), generator=generator,
                        dtype=torch.float32, device=device)
            * dim**-0.5).to(dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm with the (1 + w) scale: statistics in f32, the elementwise
    math in x.dtype (as the reference's forward)."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    r = torch.rsqrt(var + eps)
    wp1 = (1.0 + w.float()).to(x.dtype)
    return x * r.to(x.dtype) * wp1


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4
         ) -> torch.Tensor:
    """Rotary embedding with the half-split rotation, angles in f32.
    x: (B, H, N, D); positions: (B, N) or (N,)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freq  # (B, N, half)
    cos = torch.cos(ang)[:, None]
    sin = torch.sin(ang)[:, None]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   window: int, causal: bool, scale=None, block: int = 128
                   ) -> torch.Tensor:
    """Banded sliding-window attention, O(N * window): block-sparse
    attention over a static band LUT through the gather machinery, so no
    N x N score matrix is built. The band is block-granular, as the
    reference's: each query block attends its wb = ceil(window / block)
    + 1 nearest blocks whole (the previous ones when causal, with the
    causal mask inside them; a band shifted to stay in bounds
    otherwise), with no token-level window mask. q, k, v: (B, H, N, D)
    with k, v already at H heads. Returns q.dtype."""
    b, h, n, _ = q.shape
    dev = q.device
    block = min(block, n)
    while n % block:
        block //= 2
    tm = n // block
    wb = min(tm, max(1, (window + block - 1) // block + 1))
    rows = torch.arange(tm, device=dev)[:, None]
    offs = torch.arange(wb, device=dev)[None, :]
    if causal:
        idx = torch.clamp(rows - (wb - 1) + offs, 0, tm - 1)
        counts = torch.clamp(rows[:, 0] + 1, max=wb)
        # the live slots are the last `counts`: rotate them to the front
        shift = wb - counts[:, None]
        idx = torch.gather(idx, 1, (offs + shift) % wb)
    else:
        start = torch.clamp(rows - wb // 2, 0, tm - wb)
        idx = start + offs  # in bounds, no duplicates
        counts = torch.full((tm,), wb, device=dev)
    lut = idx[None, None].expand(b, h, tm, wb).to(torch.int32)
    cnts = counts[None, None].expand(b, h, tm).to(torch.int32)
    cfg = SLAConfig(block_q=block, block_kv=block, causal=causal,
                    window=window)
    o, _ = sparse_component_gather(q, k, v, lut, cnts, cfg, scale)
    return o.to(q.dtype)


def kv_kind(num_kv_heads: int) -> str:
    """`ctx.fsdp_gather` kind of a layer's wk / wv: this "model" rank's
    KV heads ("col") when the axis divides them, else all of them ("tp"),
    from which `local_kv_heads` picks."""
    _, m = ctx.model_rank_size()
    return "col" if num_kv_heads % m == 0 else "tp"


def local_kv_heads(t: torch.Tensor, num_heads: int, num_kv_heads: int
                   ) -> torch.Tensor:
    """Where "model" does not divide the KV heads they stay whole on every
    rank (t: (B, Hkv, N, D)): return the KV head of each of this rank's
    query heads (GQA group 1), since a kernel maps a local query head to
    a KV head as `bh // group` and this rank's first query head is global
    head rank * H_loc. Otherwise `t` (its heads are this rank's)."""
    rank, m = ctx.model_rank_size()
    if num_kv_heads % m == 0:
        return t
    h = num_heads // m
    group = num_heads // num_kv_heads
    idx = (rank * h + torch.arange(h, device=t.device)) // group
    return t.index_select(1, idx)


def qkv_heads(xq: torch.Tensor, xkv: torch.Tensor, wq, wk, wv, cfg,
              pick: bool = True) -> tuple:
    """q from xq (B, Sq, d) and k, v from xkv (B, Sk, d), as (B, heads,
    S, Dh), through this "model" rank's query heads of wq and the KV
    heads they read of wk / wv (each read by `ctx.fsdp_gather`; k and v
    picked by `local_kv_heads`); no rope. Without a mesh, all heads.
    `pick=False` returns k and v at the heads projected (this rank's KV
    heads, or all of them where "model" does not divide them): the heads
    a KV cache holds."""
    _, m = ctx.model_rank_size()
    h, hkv, dh = cfg.num_heads // m, cfg.num_kv_heads, cfg.head_dim
    kvk = kv_kind(hkv)
    hk = hkv // m if kvk == "col" else hkv

    def proj(x, w, kind, heads):
        b, s, _ = x.shape
        return (x @ ctx.fsdp_gather(w, kind).to(x.dtype)) \
            .reshape(b, s, heads, dh).transpose(1, 2)

    k, v = proj(xkv, wk, kvk, hk), proj(xkv, wv, kvk, hk)
    if pick:
        k = local_kv_heads(k, cfg.num_heads, hkv)
        v = local_kv_heads(v, cfg.num_heads, hkv)
    return proj(xq, wq, "col", h), k, v


def attention(sla_params: Optional[dict], q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, kind: str, sla_cfg: SLAConfig,
              window: int = 0, causal: bool = True, backend: str = "gather",
              plan=None, routing: Optional[dict] = None) -> torch.Tensor:
    """Unified attention entry. kind: "sla" | "full" | "swa" (the banded
    sliding window of `window` tokens). k, v may have fewer (GQA)
    heads. Under a mesh, q, k and v are this rank's plain local tensors
    (its batch rows, its heads, the whole sequence): the kernels read
    `data_ptr()`, so a DTensor here is an error."""
    from torch.distributed.tensor import DTensor
    if any(isinstance(t, DTensor) for t in (q, k, v)):
        raise TypeError("attention takes plain local tensors; gather the "
                        "weights with distributed.ctx.fsdp_gather first")
    h = q.shape[1]
    if kind == "full":
        return sref.full_attention(q, repeat_kv(k, h), repeat_kv(v, h),
                                   causal).to(q.dtype)
    if kind == "swa":
        return _swa_attention(q, repeat_kv(k, h), repeat_kv(v, h), window,
                              causal)
    if kind == "sla":
        cfg = dataclasses.replace(sla_cfg, causal=causal)
        return sla_attention(sla_params, q, k, v, cfg, backend=backend,
                             plan=plan, routing=routing)
    raise ValueError(f"unknown attention kind {kind!r}")


def cache_attention(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                    upto: Optional[int] = None) -> torch.Tensor:
    """Dense softmax attention of q (B, H, Sq, D) over a static cache
    (B, Hkv, S, D) in f32, masked past position `upto` when given (the
    recurrent and encoder-decoder families' decode). Returns q.dtype."""
    h = q.shape[1]
    kk = (torch.repeat_interleave(kc, h // kc.shape[1], 1)
          if kc.shape[1] != h else kc)
    vv = (torch.repeat_interleave(vc, h // vc.shape[1], 1)
          if vc.shape[1] != h else vc)
    s = torch.matmul(q.float(), kk.float().transpose(-1, -2)) \
        * q.shape[-1]**-0.5
    if upto is not None:
        ok = torch.arange(kc.shape[2], device=q.device) <= upto
        s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    return torch.matmul(torch.softmax(s, dim=-1), vv.float()).to(q.dtype)


def routing_of(p) -> Optional[dict]:
    """A block's learned-routing head as a dict (under a mesh, this
    "model" rank's heads of it), or None without one."""
    routing = getattr(p, "routing", None)
    return None if routing is None else {
        n: ctx.fsdp_gather(w, "row") for n, w in routing.items()}


def output_table(params) -> torch.Tensor:
    """The LM's output table: `unembed`, or the tied `embed` when there is
    none. `params` is the model module or a tree of its tensors."""
    table = getattr(params, "unembed", None)
    return params.embed if table is None else table


def logits_from_hidden(params, hidden: torch.Tensor) -> torch.Tensor:
    """Unembed final hidden states: (..., D) -> (..., V) f32 logits over
    `output_table(params)`. Under a mesh the table is read as this
    "model" rank's rows of the vocabulary (`ctx.vocab_shard`) and the
    rows' logits are all-gathered over "model" in rank order, so every
    rank returns all V columns (inference only: no gradient)."""
    rows, _, group = ctx.vocab_shard(output_table(params))
    logits = hidden.float() @ rows.float().t()
    if group is None:
        return logits
    parts = [torch.empty_like(logits)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, logits.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


class _ChunkedXent(torch.autograd.Function):
    """Sum over rows of mask * (logsumexp(logits) - logits[target]), with
    f32 logits = x @ table^T built one (B, chunk, V) chunk at a time. The
    forward keeps only each row's logsumexp; the backward rebuilds each
    chunk's logits from it, so peak logits memory stays one chunk (and its
    gradient) both ways.

    `table` may be one "model" rank's rows of the vocabulary, from id
    `first` (`ctx.vocab_shard`): the rows' max, their sum of exponentials
    and the target's logit (held by one rank) are then reduced over
    `group`, and x's gradient is this rank's share (the caller sums it
    over `group`)."""

    @staticmethod
    def forward(ctx, x, table, targets, mask, chunk: int, first: int,
                group):
        b, s, _ = x.shape
        t32 = table.float()
        v = t32.shape[0]
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        lse = torch.empty((b, s), dtype=torch.float32, device=x.device)
        for c0 in range(0, s, chunk):
            rows = slice(c0, c0 + chunk)
            logits = x[:, rows].float() @ t32.t()
            idx = targets[:, rows] - first
            gold = torch.where(
                (idx >= 0) & (idx < v),
                logits.gather(-1, idx.clamp(0, v - 1)[..., None])[..., 0],
                0.0)
            top = logits.amax(-1)
            if group is not None:
                dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
            sums = logits.sub_(top[..., None]).exp_().sum(-1)
            if group is not None:
                both = torch.stack([sums, gold])
                dist.all_reduce(both, group=group)
                sums, gold = both
            lse[:, rows] = torch.log(sums) + top
            total = total + ((lse[:, rows] - gold) * mask[:, rows]).sum()
            del logits
        ctx.save_for_backward(x, table, targets, mask, lse)
        ctx.chunk, ctx.first = chunk, first
        return total

    @staticmethod
    def backward(ctx, grad):
        x, table, targets, mask, lse = ctx.saved_tensors
        want_x, want_t = ctx.needs_input_grad[:2]
        t32 = table.float()
        v = t32.shape[0]
        dx = torch.empty_like(x) if want_x else None
        dt = torch.zeros_like(t32) if want_t else None
        for c0 in range(0, x.shape[1], ctx.chunk):
            rows = slice(c0, c0 + ctx.chunk)
            xi = x[:, rows].float()
            # d(lse - gold) / d logits = softmax - onehot(target)
            dlog = (xi @ t32.t()).sub_(lse[:, rows, None]).exp_()
            idx = targets[:, rows, None] - ctx.first
            dlog.scatter_add_(-1, idx.clamp(0, v - 1),
                              -((idx >= 0) & (idx < v)).to(dlog.dtype))
            dlog.mul_((grad * mask[:, rows])[..., None])
            if want_x:
                dx[:, rows] = (dlog @ t32).to(x.dtype)
            if want_t:
                dt += dlog.reshape(-1, dlog.shape[-1]).t() @ xi.reshape(
                    -1, xi.shape[-1])
            del dlog
        return (dx, dt.to(table.dtype) if want_t else None, None, None,
                None, None, None)


def chunked_softmax_xent(x: torch.Tensor, embed: torch.Tensor,
                         targets: torch.Tensor,
                         mask: Optional[torch.Tensor] = None,
                         chunk: int = 512) -> torch.Tensor:
    """Cross-entropy without materializing full (B, S, V) logits.

    x: final hidden states (B, S, D); embed: (V, D) output table; targets:
    (B, S) integer. f32 logits over the f32-cast table, one (B, chunk, V)
    chunk at a time, forward and backward (each chunk's logits are built
    again from its rows' logsumexp), so peak logits memory is (B, chunk,
    V). The chunk is the largest size <= `chunk` that divides S, as in
    the reference. Returns the mean over the rows `mask` keeps (all rows
    without a mask).

    Under a mesh `embed` is the stored DTensor: each "model" rank scores
    its own rows of the vocabulary (`ctx.vocab_shard`), the logsumexp and
    the target's logit reduced over "model"; the mean is over every data
    rank's rows (the sum and the count summed over the data ranks, as
    their rows' counts differ under the VLM prefix)."""
    b, s, _ = x.shape
    chunk = min(chunk, s)
    while s % chunk:
        chunk -= 1
    m = (torch.ones((b, s), dtype=torch.float32, device=x.device)
         if mask is None else mask.float())
    table, first, group = ctx.vocab_shard(embed)
    total = _ChunkedXent.apply(ctx.to_tp(x, group) if group is not None
                               else x, table, targets.long(), m, chunk,
                               first, group)
    return ctx.sum_data(total) / torch.clamp(ctx.sum_data(m.sum()),
                                             min=1.0)


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error; under a mesh, the mean over every data rank's
    elements."""
    diff = pred.float() - target.float()
    lay = ctx.layout()
    if lay is None or lay.data_group is None:
        return (diff * diff).mean()
    count = torch.tensor(float(diff.numel()), device=diff.device)
    return ctx.sum_data((diff * diff).sum()) / ctx.sum_data(count)
