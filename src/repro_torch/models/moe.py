"""Token-choice top-k Mixture-of-Experts FFN (scatter/gather dispatch).

Counterpart of `repro.models.moe`. Sort-free dispatch: each (token, slot)
finds its position within its expert by a cumsum over the one-hot of its
expert, in the flat token-major (T * k) order, and is copied into an
(E * capacity, d) buffer; no (tokens, E, capacity) one-hot is built. A
slot past its expert's capacity is dropped, so which slot drops depends
on every token of the call, padding included: an MoE layer is not
batch-invariant, here as in the reference.

The reference's out-of-bounds scatter (`mode="drop"`) and fill-mode
gather become a sentinel row at `E * capacity` that is sliced off before
the experts run and reads zero after them. Kept destinations are unique
(only dropped slots share the sentinel row), so the dispatch is an
`index_copy`, exact and deterministic where it is read.

Under a DeviceMesh (`distributed.ctx`) the experts run over "model"
(expert parallelism). The residual is whole on every "model" rank, so a
data rank's tokens are already on each of its model ranks and the
reference's all-to-all has nothing to move: each rank routes its own
tokens (the router read whole), fills the (E, capacity, d) buffer with
them, runs the expert matmuls on its own experts' rows only
(`ctx.shard_expert_buf`, weights through `ctx.ep_gather`), reads its
experts' slots back (zero for the others' slots) and sums the slots over
"model" (`ctx.from_tp`) before the gates weight them. The capacity and
the drops follow the global token order, as GSPMD's global semantics
give them: the capacity comes from the global token count, the expert
ids are all-gathered over "data" into the global (b, s) order
(`ctx.gather_tokens`) for the position cumsum, and each rank keeps its
own slots' rows (not contiguous under context parallelism with a batch
above 1). The aux loss's density and mean probability are global means,
sums over "data" (`ctx.sum_data`). The shared expert is a
tensor-parallel dense FFN. Without a mesh every hook is the identity; a
1 x 1 mesh runs the same operations with one-rank collectives.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import ctx
from repro_torch.models.common import dense_init


class MoE(nn.Module):
    """One layer's MoE FFN parameters, named as the reference's leaves:
    `router` (d, E), `wi` (E, d, 2 ff), `wo` (E, ff, d) and, with a shared
    expert, `shared_wi` (d, 2 ff) and `shared_wo` (ff, d)."""

    def __init__(self, cfg: ArchConfig, generator=None, dtype=torch.float32,
                 device=None):
        super().__init__()
        d, e, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff

        def dense(i, o):
            return dense_init(generator, i, o, torch.float32, device)

        self.router = nn.Parameter(dense(d, e).to(dtype))
        # every expert starts from one draw; noise on wi breaks symmetry
        wi = dense(d, 2 * ff)[None] + 0.02 * torch.randn(
            (e, d, 2 * ff), generator=generator, device=device)
        self.wi = nn.Parameter(wi.to(dtype))
        del wi
        self.wo = nn.Parameter(dense(ff, d).to(dtype)[None].repeat(e, 1, 1))
        if cfg.moe_shared_expert:
            self.shared_wi = nn.Parameter(dense(d, 2 * ff).to(dtype))
            self.shared_wo = nn.Parameter(dense(ff, d).to(dtype))


def moe_init(generator: Optional[torch.Generator], cfg: ArchConfig,
             dtype=torch.float32, device=None) -> MoE:
    """Random MoE parameters drawn from `generator` (not bitwise the
    reference's init; tests carry its weights over with `bridge`)."""
    return MoE(cfg, generator, dtype, device)


def _swiglu(x: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor
            ) -> torch.Tensor:
    g, u = (x @ wi).chunk(2, dim=-1)
    return (F.silu(g) * u) @ wo


def route(router: torch.Tensor, tokens: torch.Tensor, cfg: ArchConfig
          ) -> dict:
    """Router of one call over this rank's tokens, (B, S, d) or (T, d)
    (one row of T), flattened in the (b, s) order: f32 softmax
    probabilities (T, E), the top-k experts (ties to the lower index, as
    `jax.lax.top_k`) with their renormalized gates, the Switch-style aux
    loss over every rank's tokens, and the dispatch in the global (b, s)
    order (`ctx.gather_tokens`): `keep` (T * k,) whether this rank's slot
    fits its expert's capacity and `dst` its buffer row (E * cap for a
    dropped slot), and `keep_all` every rank's slots (`keep` itself
    without a mesh)."""
    e, k = cfg.num_experts, cfg.experts_per_token
    rows = tuple(tokens.shape[:-1]) if tokens.ndim == 3 else (1, -1)
    tokens = tokens.reshape(-1, tokens.shape[-1])
    probs = torch.softmax(tokens.float() @ router.float(), dim=-1)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = top[:, :k], order[:, :k]
    gate = gate / torch.clamp(gate.sum(dim=-1, keepdim=True), min=1e-9)
    # the global (b, s) order of every rank's expert ids
    glob = ctx.gather_tokens(eidx.reshape(rows + (k,)))
    t_all = glob.shape[0] * glob.shape[1]
    # global means: sums over the data ranks over the global count
    density = ctx.sum_data(F.one_hot(eidx[:, 0], e).float().sum(dim=0))
    mean_p = ctx.sum_data(probs.sum(dim=0))
    aux = e * ((density / t_all) * (mean_p / t_all)).sum()
    # slots per expert: Python float arithmetic, as the reference
    cap = max(1, int(cfg.capacity_factor * t_all * k / e))
    flat_e = glob.reshape(-1)
    onehot = F.one_hot(flat_e, e)
    my_pos = ((onehot.cumsum(dim=0) - onehot) * onehot).sum(dim=-1)
    keep_all = my_pos < cap
    dst_all = torch.where(keep_all, flat_e * cap + my_pos,
                          torch.full_like(flat_e, e * cap))

    def mine(t):
        return ctx.local_tokens(t.reshape(glob.shape)).reshape(-1)

    return dict(probs=probs, gate=gate, eidx=eidx, aux=aux,
                keep=mine(keep_all), dst=mine(dst_all), cap=cap,
                keep_all=keep_all)


def moe_apply(params, x: torch.Tensor, cfg: ArchConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d) in x.dtype, aux loss f32 scalar).
    `params` is the `MoE` module or a tree of its tensors with the same
    attributes; the expert weights are read in x.dtype, the router in
    f32. Under a mesh x is this rank's rows (module docstring)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    tokens = x.reshape(b * s, d)
    t = tokens.shape[0]
    r = route(ctx.fsdp_gather(params.router, "rep"), x, cfg)
    cap, keep, dst = r["cap"], r["keep"], r["dst"]
    # the experts' input: each "model" rank's share of its gradient comes
    # from its own experts (the router reads x whole, outside the region)
    xt = ctx.to_tp(tokens)
    sent = xt.repeat_interleave(k, dim=0) * keep[:, None].to(x.dtype)
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.index_copy(0, dst, sent)  # row e * cap: the dropped slots
    eb = ctx.shard_expert_buf(buf[:e * cap].reshape(e, cap, d))
    g, u = torch.bmm(eb, ctx.ep_gather(params.wi).to(x.dtype)).chunk(
        2, dim=-1)
    out_e = torch.bmm(F.silu(g) * u, ctx.ep_gather(params.wo).to(x.dtype))
    # this rank's experts' rows in place, zeros for the others' and the
    # dropped slots' row
    rank, _ = ctx.model_rank_size()
    rows = out_e.shape[0] * cap
    out_buf = F.pad(out_e.reshape(rows, d),
                    (0, 0, rank * rows, e * cap + 1 - (rank + 1) * rows))
    recv = ctx.from_tp(out_buf[dst])  # every expert's slots, summed
    w = (r["gate"].reshape(-1) * keep.float()).to(recv.dtype)
    y = (recv * w[:, None]).reshape(t, k, d).sum(dim=1)
    if cfg.moe_shared_expert:
        y = y + ctx.from_tp(_swiglu(
            xt, ctx.fsdp_gather(params.shared_wi, "col", chunks=2)
            .to(x.dtype),
            ctx.fsdp_gather(params.shared_wo, "row").to(x.dtype)))
    return y.reshape(b, s, d), r["aux"]
