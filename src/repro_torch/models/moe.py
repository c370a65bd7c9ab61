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
`index_copy`, exact and deterministic where it is read. The
reference's mesh helpers (`ctx.shard_expert_buf`, `ctx.ep_gather`,
`ctx.fsdp_gather`) are ported in `distributed/ctx.py` but not called
here: expert parallelism is ROADMAP.md item 18, and the LM forward
refuses the MoE FFN under a mesh.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
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
    """Router of one call over tokens (T, d): f32 softmax probabilities,
    the top-k experts (ties to the lower index, as `jax.lax.top_k`) with
    their renormalized gates, the Switch-style aux loss, and the dispatch:
    `keep` (T * k,) whether the slot fits its expert's capacity and `dst`
    its buffer row (E * cap for a dropped slot)."""
    e, k = cfg.num_experts, cfg.experts_per_token
    # slots per expert: Python float arithmetic, as the reference
    cap = max(1, int(cfg.capacity_factor * tokens.shape[0] * k / e))
    probs = torch.softmax(tokens.float() @ router.float(), dim=-1)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = top[:, :k], order[:, :k]
    gate = gate / torch.clamp(gate.sum(dim=-1, keepdim=True), min=1e-9)
    density = F.one_hot(eidx[:, 0], e).float().mean(dim=0)
    aux = e * (density * probs.mean(dim=0)).sum()
    flat_e = eidx.reshape(-1)
    onehot = F.one_hot(flat_e, e)
    my_pos = ((onehot.cumsum(dim=0) - onehot) * onehot).sum(dim=-1)
    keep = my_pos < cap
    dst = torch.where(keep, flat_e * cap + my_pos,
                      torch.full_like(flat_e, e * cap))
    return dict(probs=probs, gate=gate, eidx=eidx, aux=aux, keep=keep,
                dst=dst, cap=cap)


def moe_apply(params, x: torch.Tensor, cfg: ArchConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d) in x.dtype, aux loss f32 scalar).
    `params` is the `MoE` module or a tree of its tensors with the same
    attributes; the expert weights are read in x.dtype, the router in
    f32."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    tokens = x.reshape(b * s, d)
    t = tokens.shape[0]
    r = route(params.router, tokens, cfg)
    cap, keep, dst = r["cap"], r["keep"], r["dst"]
    sent = tokens.repeat_interleave(k, dim=0) * keep[:, None].to(x.dtype)
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.index_copy(0, dst, sent)  # row e * cap: the dropped slots
    eb = buf[:e * cap].reshape(e, cap, d)
    g, u = torch.bmm(eb, params.wi.to(x.dtype)).chunk(2, dim=-1)
    out_e = torch.bmm(F.silu(g) * u, params.wo.to(x.dtype))
    out_buf = F.pad(out_e.reshape(e * cap, d), (0, 0, 0, 1))
    recv = out_buf[dst]  # a dropped slot reads the zero row
    w = (r["gate"].reshape(-1) * keep.float()).to(recv.dtype)
    y = (recv * w[:, None]).reshape(t, k, d).sum(dim=1)
    if cfg.moe_shared_expert:
        y = y + _swiglu(tokens, params.shared_wi.to(x.dtype),
                        params.shared_wo.to(x.dtype))
    return y.reshape(b, s, d), r["aux"]
