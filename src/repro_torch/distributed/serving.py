"""Sharded serving: the KV cache's layout over a ("data", "model") mesh and
the flash-decoding attention that layout needs.

`sharding.cache_shardings` places a (L, B, Hkv, S, D) KV cache in one of
three layouts, and this module reads which one from the rules
(`kv_layout`), so the rules stay the one source:

  A. heads over "model", the batch over the data axes (the batch divides
     the dp axes and "model" divides the KV heads). Decode is the
     one-device math on each rank's heads.
  B. the sequence over "model" (flash-decoding: "model" does not divide
     the KV heads). Every rank holds all KV heads for its span of
     positions, so it needs every query head: the new token's q is
     all-gathered over "model", each rank takes a partial softmax over
     its span (`decode_partial`), the partials are all-gathered and
     combined in rank order (`decode_combine`), and the rank keeps its own
     query heads for the row-parallel output projection.
  C. the sequence over "data" (batch 1, `long_500k`: no dp axis), heads
     over "model" where they divide, else the sequence over ("data",
     "model") with every KV head on every rank (B's q gather with the
     combine over all ranks).

`decode_partial`, `decode_combine` and `write_token` are plain functions
of local tensors, so one process can also call them over slices of a
whole cache (the CPU tests and `chip_smoke.py` do). The partial holds,
for each query head, the row max over the span's visible columns, the sum
of exponentials against it and the unnormalised output; the combine
rescales each to the global max and sums in rank order, so every rank
gets the same bits. Decode is inference only: the collectives here carry
no gradient.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed import ctx, sharding

NEG_INF = -1e30  # the masked score (`core.masks.NEG_INF`)


@dataclasses.dataclass(frozen=True)
class KVLayout:
    """Where this rank's part of a (L, B, Hkv, S, D) KV cache sits under
    the rules: `spec` (of its trailing dims), whether the KV heads are
    split over "model" (`heads_split`, also true on a "model" axis of 1),
    the axes the sequence is split over, major first (`seq_axes`), their
    rank count and this rank's index among them, and the data-parallel
    degree of the batch (`dp`)."""
    mesh: object
    spec: tuple
    heads_split: bool
    seq_axes: Tuple[str, ...]
    seq_parts: int
    seq_index: int
    dp: int

    def check_length(self, length: int) -> None:
        """Refuse a cache length the sequence's ranks do not divide: the
        rules would leave such a sequence whole on each of them, and a
        rank's span would no longer follow from its local length."""
        if length % self.seq_parts:
            raise ValueError(
                f"a cache of {length} positions with its sequence over "
                f"{self.seq_axes} needs a length its {self.seq_parts} "
                f"ranks divide")

    def span(self, length: int) -> Tuple[int, int]:
        """(first position, positions) of this rank's span of a cache of
        `length` positions."""
        n = length // self.seq_parts
        return self.seq_index * n, n

    def local_shape(self, shape) -> Tuple[int, ...]:
        """This rank's shape of a global (L, B, Hkv, S, D) leaf."""
        return sharding.NamedSharding(self.mesh, self.spec).shard_shape(
            shape)


def kv_layout(mesh, global_batch: int, num_kv_heads: int) -> KVLayout:
    """The layout `cache_shardings` gives the KV leaves of a cache of
    `global_batch` rows and `num_kv_heads` heads on `mesh` (at a length
    its sequence's ranks divide: `check_length`)."""
    sizes = sharding.axis_sizes(mesh)
    world = 1
    for s in sizes.values():
        world *= s
    # a length every axis product divides: the rule's own choice of axes
    probe = torch.empty((1, global_batch, num_kv_heads, world, 1),
                        device="meta")
    spec = sharding.cache_shardings(mesh, {"k": probe},
                                    global_batch)["k"].spec
    spec = tuple(spec) + (None,) * (5 - len(spec))
    seq = spec[3]
    seq_axes = () if seq is None else sharding._axes(seq)
    parts, index = 1, 0
    for axis in seq_axes:
        parts *= sizes[axis]
        index = index * sizes[axis] + mesh.get_local_rank(axis)
    heads = spec[2]
    heads_split = sizes.get("model", 1) == 1 or (
        heads is not None and "model" in sharding._axes(heads))
    batch = spec[1]
    dp = 1
    for axis in (() if batch is None else sharding._axes(batch)):
        dp *= sizes[axis]
    return KVLayout(mesh, spec, heads_split, seq_axes, parts, index, dp)


def active_kv_layout(global_batch: int, num_kv_heads: int
                     ) -> Optional[KVLayout]:
    """The KV cache's layout on the active mesh (`kv_layout`), held to the
    residual spec's data parallelism; None without a mesh."""
    lay = ctx.layout()
    if lay is None:
        return None
    kl = kv_layout(lay.mesh, global_batch, num_kv_heads)
    if kl.dp != lay.dp:
        raise ValueError(
            f"the rules split a batch of {global_batch} over {kl.dp} data "
            f"ranks, the residual spec over {lay.dp}: scope serving with "
            f"activation_sharding(mesh, default_residual_spec(mesh, batch, "
            f"cache length))")
    return kl


def local_shapes(leaves: Dict[str, tuple], global_batch: int
                 ) -> Dict[str, Tuple[int, ...]]:
    """This rank's shape of each cache leaf {name: global shape} under
    `sharding.cache_shardings` on the active mesh (the rules read the
    leaf's name: "state" or "ssm" marks a recurrent state); the global
    shapes without a mesh."""
    lay = ctx.layout()
    if lay is None:
        return {name: tuple(shape) for name, shape in leaves.items()}
    metas = {name: torch.empty(shape, device="meta")
             for name, shape in leaves.items()}
    rules = sharding.cache_shardings(lay.mesh, metas, global_batch)
    return {name: rules[name].shard_shape(shape)
            for name, shape in leaves.items()}


def is_sharded(kl: Optional[KVLayout]) -> bool:
    """Whether decode attention over a cache of layout `kl` needs the
    partial softmax and combine (`sharded_decode_attn`): its sequence is
    split, or every rank holds every KV head. False without a mesh and
    in layout A, where the one-device math runs on the rank's heads."""
    return kl is not None and (kl.seq_parts > 1 or not kl.heads_split)


# --------------------------------------------------------------------------
# the token write and the attention, on local tensors
# --------------------------------------------------------------------------
def write_token(c: torch.Tensor, new: torch.Tensor, pos, start: int,
                length: int) -> None:
    """Write one new token's K or V into this rank's span, in place: c
    (B, Hn, S_loc, D) holds global positions [start, start + S_loc) of a
    `length`-position cache, new (B, Hn, 1, D). A python-int `pos` is
    written by the rank whose span holds it (a host branch, the same on
    every rank); a (B,) tensor of per-slot positions is a masked scatter
    on every rank, each slot written by its owner, a runaway slot clamped
    to the last position first (as the one-device `_cache_write`)."""
    n = c.shape[2]
    if not torch.is_tensor(pos):
        if start <= pos < start + n:
            c[:, :, pos - start] = new[:, :, 0].to(c.dtype)
        return
    local = pos.long().clamp(0, length - 1) - start
    own = (local >= 0) & (local < n)
    idx = local.clamp(0, n - 1)
    b = torch.arange(c.shape[0], device=c.device)
    c[b, :, idx] = torch.where(own[:, None, None], new[:, :, 0].to(c.dtype),
                               c[b, :, idx])


def decode_partial(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                   pos, start: int, window: int = 0) -> torch.Tensor:
    """Partial softmax attention of one decode token over a span of the
    cache. q (B, H, D), H a multiple of kc's heads (the GQA group folds
    into the query as in the one-device `_dense_decode_attn`); kc, vc
    (B, Hkv, S_loc, D) hold global positions [start, start + S_loc); pos
    a python int or a (B,) tensor; `window` > 0 also masks the columns at
    or before pos - window (a sliding-window layer), on global columns.
    Returns (B, H, D + 2) f32: the unnormalised output sum_j e_j v_j, the
    row max m over the visible columns (NEG_INF where none is visible)
    and l = sum_j e_j, with e_j = exp(s_j - m)."""
    b, h, d = q.shape
    hkv, n = kc.shape[1], kc.shape[2]
    qg = q.reshape(b, hkv, h // hkv, d)
    s = torch.einsum("bkgd,bksd->bkgs", qg.float(), kc.float()) * (d**-0.5)
    posb = pos if not torch.is_tensor(pos) else pos[:, None, None, None]
    idx = start + torch.arange(n, device=q.device)
    ok = idx <= posb
    if window:
        ok = ok & (idx > posb - window)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    o = torch.einsum("bkgs,bksd->bkgd", e, vc.float())
    out = torch.cat([o, m, e.sum(dim=-1, keepdim=True)], dim=-1)
    return out.reshape(b, h, d + 2)


def decode_combine(parts: torch.Tensor) -> torch.Tensor:
    """Combine the partials of every span, (P, B, H, D + 2) in span order,
    into the attention output (B, H, D) f32: each part rescaled to the
    global row max and summed in order 0 .. P-1 (the max is exact in any
    order), then divided by the summed denominators. Fixed order: every
    rank that combines the same gathered parts gets the same bits."""
    d = parts.shape[-1] - 2
    o, m, l = parts[..., :d], parts[..., d:d + 1], parts[..., d + 1:]
    top = m.amax(dim=0)
    num = torch.zeros_like(o[0])
    den = torch.zeros_like(l[0])
    for r in range(parts.shape[0]):
        w = torch.exp(m[r] - top)
        num = num + o[r] * w
        den = den + l[r] * w
    return num / den


# --------------------------------------------------------------------------
# collectives of a decode step (no autograd)
# --------------------------------------------------------------------------
def _gather(x: torch.Tensor, axis: str, mesh) -> torch.Tensor:
    """(size, *x.shape): every rank's x on `axis`, in rank order."""
    size = sharding.axis_sizes(mesh)[axis]
    if size == 1:
        return x[None]
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.get_group(axis))
    return torch.stack(parts)


def gather_heads(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every "model" rank's heads of x (B, H_loc, ...) along dim 1, in rank
    order: (B, H, ...)."""
    parts = _gather(x, "model", mesh)
    return torch.cat(list(parts), dim=1)


def gather_spans(x: torch.Tensor, lay: KVLayout) -> torch.Tensor:
    """Every span's x over the sequence axes, (seq_parts, *x.shape) in span
    order (the first axis major)."""
    out = x[None]
    for axis in reversed(lay.seq_axes):
        out = _gather(out, axis, lay.mesh)
        out = out.reshape((-1,) + x.shape)
    return out


def sharded_decode_attn(q: torch.Tensor, kc: torch.Tensor,
                        vc: torch.Tensor, pos, lay: KVLayout, length: int,
                        window: int = 0) -> torch.Tensor:
    """Decode attention of this rank's query heads q (B, H_loc, D) over
    its part of the cache kc, vc (B, Hkv_c, S_loc, D) of a `length`-
    position cache under `lay`, whose sequence is split over at least one
    axis. Returns (B, H_loc, D) f32 for this rank's heads.

    Where the KV heads are whole on every rank (the rules then split the
    sequence over "model": layouts B and C over ("data", "model")), q is
    gathered to every head first and this rank's heads are kept after the
    combine. The partial softmax runs over this rank's span and the
    combine over every span, in span order."""
    h_loc = q.shape[1]
    if not lay.heads_split:
        q = gather_heads(q, lay.mesh)
    start, _ = lay.span(length)
    part = decode_partial(q, kc, vc, pos, start, window)
    o = decode_combine(gather_spans(part, lay))
    if not lay.heads_split:
        rank = lay.mesh.get_local_rank("model")
        o = o[:, rank * h_loc:(rank + 1) * h_loc]
    return o
