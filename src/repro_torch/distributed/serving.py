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
whole cache (the CPU tests and `chip_smoke.py` do). They take one token
or a verify-style chunk of C (token c at pos + c: a chunk may cross from
one span into the next), at one position or at each slot's own (a (B,)
`pos`, continuous batching). The partial holds, for each query head, the
row max over the span's visible columns, the sum of exponentials against
it and the unnormalised output; the combine rescales each to the global
max and sums in rank order, so every rank gets the same bits. Decode is
inference only: the collectives here carry no gradient.

Decode-time SLA over the mesh keeps each leaf of its state where
`cache_shardings` puts it (`SLAParts`): the per-block h_j, z_j and
pooled k beside their blocks' K/V, the totals and the plan by their own
rules. `reshard` moves a small tensor between two such placements (an
all-gather of the dims one splits, a slice of the dims the other does),
`read_row` reads one row of a leaf split by rows on every rank (one row,
or one a batch slot), `put_row` writes a batch-1 leaf into a global row
of a leaf at another placement (slot admission). Over a split sequence
each rank attends its span's share of the live row's blocks through
kernel 4's partial records (per-slot rows and chunks too), and the
spans' records, gathered here (`gather_spans`), are merged in span order
by `kernels.sla_decode.sla_decode_combine`.

A paged cache (`transformer.make_paged_cache`) stands for a per-slot
cache and holds, on each rank, the pages of that cache's part under
this layout: in A its data rank's slots at its KV heads, in B and C
every slot's pages at the logical blocks of its span (whole pages),
indexed by the global page id. A split sequence reads the span's
columns of the page table through kernel 5's partial mode, whose
records merge as kernel 4's.
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

    def check_length(self, length: int, block: int = 1) -> None:
        """Refuse a cache length the sequence's ranks do not divide (in
        whole `block`s of positions: decode-time SLA keeps each KV block's
        state beside its K/V): the rules would leave such a sequence whole
        on each of them, and a rank's span would no longer follow from its
        local length."""
        if length % (self.seq_parts * block):
            raise ValueError(
                f"a cache of {length} positions with its sequence over "
                f"{self.seq_axes} needs a length its {self.seq_parts} "
                f"ranks divide"
                + (f" into whole blocks of {block}" if block > 1 else ""))

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
    """Write new tokens' K or V into this rank's span, in place: c
    (B, Hn, S_loc, D) holds global positions [start, start + S_loc) of a
    `length`-position cache, new (B, Hn, C, D) the C tokens at pos ..
    pos + C - 1 (a chunk may cross from one rank's span into the next:
    each rank writes the tokens its span holds). A python-int `pos` is a
    host branch, the same on every rank; a (B,) tensor of per-slot
    positions (C = 1) is a masked scatter on every rank, each slot written
    by its owner, a runaway slot clamped to the last position first (as
    the one-device `_cache_write`)."""
    n = c.shape[2]
    if not torch.is_tensor(pos):
        lo, hi = max(pos, start), min(pos + new.shape[2], start + n)
        if lo < hi:
            c[:, :, lo - start:hi - start] = new[:, :, lo - pos:hi - pos] \
                .to(c.dtype)
        return
    local = pos.long().clamp(0, length - 1) - start
    own = (local >= 0) & (local < n)
    idx = local.clamp(0, n - 1)
    b = torch.arange(c.shape[0], device=c.device)
    c[b, :, idx] = torch.where(own[:, None, None], new[:, :, 0].to(c.dtype),
                               c[b, :, idx])


def decode_partial(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                   pos, start: int, window: int = 0) -> torch.Tensor:
    """Partial softmax attention of decode tokens over a span of the
    cache. q (B, H, D) one token's queries or (B, H, C, D) a chunk's, H a
    multiple of kc's heads (the GQA group folds into the query as in the
    one-device `_dense_decode_attn`); kc, vc (B, Hkv, S_loc, D) hold
    global positions [start, start + S_loc); pos a python int or a (B,)
    tensor, token c's causal limit pos + c; `window` > 0 also masks the
    columns at or before pos + c - window (a sliding-window layer), on
    global columns. Returns (B, H, D + 2) f32, (B, H, C, D + 2) for a
    chunk: the unnormalised output sum_j e_j v_j, the row max m over the
    visible columns (NEG_INF where none is visible) and l = sum_j e_j,
    with e_j = exp(s_j - m)."""
    chunk = q.ndim == 4
    qc = q if chunk else q[:, :, None]
    b, h, cdim, d = qc.shape
    hkv, n = kc.shape[1], kc.shape[2]
    qg = qc.reshape(b, hkv, h // hkv, cdim, d)
    s = torch.einsum("bkgcd,bksd->bkgcs", qg.float(), kc.float()) \
        * (d**-0.5)
    limit = torch.arange(cdim, device=q.device)[:, None]  # (C, 1)
    limit = (limit + pos if not torch.is_tensor(pos)
             else limit + pos[:, None, None, None, None])
    idx = start + torch.arange(n, device=q.device)
    ok = idx <= limit
    if window:
        ok = ok & (idx > limit - window)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    o = torch.einsum("bkgcs,bksd->bkgcd", e, vc.float())
    out = torch.cat([o, m, e.sum(dim=-1, keepdim=True)], dim=-1)
    out = out.reshape(b, h, cdim, d + 2)
    return out if chunk else out[:, :, 0]


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


def gather_axes(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    """Every rank's x over `axes`, (ranks, *x.shape) in rank order (the
    first axis major); x[None] over no axis."""
    out = x[None]
    for axis in reversed(tuple(axes)):
        out = _gather(out, axis, mesh)
        out = out.reshape((-1,) + x.shape)
    return out


def gather_spans(x: torch.Tensor, lay: KVLayout) -> torch.Tensor:
    """Every span's x over the sequence axes, (seq_parts, *x.shape) in span
    order (the first axis major)."""
    return gather_axes(x, lay.seq_axes, lay.mesh)


def sharded_decode_attn(q: torch.Tensor, kc: torch.Tensor,
                        vc: torch.Tensor, pos, lay: KVLayout, length: int,
                        window: int = 0) -> torch.Tensor:
    """Decode attention of this rank's query heads q (B, H_loc, D), or a
    chunk's (B, H_loc, C, D) with token c at pos + c, over its part of
    the cache kc, vc (B, Hkv_c, S_loc, D) of a `length`-position cache
    under `lay`, whose sequence is split over at least one axis. Returns
    (B, H_loc, D) f32 for this rank's heads ((B, H_loc, C, D) for a
    chunk).

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


# --------------------------------------------------------------------------
# decode-time SLA over the mesh
# --------------------------------------------------------------------------
def _spec_axes(entry) -> Tuple[str, ...]:
    return () if entry is None else sharding._axes(entry)


def _axes_index(axes, mesh) -> Tuple[int, int]:
    """(ranks, this rank's index) over `axes`, the first axis major; (1, 0)
    over no axis, with or without a mesh."""
    parts, index = 1, 0
    if not axes:
        return parts, index
    sizes = sharding.axis_sizes(mesh)
    for axis in axes:
        parts *= sizes[axis]
        index = index * sizes[axis] + mesh.get_local_rank(axis)
    return parts, index


def reshard(x: torch.Tensor, have, want, mesh) -> torch.Tensor:
    """x, laid out by `have` (one spec entry a dim of x: the axes that dim
    is split over, or None), as laid out by `want`: every dim `have`
    splits is all-gathered over its axes (rank order, the first axis
    major), then every dim `want` splits is cut to this rank's part (all
    the gathers first: a dim cut over an axis another dim is gathered over
    would gather other ranks' cuts). The identity where the two agree."""
    moved = [dim for dim in range(x.ndim)
             if _spec_axes(have[dim]) != _spec_axes(want[dim])]
    for dim in moved:
        for axis in reversed(_spec_axes(have[dim])):
            x = torch.cat(list(_gather(x, axis, mesh)), dim=dim)
    for dim in moved:
        w = _spec_axes(want[dim])
        if w:
            parts, index = _axes_index(w, mesh)
            n = x.shape[dim] // parts
            x = x.narrow(dim, index * n, n)
    return x


def read_row(x: torch.Tensor, dim: int, row, have, mesh) -> torch.Tensor:
    """Global index `row` of dim `dim` of x, whose dim is split over the
    axes `have` (a spec entry): the owner's entry, gathered to every rank
    of those axes. `row` a python int, or a (B,) tensor of one index a
    batch row (dim 0 of x, dim > 0): each row's own entry, (B, ...)
    without `dim`; x.select(dim, row) (or each row's select) where the
    dim is whole."""
    axes = _spec_axes(have)
    n = x.shape[dim]
    if torch.is_tensor(row):
        b = torch.arange(x.shape[0], device=x.device)
        xt, row = x.movedim(dim, 1), row.long()
        if not axes:
            return xt[b, row]
        _, index = _axes_index(axes, mesh)
        mine = xt[b, (row - index * n).clamp(0, n - 1)]
        return gather_axes(mine, axes, mesh)[row // n, b]
    if not axes:
        return x.select(dim, row)
    _, index = _axes_index(axes, mesh)
    mine = x.select(dim, min(max(row - index * n, 0), n - 1))
    return gather_axes(mine, axes, mesh)[row // n]


def put_row(live: torch.Tensor, one: torch.Tensor, row: int, have, want,
            mesh) -> None:
    """Write `one` (1, ...), laid out by `have` (one spec entry a dim, its
    first dim whole), into global index `row` of dim 0 of `live`, laid out
    by `want`, in place: `one` is moved to `want`'s placement of the other
    dims (`reshard`), and the ranks whose part of dim 0 holds `row`
    write it."""
    one = reshard(one, have, (None,) + tuple(want[1:]), mesh)
    _, index = _axes_index(_spec_axes(want[0]), mesh)
    n = live.shape[0]
    if index * n <= row < (index + 1) * n:
        live[row - index * n] = one[0].to(live.dtype)


def _full_spec(spec, ndim: int) -> tuple:
    """A leaf's spec, one entry a dim (None where whole)."""
    spec = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return tuple(None if e is None or e == () else e for e in spec)


class SLAParts:
    """Where this rank's part of each leaf of a decode-time SLA state
    sits: `spec[name]` is the leaf's spec under `cache_shardings` without
    its layer dim, `start(name, dim)` this rank's first index along a dim
    of one layer's leaf. `batch` is the split of the rows a decode step
    computes ("data" under data parallelism, None when every rank holds
    the whole batch), `heads` the query heads' ("model"), `kv_heads` the
    K/V's. `shapes` are the leaves' global shapes, {name: shape}; the
    plan's leaves are named "plan/<field>". Without a layout (`kl` None:
    no mesh) every leaf is whole, so every move between placements is the
    identity and no collective runs.

    Built per call from the layout: it holds the layout's mesh, whose
    process groups end with the group that made them."""

    def __init__(self, kl: Optional[KVLayout], shapes: Dict[str, tuple],
                 global_batch: int):
        self.kl = kl
        self.mesh = None if kl is None else kl.mesh
        self.shapes = {n: tuple(s) for n, s in shapes.items()}
        if kl is None:
            self.local = dict(self.shapes)
            self.full = {n: (None,) * len(s) for n, s in self.shapes.items()}
            self.spec = {n: f[1:] for n, f in self.full.items()}
            self.batch = self.heads = self.kv_heads = None
            return
        metas = {n: torch.empty(s, device="meta") for n, s in shapes.items()}
        rules = sharding.cache_shardings(self.mesh, metas, global_batch)
        self.local = {n: rules[n].shard_shape(s) for n, s in shapes.items()}
        self.full = {n: _full_spec(rules[n].spec, len(s))
                     for n, s in shapes.items()}
        self.spec = {n: f[1:] for n, f in self.full.items()}
        self.batch = "data" if kl.dp > 1 else None
        self.heads = "model"
        self.kv_heads = kl.spec[2]

    def start(self, name: str, dim: int) -> int:
        parts, index = _axes_index(_spec_axes(self.spec[name][dim]),
                                   self.mesh)
        return index * (self.shapes[name][dim + 1] // parts)

    def to_leaf(self, name: str, x: torch.Tensor, have,
                stacked: bool = False) -> torch.Tensor:
        """x (one layer's worth, or every layer's with `stacked`, laid out
        by `have` on the per-layer dims) at the leaf's placement."""
        lead = (None,) if stacked else ()
        return reshard(x, lead + tuple(have), lead + self.spec[name],
                       self.mesh)

    def from_leaf(self, name: str, x: torch.Tensor, want) -> torch.Tensor:
        """One layer's local leaf x laid out by `want`."""
        return reshard(x, self.spec[name], want, self.mesh)

    def slot_rows(self, name: str, leaf: torch.Tensor) -> torch.Tensor:
        """A per-slot counter leaf (L, B), whose layers the rule may split
        over the data axes, as every layer at the batch rows this rank
        decodes (`batch`): the leaf itself without a mesh."""
        return reshard(leaf, self.full[name], (None, self.batch), self.mesh)

    def put_slot_rows(self, name: str, leaf: torch.Tensor,
                      rows: torch.Tensor) -> None:
        """Write `slot_rows`' (L, B_rows) back into the leaf, in place."""
        if rows is not leaf:
            leaf.copy_(reshard(rows, (None, self.batch), self.full[name],
                               self.mesh))
