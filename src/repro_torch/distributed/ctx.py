"""Activation-sharding context, the mesh hooks of the models, and remat.

Counterpart of `repro.distributed.ctx`. `activation_sharding(mesh,
residual, remat)` scopes a training step. With `remat=True` each layer
wrapped in `maybe_remat(fn)` is rematerialized: its activations are
dropped after the forward and recomputed in the backward
(`torch.utils.checkpoint`, non-reentrant), the memory policy that lets a
full-width Wan2.1 training step fit one card.

With a DeviceMesh, the models' hooks run the reference's sharding rules
(`distributed/sharding.py`) by hand. The residual stream lives on plain
local tensors: this rank's rows of the global batch over the dp axes, or
its rows of the sequence over "data" (context parallelism), and the full
d_model on every "model" rank (the reference's residual spec shards
d_model over "model" as well; the port keeps it whole, Megatron TP
without sequence parallelism, so `shard_residual` is the identity).
  * `fsdp_gather(w, kind)` is the one place a stored DTensor weight
    becomes a plain tensor: all-gathered over the data axes to this
    rank's tensor-parallel slice, its gradient reduce-scattered back to
    the stored shards.
  * `to_tp(x)` enters the tensor-parallel region (identity; the input
    gradient is all-reduced over "model"), `from_tp(x)` leaves it after a
    row-parallel matmul (all-reduce over "model"; identity backward).
  * `batch_rows`, `seq_rows`, `gather_seq` and `sum_data` give the data
    axis's slices, the whole sequence for attention under context
    parallelism, and the loss's sums over the data ranks;
    `gather_tokens` the global (B, S) order of a per-token tensor (the
    MoE router's capacity decisions).
  * `halo` and `carry_in` pass the recurrent families' state along the
    sequence under context parallelism: the previous rank's last rows (a
    conv tail, a token shift) and the scan state entering this rank.
  * `sum_model` sums a statistic whose width is split over "model" (the
    Mamba2 output norm's sum of squares).
  * `ep_gather` and `shard_expert_buf` give the MoE layer this rank's
    experts (expert parallelism over "model").
  * `vocab_shard` and `vocab_lookup` read a table stored with its
    vocabulary over "model" (`embed`, `unembed`) as this rank's rows
    only: the token lookup and the loss's logits are vocab-parallel.
  * serving: `seq_last` gives every rank the prefill's last hidden row
    under context parallelism (`last_span` any tensor of the last data
    rank's, such as a recurrent state), `gather_model` every "model"
    rank's part of a tensor, `replicated_tokens` scopes a decode step
    whose tokens every data rank holds whole (the cache's sequence split
    over "data": `distributed/serving.py`), `gather_batch` every data
    rank's rows of a per-row tensor, and `min_over_ranks` is the drift
    gate's MIN over the ranks that hold the rest of a decision.
Every hook is the identity without a mesh. Over a mesh, one with axes of
size 1 included, the hooks run their collectives; over one rank each of
them is the identity on the values, so the 1 x 1 mesh path computes what
the plain path does. The context holds for a layer's rematerializing
recompute too: `maybe_remat` carries it into the backward.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import sharding


@dataclasses.dataclass(frozen=True)
class ActivationSharding:
    mesh: Any
    residual: tuple = ()  # spec of the (B, S, D) residual stream
    remat: bool = True
    replicated: bool = False  # the tokens are whole on every data rank

    @functools.cached_property
    def layout(self) -> Optional["Layout"]:
        return None if self.mesh is None else Layout(
            self.mesh, self.residual, self.replicated)


class Layout:
    """What the hooks need of a mesh and a residual spec: this rank's
    place on the data and model axes and their process groups. With
    `replicated` (`replicated_tokens`), every data rank holds every token
    of the call: the hooks over the data axes are the identity (no data
    group), as in a decode step under context parallelism."""

    def __init__(self, mesh, residual: tuple, replicated: bool = False):
        self.mesh = mesh
        sizes = sharding.axis_sizes(mesh)
        res = tuple(residual) + (None,) * 3
        batch_axes = sharding._axes(res[0]) if res[0] is not None else ()
        self.cp = res[1] == "data" and not replicated
        split = batch_axes + (("data",) if self.cp else ())
        for axis, size in sizes.items():
            if (axis != "model" and size > 1 and axis not in split
                    and not replicated):
                raise NotImplementedError(
                    f"mesh axis {axis!r} of size {size} splits neither the "
                    f"batch nor the sequence (residual spec {residual!r}): "
                    f"replicated compute over a data axis is not ported")
        if len(batch_axes) > 1 or batch_axes not in ((), ("data",)):
            raise NotImplementedError(
                f"batch over {batch_axes!r}: the port runs data "
                f"parallelism over the 'data' axis only")
        self.data = sizes.get("data", 1)
        self.model = sizes.get("model", 1)
        self.dp = self.data if batch_axes else 1
        self.seq = self.data if self.cp else 1
        self.data_rank = self._rank("data")
        self.model_rank = self._rank("model")
        self.data_group = None if replicated else self._group("data")
        self.model_group = self._group("model")

    def _rank(self, axis: str) -> int:
        if axis not in self.mesh.mesh_dim_names:
            return 0
        return self.mesh.get_local_rank(axis)

    def _group(self, axis: str):
        if axis not in self.mesh.mesh_dim_names:
            return None
        return self.mesh.get_group(axis)


_CTX: contextvars.ContextVar[Optional[ActivationSharding]] = \
    contextvars.ContextVar("activation_sharding", default=None)


@contextlib.contextmanager
def activation_sharding(mesh=None, residual=None, remat: bool = True):
    """Scope of a training step: the mesh (None: one device), the
    residual stream's spec (`default_residual_spec`) and the remat
    policy."""
    token = _CTX.set(ActivationSharding(mesh, tuple(residual or ()), remat))
    try:
        yield
    finally:
        _CTX.reset(token)


@contextlib.contextmanager
def replicated_tokens():
    """Scope of a call whose tokens every data rank holds whole (a decode
    step under context parallelism: one token a row, the cache's sequence
    split over "data"): the batch and sequence hooks and the data-axis
    sums are the identity in it; the "model" hooks are unchanged."""
    c = _CTX.get()
    token = _CTX.set(c if c is None or c.mesh is None
                     else dataclasses.replace(c, replicated=True))
    try:
        yield
    finally:
        _CTX.reset(token)


def default_residual_spec(mesh, global_batch: int, seq_len: int) -> tuple:
    dp = sharding.pick_dp_axes(mesh, global_batch)
    if dp:
        return (dp, None, "model")
    if seq_len % sharding.axis_sizes(mesh).get("data", 1) == 0:
        return (None, "data", "model")  # context parallelism
    return ()


def layout() -> Optional[Layout]:
    """The active mesh's layout, or None without a mesh."""
    c = _CTX.get()
    return None if c is None else c.layout


def shard_residual(x: torch.Tensor) -> torch.Tensor:
    """Sharding constraint on the residual stream: the identity (its
    layout is set once, where the batch is sliced; see the module
    docstring)."""
    return x


# --------------------------------------------------------------------------
# collectives with the adjoints the Megatron pairing needs
# --------------------------------------------------------------------------
def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


class _ToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _FromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBoth(torch.autograd.Function):
    """All-reduce forward and backward: a sum over ranks that each use
    for their own part (the gradient of each rank's share is every
    rank's gradient of the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Halo(torch.autograd.Function):
    """The previous rank's `tail` (zeros on rank 0); the backward sends
    each rank's gradient to the rank whose tail it read."""

    @staticmethod
    def forward(ctx, tail, group, rank, size):
        ctx.group, ctx.rank, ctx.size = group, rank, size
        parts = [torch.empty_like(tail) for _ in range(size)]
        dist.all_gather(parts, tail.contiguous(), group=group)
        return parts[rank - 1] if rank else torch.zeros_like(tail)

    @staticmethod
    def backward(ctx, g):
        parts = [torch.empty_like(g) for _ in range(ctx.size)]
        dist.all_gather(parts, g.contiguous(), group=ctx.group)
        nxt = ctx.rank + 1
        return (parts[nxt] if nxt < ctx.size else torch.zeros_like(g),
                None, None, None)


class _GatherSeq(torch.autograd.Function):
    """All-gather along `dim` over the data group; the backward sums every
    rank's gradient of the whole and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, dim, group, rank, size):
        ctx.dim, ctx.group, ctx.rank, ctx.size = dim, group, rank, size
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g, ctx.group)
        n = g.shape[ctx.dim] // ctx.size
        return g.narrow(ctx.dim, ctx.rank * n, n), None, None, None, None


def to_tp(x: torch.Tensor, group=None) -> torch.Tensor:
    """Enter the tensor-parallel region: the identity forward; backward,
    the input gradient (each "model" rank's share from its own heads,
    columns or vocabulary rows) is all-reduced over "model" (`group`, by
    default the active mesh's)."""
    if group is None:
        lay = layout()
        group = None if lay is None else lay.model_group
    if group is None:
        return x
    return _ToTP.apply(x, group)


def from_tp(x: torch.Tensor) -> torch.Tensor:
    """Leave the tensor-parallel region: sum the row-parallel partial
    products over "model"; the gradient passes through."""
    lay = layout()
    if lay is None or lay.model_group is None:
        return x
    return _FromTP.apply(x, lay.model_group)


def sum_data(x: torch.Tensor) -> torch.Tensor:
    """Sum of a loss term over the data ranks (each holds its own rows);
    the gradient passes through, so each rank's backward covers its own
    rows and the parameters' gradient reductions sum them."""
    lay = layout()
    if lay is None or lay.data_group is None:
        return x
    return _FromTP.apply(x, lay.data_group)


def batch_rows(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """This rank's rows (dim 0) of a global batch tensor under data
    parallelism; the tensor itself otherwise."""
    lay = layout()
    if t is None or lay is None or lay.dp == 1:
        return t
    n = t.shape[0] // lay.dp
    return t[lay.data_rank * n:(lay.data_rank + 1) * n]


def seq_span(seq_len: int) -> tuple:
    """(first row, rows) of this rank's part of a sequence of `seq_len`
    under context parallelism; (0, seq_len) otherwise."""
    lay = layout()
    if lay is None or lay.seq == 1:
        return 0, seq_len
    if seq_len % lay.seq:
        raise ValueError(f"context parallelism over {lay.seq} ranks needs "
                         f"a sequence length they divide (got {seq_len})")
    n = seq_len // lay.seq
    return lay.data_rank * n, n


def seq_rows(x: Optional[torch.Tensor], dim: int = 1
             ) -> Optional[torch.Tensor]:
    """This rank's contiguous rows of `x` along `dim` under context
    parallelism; `x` otherwise."""
    if x is None:
        return x
    start, n = seq_span(x.shape[dim])
    if n == x.shape[dim]:
        return x
    return x.narrow(dim, start, n)


def gather_seq(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The whole sequence of `x` along `dim` (every rank's rows, in
    order) under context parallelism; `x` otherwise. SLA planning ranks
    KV blocks over every query row, so attention plans and attends on the
    whole sequence and each rank keeps its own rows (`seq_rows`)."""
    lay = layout()
    if lay is None or lay.seq == 1:
        return x
    return _GatherSeq.apply(x, dim, lay.data_group, lay.data_rank, lay.seq)


def gather_tokens(t: torch.Tensor) -> torch.Tensor:
    """A per-token tensor (B_loc, S_loc, ...) of this rank as the global
    (B, S, ...): every data rank's rows in the global (b, s) order, its
    batch rows under data parallelism, its sequence rows under context
    parallelism; `t` without a mesh. `local_tokens` takes this rank's
    part back. The forward is an all-gather over "data" (every rank
    calls it, a data axis of 1 included); for integer data (expert ids)."""
    lay = layout()
    if lay is None or lay.data_group is None:
        return t
    return _GatherSeq.apply(t, 1 if lay.cp else 0, lay.data_group,
                            lay.data_rank, lay.data)


def local_tokens(t: torch.Tensor) -> torch.Tensor:
    """This rank's part of a global (B, S, ...) tensor (`gather_tokens`'s
    inverse): its batch rows, then its sequence rows."""
    return seq_rows(batch_rows(t))


def halo(x: torch.Tensor, rows: int) -> Optional[torch.Tensor]:
    """Under context parallelism, the previous data rank's last `rows`
    rows of x (B, S_loc, ...) along dim 1, zeros on rank 0: what a causal
    conv's tail or a token shift reads across the rank boundary. Its
    gradient goes back to the rank that holds those rows. None otherwise
    (the sequence starts here: the caller's zeros)."""
    lay = layout()
    if lay is None or lay.seq == 1:
        return None
    if x.shape[1] < rows:
        raise ValueError(f"a halo of {rows} rows needs as many rows on "
                         f"each rank (got {x.shape[1]})")
    return _Halo.apply(x[:, x.shape[1] - rows:], lay.data_group,
                       lay.data_rank, lay.seq)


def carry_in(end_state: torch.Tensor, log_decay: torch.Tensor
             ) -> torch.Tensor:
    """The decayed scan's state entering this rank's first row under
    context parallelism. Every rank passes the state its rows leave from
    a zero start (B, H, Dk, Dv) and their total log decay (B, H, Dk) per
    key column, or (B, H) per head; both are all-gathered over "data" and
    folded in rank order: s <- exp(decay_j) s + end_j for each rank j
    before this one (zeros on rank 0). Differentiable: each rank's
    gradient of its (end state, decay) sums over the ranks after it.
    Every rank folds the states entering every rank and keeps its own,
    so each one's backward reaches the gathers' (their all-reduces are
    collectives: rank 0 must join them too)."""
    lay = layout()
    ends = _GatherSeq.apply(end_state[None], 0, lay.data_group,
                            lay.data_rank, lay.seq)
    decays = _GatherSeq.apply(log_decay.float()[None], 0, lay.data_group,
                              lay.data_rank, lay.seq)
    s = torch.zeros_like(end_state)
    entering = [s]
    for j in range(lay.seq - 1):
        d = torch.exp(decays[j])
        s = d.reshape(d.shape + (1,) * (s.ndim - d.ndim)) * s + ends[j]
        entering.append(s)
    return torch.stack(entering)[lay.data_rank]


def last_span(t: torch.Tensor) -> torch.Tensor:
    """Under context parallelism the last data rank's `t`, all-gathered so
    every data rank holds its bits (what the whole sequence leaves: a
    scan's end state, a conv tail, a token shift); `t` otherwise.
    Inference only."""
    lay = layout()
    if lay is None or lay.seq == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(lay.seq)]
    dist.all_gather(parts, t.contiguous(), group=lay.data_group)
    return parts[-1]


def seq_last(x: torch.Tensor) -> torch.Tensor:
    """x[:, -1] of the whole sequence: under context parallelism the last
    data rank's last row, all-gathered so every rank holds it (the
    prefill's last hidden state); x[:, -1] otherwise. Inference only."""
    return last_span(x[:, -1])


def gather_batch(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every data rank's rows of a per-row tensor along `dim`, in rank
    order, under data parallelism (`batch_rows`' inverse: each rank's
    per-row drift decisions as the global batch's); `t` otherwise, where
    every data rank holds every row. Inference only."""
    lay = layout()
    if lay is None or lay.dp == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(lay.dp)]
    dist.all_gather(parts, t.contiguous(), group=lay.data_group)
    return torch.cat(parts, dim=dim)


def gather_model(t: torch.Tensor) -> list:
    """Every "model" rank's `t`, in rank order ([t] without a mesh or
    with a "model" axis of 1). Inference only."""
    lay = layout()
    if lay is None or lay.model == 1:
        return [t]
    parts = [torch.empty_like(t) for _ in range(lay.model)]
    dist.all_gather(parts, t.contiguous(), group=lay.model_group)
    return parts


def seq_parallel() -> bool:
    """Whether the sequence is split over "data" (context parallelism)."""
    lay = layout()
    return lay is not None and lay.seq > 1


def sum_model(x: torch.Tensor) -> torch.Tensor:
    """Sum over "model" of a statistic each rank takes of its own columns
    (a norm's sum of squares over a width split by heads), used by every
    rank for its own columns: all-reduced forward and backward. The
    identity without a mesh."""
    lay = layout()
    if lay is None or lay.model_group is None:
        return x
    return _SumBoth.apply(x, lay.model_group)


def model_rank_size() -> tuple:
    """(rank, size) of this process on the "model" axis; (0, 1) without
    a mesh."""
    lay = layout()
    return (0, 1) if lay is None else (lay.model_rank, lay.model)


def min_over_ranks(x: torch.Tensor, heads: bool = True,
                   batch: bool = True) -> torch.Tensor:
    """The elementwise MIN of x (a drift gate's retention) over the ranks
    that hold the rest of its decision: with `heads`, the "model" ranks,
    which hold the other query heads of this rank's rows; with `batch`
    and the batch split over "data" (data parallelism), the data ranks
    that hold the other rows (a batch-wide decision). Under context
    parallelism every data rank plans the same rows, so no data rank is
    crossed. Exact in any order, so every rank that holds a row takes the
    same decision for it. x without a mesh. Inference only."""
    lay = layout()
    if lay is None:
        return x
    groups = []
    if heads and lay.model_group is not None:
        groups.append(lay.model_group)
    if batch and lay.dp > 1 and lay.data_group is not None:
        groups.append(lay.data_group)
    for group in groups:
        x = x.contiguous().clone()
        dist.all_reduce(x, op=dist.ReduceOp.MIN, group=group)
    return x


def require_unsharded(what: str) -> None:
    """Raise when a path the mesh does not run is called under a mesh of
    more than one rank."""
    lay = layout()
    if lay is not None and lay.mesh.size() > 1:
        raise NotImplementedError(
            f"{what} is not ported to a mesh of more than one rank")


# --------------------------------------------------------------------------
# weights
# --------------------------------------------------------------------------
def fsdp_gather(w, kind: str, chunks: int = 1) -> torch.Tensor:
    """Per-layer FSDP weight gather (MaxText-style): a parameter STORED
    sharded over ("data" x "model") as a DTensor becomes the plain local
    tensor this rank computes with, gathered over the data axes; the
    gradient is reduce-scattered back to the stored shards (Partial over
    the data axes: each data rank's rows contribute).

    kind, for the "model" axis:
      "col"  (in, out_tp): this rank's columns (heads / FFN columns);
             `chunks` equal column blocks (mlp_wi's gate and up halves)
             are sliced one by one, so `.chunk(chunks, -1)` of the local
             product gives this rank's part of each;
      "row"  (in_tp, ...): this rank's rows of dim 0 (wo's heads, the
             per-head sla_proj and routing projections);
      "tp"   the whole tensor, read inside the tensor-parallel region
             (different heads per rank: its gradient sums over "model");
      "rep"  the whole tensor, read alike on every "model" rank (norm
             scales, embeddings, the DiT's modulation and patch
             projections: its gradient is the same on every rank).
    A plain tensor (no mesh) is returned as it is."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(w, DTensor):
        return w
    mesh = w.device_mesh
    names = mesh.mesh_dim_names
    dim = w.ndim - 1 if kind == "col" else 0
    m = sharding.axis_sizes(mesh).get("model", 1)
    stored = w.placements[names.index("model")] if "model" in names \
        else Replicate()
    fast = kind in ("col", "row") and chunks == 1 and stored == Shard(dim)
    targets, grads = [], []
    for name in names:
        if name != "model":
            targets.append(Replicate())
            grads.append(Partial())
        elif fast:
            targets.append(Shard(dim))
            grads.append(Shard(dim))
        else:
            targets.append(Replicate())
            grads.append(Replicate() if kind == "rep" else Partial())
    local = w.redistribute(mesh, targets).to_local(grad_placements=grads)
    if fast or kind in ("tp", "rep"):
        return local
    r = mesh.get_local_rank("model")
    size = local.shape[dim] // (chunks * m)
    blocks = [local.narrow(dim, (c * m + r) * size, size)
              for c in range(chunks)]
    return blocks[0] if chunks == 1 else torch.cat(blocks, dim=dim)


def vocab_shard(w) -> tuple:
    """(rows, first, group) of a (V, d) table stored with its vocabulary
    over "model" (`embed`, `unembed`): this rank's rows, gathered over the
    data axes (`fsdp_gather(w, "row")`), the vocabulary id of the first,
    and the "model" group that holds the other rows (Megatron's
    vocab-parallel embedding and loss: no rank gathers the whole table).
    A table the rules keep whole over "model" (a vocabulary "model" does
    not divide) is gathered whole, group None; a plain tensor is returned
    as it is."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(w, DTensor):
        return w, 0, None
    mesh = w.device_mesh
    names = mesh.mesh_dim_names
    if "model" not in names or \
            w.placements[names.index("model")] != Shard(0):
        return fsdp_gather(w, "rep"), 0, None
    rows = fsdp_gather(w, "row")
    return (rows, mesh.get_local_rank("model") * rows.shape[0],
            mesh.get_group("model"))


def vocab_lookup(tokens: torch.Tensor, w) -> torch.Tensor:
    """`F.embedding(tokens, w)` of a table read through `vocab_shard`:
    each "model" rank looks up the ids among its rows (zeros for the
    others) and the sum over "model" holds every id's row; its gradient
    reaches only the rows of the ids this rank holds. (`F.embedding`: its
    backward is deterministic, an index's is not.)"""
    import torch.nn.functional as F
    rows, first, group = vocab_shard(w)
    if group is None:
        return F.embedding(tokens, rows)
    idx = tokens - first
    hit = (idx >= 0) & (idx < rows.shape[0])
    emb = F.embedding(idx.clamp(0, rows.shape[0] - 1), rows)
    return _FromTP.apply(torch.where(hit[..., None], emb, 0.0), group)


def ep_gather(w):
    """MoE expert weights (E, d_in, d_out), stored FSDP-sharded on d_in:
    this "model" rank's experts gathered over the data axes (the
    reference's experts-only sharding before the expert matmul); their
    gradient reduce-scattered back. `models/moe.py` runs its expert
    matmuls on them."""
    if getattr(w, "ndim", 0) != 3:
        return w
    return fsdp_gather(w, "row")


def shard_expert_buf(x: torch.Tensor) -> torch.Tensor:
    """This "model" rank's experts' rows of an (E, capacity, d) dispatch
    buffer (the reference constrains it to expert sharding): the rows
    its expert matmuls read in `models/moe.py`."""
    rank, size = model_rank_size()
    if x.ndim != 3 or size == 1 or x.shape[0] % size:
        return x
    n = x.shape[0] // size
    return x[rank * n:(rank + 1) * n]


# --------------------------------------------------------------------------
# remat
# --------------------------------------------------------------------------
def use_remat() -> bool:
    c = _CTX.get()
    return c.remat if c is not None else False


def maybe_remat(fn: Callable) -> Callable:
    """Wrap a layer body with full rematerialization when the context
    asks for it and autograd is recording; otherwise return `fn`. The
    recompute runs in the backward, where this scope has ended (and on
    the card, on another thread): it re-enters the same context."""
    if not use_remat():
        return fn
    state = _CTX.get()

    def scoped(*args):
        token = _CTX.set(state)
        try:
            return fn(*args)
        finally:
            _CTX.reset(token)

    def remat(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(scoped, *args, use_reentrant=False)

    return remat
