"""Sharding rules: parameter, input and cache placements over a
`torch.distributed` DeviceMesh. Counterpart of
`repro.distributed.sharding`.

Strategy, as the reference's:
  * TP over "model": column-parallel in-projections, row-parallel
    out-projections (Megatron pairing), experts (EP), vocab.
  * FSDP/ZeRO-3 over "data": every weight's *other* large dim shards over
    data; the AdamW moments are `zeros_like` the parameters and follow.
  * DP over ("pod", "data") for batches; when the global batch is smaller
    than the dp axes (long_500k: batch 1) the *sequence* axis shards over
    "data" instead (context parallelism).

Rules are keyed by leaf name; a spec describes the TRAILING dims. A spec
is a tuple with one entry per tensor dim, as the reference's
PartitionSpec: None, an axis name, or a tuple of axis names. The
reference stacks a family's layers on a leading axis and pads the spec
with None for it; the port keeps one tensor per layer
(`layers.<l>.<name>`), which takes the same trailing spec without that
dim. `ref_path` maps a port name to the reference's leaf path
(`bridge.params_from_numpy` names the leaves the same way).
`NamedSharding(mesh, spec).placements` gives the `Shard(d)` /
`Replicate()` of each mesh dim, in the mesh's dim order.

How the port executes these rules (`distributed/ctx.py`, the models'
hooks): parameters are STORED as DTensors with the rules' placements
(`place_module`). FSDP2's `fully_shard` would not do: it gathers in
`nn.Module.__call__`, and the port's models run as functions over a
tree of the parameters (`launch.steps.cast_params_bf16`), so its hooks
never fire. The gather is explicit instead, at the reference's hook
points: `ctx.fsdp_gather(w, kind)` redistributes one weight to its
tensor-parallel layout and hands back a plain local tensor whose
gradient is reduce-scattered back to the stored shards. Between the
hooks compute runs on plain local tensors, Megatron style (the kernels
are ctypes calls on `data_ptr()`, so no DTensor may reach them): a
column-parallel matmul leaves this rank's heads local, a row-parallel one
ends in an all-reduce over "model", and the tensor-parallel region's
input gradient is all-reduced in the backward. The vocabulary tables
(`embed`, `unembed`) are read as each "model" rank's rows only
(`ctx.vocab_shard`): the token lookup sums its rows over "model", and
the loss reduces the logits' logsumexp and target logit over "model",
so no rank builds the full-vocabulary logits. Execution covers every
family of the registry (`MESH_FAMILIES`): the MoE layer runs its experts
over "model" (expert parallelism, `models/moe.py`), the recurrent
families their heads, and their scans' state crosses the data ranks
under context parallelism (`ctx.halo`, `ctx.carry_in`).
`check_mesh_family` refuses a "model" axis that does not divide what a
family splits over it. Serving places the decode caches by
`cache_shardings` (`distributed/serving.py` reads the KV layout from it:
heads over "model", or the sequence over "model" or "data" with a
flash-decoding combine).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

from torch.distributed.tensor import Replicate, Shard

Spec = Tuple

# leaf name -> spec of trailing dims
_PARAM_RULES: Dict[str, Tuple] = {
    # embeddings: vocab over model (TP), d over data (FSDP)
    "embed": ("model", "data"),
    "unembed": ("model", "data"),
    # column-parallel (d_in, d_out_tp)
    "wq": ("data", "model"), "wk": ("data", "model"),
    "wv": ("data", "model"), "wg": ("data", "model"),
    "wr": ("data", "model"), "mlp_wi": ("data", "model"),
    "ck": ("data", "model"), "cr": ("data", "model"),
    "in_proj": ("data", "model"), "xq": ("data", "model"),
    "xk": ("data", "model"), "xv": ("data", "model"),
    "ada": ("data", "model"), "shared_wi": ("data", "model"),
    # row-parallel (d_in_tp, d_out)
    "wo": ("model", "data"), "mlp_wo": ("model", "data"),
    "cv": ("model", "data"), "out_proj": ("model", "data"),
    "xo": ("model", "data"), "shared_wo": ("model", "data"),
    # MoE: experts over model (EP), d over data
    "wi": ("model", "data", None),
    "router": ("data", None),
    # SLA proj / rwkv bonus: heads over model
    "sla_proj": ("model", None, None),
    "u": ("model", None),
    # misc projections
    "patch_in": ("data", None),
    "patch_out": ("data", None),
    "t_embed": (None, "data"),
    "wa": ("data", None),
    "wb": (None, "data"),
    "conv": (None, "model"),
}
# moe wo is (E, ff, d): experts over model
_PARAM_RULES_3D = {
    "wo": ("model", None, "data"),
    "wi": ("model", "data", None),
}

# the families whose models run sharded over a mesh of more than one rank
MESH_FAMILIES = ("dense", "vlm", "dit", "moe", "ssm", "hybrid", "encdec")


def param_spec(path: str, ndim: int) -> Spec:
    name = path.split("/")[-1]
    in_moe = "/moe/" in path or path.endswith("moe")
    rules = None
    if in_moe and name in _PARAM_RULES_3D:
        rules = _PARAM_RULES_3D[name]
    elif name in _PARAM_RULES:
        rules = _PARAM_RULES[name]
    if rules is None:
        return ()  # replicate (norm scales etc.)
    if ndim < len(rules):
        # e.g. unstacked variant — drop leading rule dims
        rules = rules[len(rules) - ndim:]
    pad = (None,) * (ndim - len(rules))
    return tuple(pad + tuple(rules))


def ref_path(name: str) -> str:
    """A port parameter name (`layers.3.moe.wo`) as a "/"-joined leaf path
    (`layers/3/moe/wo`): what `param_spec` reads of the reference's paths
    (the leaf name and a `moe` component) is the same in both."""
    return name.replace(".", "/")


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh (or of a mapping given as one)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axes(names) -> Tuple[str, ...]:
    return names if isinstance(names, tuple) else (names,)


def _divisible(spec: Spec, shape, mesh) -> Spec:
    """Drop sharding on dims the mesh doesn't divide (e.g. tiny LoRA dims)."""
    sizes = axis_sizes(mesh)
    fixed = []
    for dim, names in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                          - len(spec))):
        if names is None:
            fixed.append(None)
            continue
        size = 1
        for a in _axes(names):
            size *= sizes[a]
        fixed.append(names if dim % size == 0 and dim >= size else None)
    return tuple(fixed)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh: the port's `jax.sharding.NamedSharding`."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        """Shard(d) or Replicate() for each mesh dim, in the mesh's order."""
        return spec_placements(self.spec, self.mesh.mesh_dim_names)

    def shard_shape(self, shape) -> Tuple[int, ...]:
        """Each rank's shape of a tensor of global `shape` (the rules only
        shard dims their axes divide)."""
        sizes = axis_sizes(self.mesh)
        out = []
        for dim, names in zip(shape, tuple(self.spec) + (None,) * len(shape)):
            for a in (() if names is None else _axes(names)):
                dim //= sizes[a]
            out.append(dim)
        return tuple(out)


def spec_placements(spec: Spec, mesh_dim_names) -> tuple:
    """A spec's placements: the mesh dims it names shard the tensor dim
    that names them; the others replicate."""
    out = []
    for axis in mesh_dim_names:
        dims = [d for d, names in enumerate(spec)
                if names is not None and axis in _axes(names)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def param_shardings(mesh, params_shape: Mapping[str, Any]
                    ) -> Dict[str, NamedSharding]:
    """{port parameter name: NamedSharding} for a mapping of names to
    tensors (meta tensors, or anything with a `.shape`)."""
    out = {}
    for name, leaf in params_shape.items():
        shape = tuple(leaf.shape)
        spec = param_spec(ref_path(name), len(shape))
        out[name] = NamedSharding(mesh, _divisible(spec, shape, mesh))
    return out


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))


def _dp_size(mesh, axes) -> int:
    sizes = axis_sizes(mesh)
    size = 1
    for a in axes:
        size *= sizes[a]
    return size


def pick_dp_axes(mesh, global_batch: int) -> Tuple[str, ...]:
    """Largest dp-axis subset the batch divides: full ("pod","data"),
    then ("data",), then ("pod",). Falling back to a subset keeps
    attention shard-local (the remaining axis becomes pure DP via the
    gradient all-reduce) instead of forcing sequence shards."""
    sizes = axis_sizes(mesh)
    for cand in (dp_axes(mesh), ("data",), ("pod",)):
        cand = tuple(a for a in cand if a in sizes)
        if not cand:
            continue
        size = _dp_size(mesh, cand)
        if global_batch >= size and global_batch % size == 0:
            return cand
    return ()


def batch_shardings(mesh, batch_specs, global_batch: int):
    """Input shardings: batch over the largest dividing dp-axis subset,
    or sequence over 'data' when none fits (context parallelism for
    long_500k). `batch_specs`: a dict of specs (anything with a `.shape`,
    or None, which maps to None), or one such spec."""
    dp = pick_dp_axes(mesh, global_batch)
    dp_size = _dp_size(mesh, dp)
    shard_seq = not dp
    data = axis_sizes(mesh).get("data", 1)

    def one(leaf):
        if leaf is None:
            return None
        shape = tuple(leaf.shape)
        if len(shape) == 0:
            return NamedSharding(mesh, ())
        if shard_seq:
            if len(shape) >= 2 and shape[1] % data == 0:
                spec = (None, "data")
            else:
                spec = ()
        else:
            spec = (dp,) if shape[0] % dp_size == 0 else ()
        return NamedSharding(mesh, _divisible(spec, shape, mesh))

    if isinstance(batch_specs, Mapping):
        return {k: one(v) for k, v in batch_specs.items()}
    return one(batch_specs)


def tree_leaves(tree, prefix: str = ""):
    """(path, leaf) pairs of a nested dict / list / NamedTuple / dataclass
    (a cache with its SLAPlan), the path "/"-joined as the reference's."""
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from tree_leaves(v, f"{prefix}{k}/")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from tree_leaves(getattr(tree, f.name),
                                   f"{prefix}{f.name}/")
    elif hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from tree_leaves(getattr(tree, k), f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def shape_of(leaf) -> Tuple[int, ...]:
    """A leaf's shape; a python scalar (a cache's `pos`) is 0-d."""
    return tuple(getattr(leaf, "shape", ()))


def cache_shardings(mesh, cache_specs, global_batch: int
                    ) -> Dict[str, NamedSharding]:
    """KV/state cache shardings, {leaf path: NamedSharding}. Layout
    (L, B, H, S, D) or (L, B, H, Dk, Dv).

    decode_32k (B=128): batch over dp, heads over model.
    long_500k (B=1):   sequence over data (context-parallel cache),
                       heads over model.

    A 6-d leaf (decode-time SLA's per-block h_j, (L, B, Hkv, Tn, D, D))
    takes the 5-d rule on its first five dims, its last dim whole, so it
    sits where its 5-d sibling z_j (L, B, Hkv, Tn, D) sits. The reference
    leaves it whole on every rank (`P()`, ROADMAP §3 "Differences by
    design").
    """
    dp = pick_dp_axes(mesh, global_batch)
    shard_seq = not dp
    sizes = axis_sizes(mesh)

    def one(name, shape):
        if len(shape) <= 1:
            return NamedSharding(mesh, ())
        if len(shape) == 6:
            lead = one(name, shape[:5]).spec
            spec = tuple(lead) + (None,) * (6 - len(lead))
            return NamedSharding(mesh, spec)
        if len(shape) == 5:  # (L, B, H, S, D) kv cache / (L,B,H,dk,dv) state
            is_state = "state" in name or "ssm" in name
            model_sz = sizes.get("model", 1)
            heads_ok = shape[2] % model_sz == 0 and shape[2] >= model_sz
            if shard_seq and not is_state:
                spec = ((None, None, "model", "data", None) if heads_ok
                        else (None, None, None, ("data", "model"), None))
            elif is_state or heads_ok:
                spec = (None, dp, "model", None, None)
            else:
                # few KV heads (GQA): shard the sequence dim over "model"
                # instead (flash-decoding layout — partial softmax + combine)
                spec = (None, dp, None, "model", None)
        elif len(shape) == 4:  # (L, B, S, D) conv tails etc.
            spec = (None, None if shard_seq else dp, None, None)
        elif len(shape) == 2:
            spec = (None if shard_seq else dp,)
        else:
            spec = ()
        spec = tuple(None if s == () else s for s in spec)
        return NamedSharding(mesh, _divisible(spec, shape, mesh))

    return {name: one(name, shape_of(leaf))
            for name, leaf in tree_leaves(cache_specs)}


def _model_split(cfg) -> Dict[str, int]:
    """{name: size} of what a family splits over "model": its attention
    heads, its recurrence's heads, its experts and its FFN widths."""
    if cfg.family == "ssm":
        return {"rwkv6._heads": cfg.ssm_heads or cfg.num_heads,
                "d_ff": cfg.d_ff}
    out = {"num_heads": cfg.num_heads}
    if cfg.family == "moe":
        out.update(num_experts=cfg.num_experts)
        if cfg.moe_shared_expert:
            out.update(moe_d_ff=cfg.moe_d_ff)
        return out
    if cfg.family == "hybrid":
        out.update(ssm_heads=cfg.ssm_heads)
    out.update(d_ff=cfg.d_ff)
    return out


def check_mesh_family(cfg, mesh) -> None:
    """Refuse a family outside `MESH_FAMILIES`, or a tensor-parallel
    degree that does not divide what the family splits over "model"
    (`_model_split`: the port runs a layer's query heads, experts and FFN
    columns local to each "model" rank, in training and in serving), over
    a mesh of more than one rank, with the reason. Nothing falls back to
    replicated compute."""
    sizes = axis_sizes(mesh)
    world = 1
    for s in sizes.values():
        world *= s
    if world <= 1:
        return
    if cfg.family not in MESH_FAMILIES:
        raise NotImplementedError(
            f"sharded execution of the {cfg.family!r} family is not ported "
            f"to repro_torch")
    m = sizes.get("model", 1)
    bad = {n: v for n, v in _model_split(cfg).items() if v % m}
    if bad:
        raise NotImplementedError(
            f"a 'model' axis of {m} must divide "
            + ", ".join(f"{n} ({v})" for n, v in bad.items())
            + f" to run {cfg.name} tensor-parallel: each 'model' rank "
            f"computes its own query heads, experts and FFN columns, and "
            f"in sharded decode keeps its own query heads after the "
            f"flash-decoding combine; only the KV heads may stay whole, "
            f"the serving cache then splitting its sequence over 'model'")


def full(t):
    """A DTensor's full tensor (a collective: every rank calls it); a
    plain tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def local(t):
    """A DTensor's local shard (its storage, under no_grad); a plain
    tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def place(tensor, sharding: Optional[NamedSharding]):
    """`tensor` (the same full value on every rank) as a DTensor under
    `sharding`, each rank keeping its own shard with no communication;
    None leaves it as it is."""
    if sharding is None:
        return tensor
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(tensor, sharding.mesh, sharding.placements,
                             src_data_rank=None)


def place_module(module, mesh) -> Dict[str, NamedSharding]:
    """Replace every parameter of `module` by a DTensor under the rules
    on `mesh`, in place (each rank holds the same full values, from the
    same seed or checkpoint). Returns the shardings by parameter name."""
    import torch.nn as nn
    shardings = param_shardings(mesh, dict(module.named_parameters()))
    for name, sh in shardings.items():
        owner, _, leaf = name.rpartition(".")
        sub = module.get_submodule(owner) if owner else module
        old = getattr(sub, leaf)
        new = nn.Parameter(place(old.detach(), sh),
                           requires_grad=old.requires_grad)
        if isinstance(sub, nn.ParameterDict):
            sub[leaf] = new
        else:
            setattr(sub, leaf, new)
    return shardings


def opt_shardings(p_shard: Mapping[str, NamedSharding]) -> dict:
    """The AdamW state's shardings: its moments follow the parameters,
    the step is replicated (None: a plain tensor)."""
    return {"m": dict(p_shard), "v": dict(p_shard), "step": None}
