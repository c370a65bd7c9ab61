"""Carry the JAX package's model params and plans into the port, via numpy.

The JAX package keeps model params as nested dicts whose layer stacks
(`layers`; an encoder-decoder's `enc` and `dec`) are stacked over the
layer axis (L, ...); the port keeps one module per layer in an
`nn.ModuleList`. `params_from_numpy` unstacks them into a `state_dict`
for `load_state_dict` of any ported model (qk-norm, `sla_proj` and the
routing dict included) and flattens unstacked nested dicts (the hybrid's
`shared_attn`, its `routing` inside) into dotted names; `plan_from_numpy`
turns a dict of plan leaves into an `SLAPlan`; `cache_from_numpy` carries
a decode cache (monolithic, per-slot or paged, with or without decode-SLA
state, or a recurrent or encoder-decoder family's) into the port's cache
dict; `train_state_from_checkpoint` reads a step directory written by the
reference's `CheckpointManager` (its `.npy` files) into the port's
parameters and AdamW state. The caller does the `np.asarray` on the JAX
side: this module imports no JAX.
"""
from __future__ import annotations

import json
import pathlib
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.plan import PLAN_LEAVES, SLAPlan


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: exact through f32
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


# the params' layer stacks: leaves (L, ...) of one module per layer
STACKS = ("layers", "enc", "dec")


def _flatten(tree: Mapping, prefix: str = ""):
    """(dotted name, leaf) pairs of a nested dict."""
    for name, leaf in tree.items():
        if isinstance(leaf, Mapping):
            yield from _flatten(leaf, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", leaf


def params_from_numpy(tree: Mapping, device=None) -> Dict[str, torch.Tensor]:
    """JAX model params (nested dict of numpy arrays) -> the port's
    state_dict. A stack's leaves (L, ...) become `<stack>.<l>.<name>`, a
    nested dict's leaves `<name>.<key>` (the learned-routing head, the
    hybrid's unstacked `shared_attn`)."""
    dev = resolve_device(device)
    state: Dict[str, torch.Tensor] = {}
    for name, leaf in tree.items():
        if name not in STACKS:
            if isinstance(leaf, Mapping):
                for full, arr in _flatten(leaf, f"{name}."):
                    state[full] = _tensor(arr, dev)
            else:
                state[name] = _tensor(leaf, dev)
            continue
        for sub, arr in _flatten(leaf):
            arr = np.asarray(arr)
            for li in range(arr.shape[0]):
                state[f"{name}.{li}.{sub}"] = _tensor(arr[li], dev)
    return state


def plan_from_numpy(leaves: Mapping, device=None) -> SLAPlan:
    """Dict of the six plan leaves (numpy arrays, any leading axes) ->
    SLAPlan with the same dtypes."""
    dev = resolve_device(device)
    return SLAPlan(**{name: _tensor(leaves[name], dev)
                      for name in PLAN_LEAVES})


def cache_from_numpy(tree: Mapping, device=None) -> dict:
    """A reference decode cache (nested dict of numpy arrays; its SLAPlan
    as an object with the six plan leaves, or a dict of them) -> the
    port's cache dict, as `prefill`, `make_cache` or `make_paged_cache`
    would hold it. A scalar `pos` (and decode-SLA `rows`) becomes a python
    int; a (B,) `pos` an int32 tensor with its host mirror `pos_host`, and
    (B,) `rows` an int32 tensor. Other leaves keep their dtypes (bf16
    included)."""
    dev = resolve_device(device)
    out: dict = {}
    for key, leaf in tree.items():
        if key == "pos":
            pos = np.asarray(leaf)
            if pos.ndim == 0:
                out["pos"] = int(pos)
            else:
                out["pos"] = _tensor(pos.astype(np.int32), dev)
                out["pos_host"] = pos.astype(np.int64)
        elif key == "sla":
            st = {}
            for name, val in leaf.items():
                if name == "plan":
                    st["plan"] = plan_from_numpy(
                        {n: (val[n] if isinstance(val, Mapping)
                             else getattr(val, n)) for n in PLAN_LEAVES},
                        device=dev)
                elif name == "rows" and np.asarray(val).ndim == 0:
                    st["rows"] = int(np.asarray(val))
                else:
                    st[name] = _tensor(val, dev)
            out["sla"] = st
        elif isinstance(leaf, Mapping):  # the paged partials' pools
            out[key] = {name: _tensor(val, dev) for name, val in leaf.items()}
        else:
            out[key] = _tensor(leaf, dev)
    return out


def train_state_from_checkpoint(step_dir, device=None
                                ) -> Tuple[Dict[str, torch.Tensor], dict]:
    """A reference training checkpoint (`<dir>/step_<N>/` of
    `repro.checkpoint.manager.CheckpointManager`, saved as the reference
    CLI saves `{"params": params, "opt": opt_state}`) -> (the port's
    state_dict, its AdamW state {"m", "v", "step"}). The leaves' paths
    come from the manifest ("__"-joined); params and both moments are
    unstacked by `params_from_numpy`, the step is an int32 scalar."""
    step_dir = pathlib.Path(step_dir)
    leaves = json.loads((step_dir / "manifest.json").read_text())["leaves"]
    tree: dict = {}
    for path in leaves:
        *outer, last = path.split("__")
        node = tree
        for key in outer:
            node = node.setdefault(key, {})
        node[last] = np.load(step_dir / f"{path}.npy")
    dev = resolve_device(device)
    opt = tree["opt"]
    state = {"m": params_from_numpy(opt["m"], dev),
             "v": params_from_numpy(opt["v"], dev),
             "step": _tensor(np.asarray(opt["step"], np.int32), dev)}
    return params_from_numpy(tree["params"], dev), state
