"""Carry the JAX package's model params and plans into the port, via numpy.

The JAX package keeps DiT and LM params as nested dicts whose `layers`
leaves are stacked over the layer axis (L, ...); the port keeps one
`DiTLayer` / `TransformerLayer` per layer. `params_from_numpy` unstacks
them into a `state_dict` for `load_state_dict` of `models.dit.DiT` or
`models.transformer.Transformer` (qk-norm, `sla_proj` and the routing
dict included); `plan_from_numpy`
turns a dict of plan leaves into an `SLAPlan`. The caller does the
`np.asarray` on the JAX side: this module imports no JAX.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.plan import PLAN_LEAVES, SLAPlan


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree: Mapping, device=None) -> Dict[str, torch.Tensor]:
    """JAX DiT or LM params (nested dict of numpy arrays) -> the port's
    state_dict. `layers` leaves (L, ...) become `layers.<l>.<name>`; a
    nested dict (the learned-routing head) becomes `<name>.<key>`."""
    dev = resolve_device(device)
    state: Dict[str, torch.Tensor] = {}
    for name, leaf in tree.items():
        if name == "layers":
            continue
        state[name] = _tensor(leaf, dev)
    for name, leaf in tree.get("layers", {}).items():
        sub = leaf.items() if isinstance(leaf, Mapping) else [(None, leaf)]
        for key, arr in sub:
            arr = np.asarray(arr)
            for li in range(arr.shape[0]):
                full = f"layers.{li}.{name}" + ("" if key is None
                                                else f".{key}")
                state[full] = _tensor(arr[li], dev)
    return state


def plan_from_numpy(leaves: Mapping, device=None) -> SLAPlan:
    """Dict of the six plan leaves (numpy arrays, any leading axes) ->
    SLAPlan with the same dtypes."""
    dev = resolve_device(device)
    return SLAPlan(**{name: _tensor(leaves[name], dev)
                      for name in PLAN_LEAVES})
