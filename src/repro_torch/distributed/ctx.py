"""Activation-sharding context + remat policy plumbing, on one device.

Counterpart of `repro.distributed.ctx`, remat half. Models call
`shard_residual(x)` between blocks and wrap each layer in
`maybe_remat(fn)`; under `activation_sharding(remat=True)` the layer is
rematerialized: its activations are dropped after the forward and
recomputed in the backward (`torch.utils.checkpoint`, non-reentrant), the
memory policy that lets a full-width Wan2.1 training step fit one card.
Sharding the residual stream over a mesh is not ported: a mesh other
than None raises, and `shard_residual` is the identity.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

_REMAT: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "activation_sharding_remat", default=False)


@contextlib.contextmanager
def activation_sharding(mesh=None, residual=None, remat: bool = True):
    """Scope within which `use_remat()` is `remat`. Only `mesh=None` (one
    device) is ported, so `residual`, the reference's residual-stream
    layout over the mesh, is accepted and unused."""
    if mesh is not None:
        raise NotImplementedError(
            "activation sharding over a device mesh is not ported to "
            "repro_torch yet (ROADMAP.md queue 1, item 16); pass mesh=None")
    token = _REMAT.set(remat)
    try:
        yield
    finally:
        _REMAT.reset(token)


def shard_residual(x: torch.Tensor) -> torch.Tensor:
    """Sharding constraint on the residual stream: the identity on one
    device."""
    return x


def use_remat() -> bool:
    return _REMAT.get()


def maybe_remat(fn: Callable) -> Callable:
    """Wrap a layer body with full rematerialization when the context
    asks for it and autograd is recording; otherwise return `fn`."""
    if not use_remat():
        return fn

    def remat(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False)

    return remat
