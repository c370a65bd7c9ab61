"""AdamW with global-norm clipping and schedules.

Counterpart of `repro.optim.adamw`. Parameters, gradients and moments are
dicts keyed by PyTorch parameter name (`dict(model.named_parameters())`,
`layers.3.sla_proj`), where the reference keys its pytree by path
(`['layers']['sla_proj']`, stacked over layers); the same name substrings
select the same leaves. Unlike the reference's functional update,
`update` writes the new parameters and moments in place: at full width
that saves a second copy of the parameters and both moments.

Over a mesh the parameters, gradients and moments are DTensors of the
same placements (`distributed.sharding`): the update runs on each rank's
local shards, and `global_norm` sums the squares of every shard once
over all ranks, so every rank clips by the same global norm (a per-rank
norm would make the ranks' updates diverge).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import local as _local

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"  # cosine | linear | constant


def schedule_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at `step` (a tensor), in f32 as the reference."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - frac
    else:
        decay = torch.ones_like(frac)
    return cfg.lr * warm * decay


def init(params: Mapping[str, torch.Tensor]) -> dict:
    """Zero f32 moments shaped (and, over a mesh, placed) like each
    parameter, and step 0 (a plain tensor, the same on every rank)."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)
    device = _local(next(iter(params.values()))).device
    return {"m": {n: zeros(p) for n, p in params.items()},
            "v": {n: zeros(p) for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _owned(x) -> bool:
    """Whether this rank counts a DTensor's local shard in a global sum:
    the copy at coordinate 0 of every mesh dim that replicates it."""
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    return all(mesh.get_local_rank(i) == 0
               for i, pl in enumerate(x.placements)
               if isinstance(pl, Replicate))


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32. DTensors over
    a mesh: each rank sums the shards it owns and the sum is all-reduced
    over the world, so every rank gets the global norm."""
    from torch.distributed.tensor import DTensor
    tensors = list(tensors)
    mesh = next((x.device_mesh for x in tensors if isinstance(x, DTensor)),
                None)
    if mesh is None:
        sq = sum(torch.sum(torch.square(x.float())) for x in tensors)
        return torch.sqrt(torch.as_tensor(sq, dtype=torch.float32))
    sq = sum(torch.sum(torch.square(x.to_local().float())) if _owned(x)
             else torch.zeros((), dtype=torch.float32,
                              device=x.to_local().device)
             for x in tensors)
    sq = torch.as_tensor(sq, dtype=torch.float32).clone()
    dist.all_reduce(sq)
    return torch.sqrt(sq)


def trainable_mask(params: Mapping[str, torch.Tensor], substrings
                   ) -> Dict[str, bool]:
    """True for each parameter whose name contains any of `substrings`
    (e.g. ("routing", "sla_proj"): the fixed-FLOP fine-tuning recipe that
    trains only the SLA merge and the learned routing head). Feed to
    `update(..., trainable=)`."""
    subs = tuple(substrings)
    return {name: any(s in name for s in subs) for name in params}


@torch.no_grad()
def update(params: Mapping[str, torch.Tensor],
           grads: Mapping[str, torch.Tensor], state: dict, cfg: AdamWConfig,
           trainable: Optional[Mapping[str, bool]] = None
           ) -> Tuple[Mapping[str, torch.Tensor], dict, dict]:
    """One AdamW step, in place. Returns (params, state, metrics) with
    metrics {"grad_norm", "lr"}.

    `trainable`: optional name -> bool (see `trainable_mask`). Frozen
    parameters keep their values AND moments untouched, so a later full
    fine-tune resumes from clean moment state. Gradient clipping (and the
    reported grad_norm) covers ONLY the trainable parameters: the step
    size of a selective fine-tune must not depend on gradient mass that
    flows into parameters that are never updated."""
    names = [n for n in params if trainable is None or trainable[n]]
    step = state["step"] + 1
    gnorm = global_norm(grads[n] for n in names)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = schedule_lr(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)
    for n in names:
        p, m, v = (_local(t) for t in (params[n], state["m"][n],
                                       state["v"][n]))
        g = _local(grads[n]).float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        step_p = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * step_p)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
