"""Elastic scaling: re-place live training state onto a new mesh.
Counterpart of `repro.distributed.elastic`.

When ranks are lost the job can *remesh*: pick the largest (data',
model') grid that fits the survivors, re-place params and AdamW state
under the rules, and continue (the data pipeline is a pure function of
the global step, so each data group's share of the batch follows).

Two entry points:
  * `remesh(params, opt_state, new_mesh)`: in memory. A DTensor cannot be
    redistributed from one mesh to another, so each leaf goes through its
    full tensor (gathered over the old mesh, which must still span the
    world) and is placed again.
  * checkpoint-based: `CheckpointManager.restore(..., shardings=)` with
    the new mesh's `sharding.param_shardings`.
"""
from __future__ import annotations

from typing import Mapping, Tuple

import torch

from repro_torch.distributed import sharding


def best_mesh_shape(num_devices: int, model_parallel: int) -> Tuple[int, int]:
    """Largest (data, model) grid on the surviving devices, preserving the
    model-parallel degree (params are sharded over it; changing it needs
    a reshard anyway, which we do — but keeping it avoids repadding)."""
    model = model_parallel
    while model > 1 and num_devices % model:
        model //= 2
    data = num_devices // model
    return data, model


@torch.no_grad()
def remesh(params: Mapping[str, torch.Tensor], opt_state: dict, new_mesh
           ) -> Tuple[dict, dict]:
    """(params, opt_state) re-placed under the rules on `new_mesh`:
    name -> DTensor dicts, the moments placed as their parameters, the
    step a plain tensor. Every rank of the world calls it (the gathers are
    collectives)."""
    p_shard = sharding.param_shardings(new_mesh, params)
    new_params = {n: sharding.place(sharding.full(p), p_shard[n])
                  for n, p in params.items()}
    new_opt = {key: {n: sharding.place(sharding.full(t), p_shard[n])
                     for n, t in opt_state[key].items()}
               for key in ("m", "v")}
    new_opt["step"] = sharding.full(opt_state["step"])
    return new_params, new_opt
