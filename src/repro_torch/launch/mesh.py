"""Device meshes over a `torch.distributed` world. Counterpart of
`repro.launch.mesh`.

single-pod: (data=16, model=16) = 256 ranks.
multi-pod:  (pod=2, data=16, model=16) = 512 ranks; the leading "pod"
axis carries only data parallelism.

The production meshes need a world of that size; in practice that is the
fake process group of the dry run (`launch/dryrun.py`), which places
meta tensors and runs no collective. A host mesh covers the launched
world: `torchrun --nproc-per-node N` (one GPU a rank) or, on the CPU, N
processes over gloo.

Defined as FUNCTIONS: importing this module initializes nothing.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def init_distributed(device: Optional[str] = None) -> str:
    """Join the process group `torchrun` (or the caller's environment:
    RANK, WORLD_SIZE and an init method) describes, once; returns the
    mesh's device type. On the card each rank takes the GPU of its
    LOCAL_RANK and the backend is NCCL; on the CPU, gloo."""
    dev = torch.device(device or ("cuda" if torch.cuda.is_available()
                                  else "cpu"))
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if not dist.is_initialized():
        dist.init_process_group(
            backend="nccl" if dev.type == "cuda" else "gloo",
            init_method="env://",
            rank=int(os.environ.get("RANK", "0")),
            world_size=int(os.environ.get("WORLD_SIZE", "1")))
    return dev.type


def _device_type() -> str:
    backend = dist.get_backend()
    return "cuda" if backend == "nccl" else "cpu"


def make_host_mesh(data: int = 1, model: int = 1, device_type:
                   Optional[str] = None):
    """A ("data", "model") mesh over the whole initialized world, which
    must hold data x model ranks."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_host_mesh needs an initialized process group (run under "
            "torchrun, or call launch.mesh.init_distributed)")
    world = dist.get_world_size()
    if world != data * model:
        raise ValueError(
            f"a ({data}, {model}) mesh needs {data * model} ranks; the "
            f"world has {world} (WORLD_SIZE must equal --data-mesh x "
            f"--model-mesh)")
    return init_device_mesh(device_type or _device_type(), (data, model),
                            mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """(16, 16) ("data", "model") or (2, 16, 16) ("pod", "data", "model")
    over a world of 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for s in shape:
        need *= s
    if not dist.is_initialized() or dist.get_world_size() != need:
        raise ValueError(
            f"the production mesh {shape} needs a world of {need} ranks "
            f"(the dry run's fake process group)")
    return init_device_mesh(device_type or _device_type(), shape,
                            mesh_dim_names=axes)
