"""Atomic, async checkpointing of the port's training state, with the
reference's layout (`repro.checkpoint.manager`).

Layout:
  <dir>/step_<N>.tmp/          being written
  <dir>/step_<N>/              committed (atomic rename)
      manifest.json            step, and each leaf's shape and dtype
      <leaf-path>.npy          one file per leaf, named by the
                               "__"-joined path (`params__layers.0.wq`)

Guarantees, as the reference's:
  * atomic commit: readers only ever see fully renamed directories, so a
    crash mid-save never corrupts the latest checkpoint;
  * async save: the loop blocks only while every leaf is copied to host
    memory; a background thread writes and commits. The copy is a
    snapshot even of CPU tensors (whose `.numpy()` would share storage
    with tensors the optimizer then updates in place), so a file holds
    the state as it was at `save`;
  * one save in flight at a time, keep-last-N garbage collection;
  * `latest_step()` + `restore()` resume after a preemption.

Leaves are tensors (or python / numpy scalars and arrays). numpy has no
bf16: a bf16 leaf is stored as its 16-bit patterns (int16) with dtype
"bfloat16" in the manifest and restored exactly, never widened.
`restore(device=)` puts the leaves on that device (default: the template
leaf's device, else the CPU).

Over a mesh (DTensor leaves): `save` gathers each leaf's full tensor on
every rank, in the same order, before the writer thread starts (the
gathers are collectives, so no rank may skip one); rank 0 alone copies
them to host memory (the others drop each at once) and writes,
and every rank meets the others at a barrier in `wait()` (the next save,
or the end of a blocking one) after rank 0's commit, so a committed step
is visible to all of them. The files and manifest are those of a
one-device save of the same values. `restore(shardings=)` places each
leaf onto the *current* mesh under its `sharding.NamedSharding` (elastic
restore across meshes and world sizes).
"""
from __future__ import annotations

import json
import pathlib
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

_SEP = "__"
_BF16 = "bfloat16"


def _flatten(tree) -> dict:
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(prefix + [str(k)], v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(prefix + [str(i)], v)
        else:
            flat[_SEP.join(prefix)] = node

    walk([], tree)
    return flat


def _unflatten_into(template, flat: dict):
    def walk(prefix, node):
        if isinstance(node, dict):
            return {k: walk(prefix + [str(k)], v) for k, v in node.items()}
        if isinstance(node, tuple):
            return tuple(walk(prefix + [str(i)], v)
                         for i, v in enumerate(node))
        if isinstance(node, list):
            return [walk(prefix + [str(i)], v)
                    for i, v in enumerate(node)]
        return flat[_SEP.join(prefix)]

    return walk([], template)


def _distributed(flat: dict) -> bool:
    from torch.distributed.tensor import DTensor
    return any(isinstance(v, DTensor) for v in flat.values())


def _snapshot(leaf, keep: bool = True) -> Optional[tuple]:
    """(numpy array owning its memory, manifest dtype) of one leaf; a
    DTensor's full tensor (a collective, which every rank joins). With
    `keep` False the gathered tensor is dropped at once and nothing is
    copied to host memory: None."""
    from repro_torch.distributed.sharding import full
    if not torch.is_tensor(leaf):
        return (np.array(leaf), None) if keep else None
    t = full(leaf)
    if not keep:
        return None
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), _BF16
    return t.numpy(), None


class CheckpointManager:
    def __init__(self, directory, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._barrier = False  # a sharded save waits for the others

    # -------------------------------------------------- save
    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        """Async by default: snapshot to host now, write and commit in
        the background. With DTensor leaves every rank calls it; rank 0
        writes."""
        self.wait()  # one in-flight save at a time
        flat = _flatten(tree)
        sharded = _distributed(flat) and dist.is_initialized()
        writer = not sharded or dist.get_rank() == 0
        host = {k: _snapshot(v, writer) for k, v in flat.items()}
        if sharded:
            self._barrier = True
            if not writer:
                if blocking:
                    self.wait()
                return

        def write():
            tmp = self.dir / f"step_{step}.tmp"
            final = self.dir / f"step_{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest = {}
            for k, (a, dtype) in host.items():
                np.save(tmp / f"{k}.npy", a)
                manifest[k] = {"shape": list(a.shape),
                               "dtype": dtype or str(a.dtype)}
            (tmp / "manifest.json").write_text(json.dumps(
                {"step": step, "leaves": manifest}))
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)  # atomic commit
            self._gc()

        if blocking:
            write()
            self.wait()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Wait for the save in flight; after a sharded save, every rank
        returns once rank 0 has committed it."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            self._barrier = False
            dist.barrier()

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -------------------------------------------------- restore
    def steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            m = re.fullmatch(r"step_(\d+)", p.name)
            if m and (p / "manifest.json").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template: Any, device=None,
                shardings: Any = None) -> Any:
        """Load a checkpoint into the structure of `template`, each leaf
        a tensor of its saved dtype on `device` (default: the template
        leaf's device, else the CPU). `shardings`: a tree like `template`
        of `sharding.NamedSharding` (None for a leaf kept whole): each
        such leaf becomes a DTensor on that sharding's mesh, this rank
        keeping its shard (the device is the mesh's)."""
        from repro_torch.distributed.sharding import place
        final = self.dir / f"step_{step}"
        leaves = json.loads((final / "manifest.json").read_text())["leaves"]
        flat_s = {} if shardings is None else _flatten(shardings)
        flat = {}
        for k, like in _flatten(template).items():
            t = torch.from_numpy(np.load(final / f"{k}.npy"))
            if leaves[k]["dtype"] == _BF16:
                t = t.view(torch.bfloat16)
            sh = flat_s.get(k)
            if sh is not None:
                dev = (torch.device("cuda", torch.cuda.current_device())
                       if sh.mesh.device_type == "cuda" else "cpu")
            elif device is not None:
                dev = device
            else:
                from torch.distributed.tensor import DTensor
                dev = (like.to_local().device if isinstance(like, DTensor)
                       else like.device if torch.is_tensor(like) else "cpu")
            flat[k] = place(t.to(dev), sh)
        return _unflatten_into(template, flat)
