"""Dry run of every (arch x shape x mesh) cell on the production meshes.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both --out artifacts/dryrun_torch

Counterpart of `repro.launch.dryrun`, without its compile and roofline
(the port has no XLA program to lower). Each cell builds its state on
the `meta` device (`launch.steps.abstract_state`, no allocation), joins
a fake process group of 256 or 512 ranks in this one process, places
the parameters, AdamW's moments, the batch or the decode cache under the
sharding rules on the production mesh (`launch.mesh`), and writes the
per-rank bytes of each to `<out>/<arch>__<shape>__<mesh>.json`. The
fake group runs no collective, so the numbers are arithmetic on the
rules, not a measurement; mistral-large-123b and llama4-maverick are
covered here, which no card of the port holds.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import (ASSIGNED_ARCHS, PAPER_ARCHS, get_arch,
                                 get_shape)
from repro_torch.configs.base import DIT_SHAPES, SHAPES
from repro_torch.distributed.sharding import (batch_shardings,
                                              cache_shardings,
                                              opt_shardings,
                                              param_shardings, place,
                                              shape_of, tree_leaves)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import abstract_state
from repro_torch.models import registry

# Cells that are skipped by design (DESIGN.md §4 Arch-applicability).
SKIPS = {
    ("whisper-small", "long_500k"):
        "enc-dec: 500K-token decoder cache exceeds the model's structural "
        "audio context (1.5K frames); skipped per DESIGN.md",
}


def fake_world(size: int) -> None:
    """(Re)join a fake process group of `size` ranks as rank 0: enough to
    build a DeviceMesh and place meta tensors, never to communicate."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def _place_tree(tree, shardings: dict):
    """{leaf path: placed leaf} of a (nested) tree under {path: sharding}
    (None keeps a leaf as it is)."""
    return {path: place(leaf, shardings.get(path))
            if torch.is_tensor(leaf) else leaf
            for path, leaf in tree_leaves(tree)}


def build_cell(cfg, shape, mesh) -> dict:
    """The cell's placed state, {part: {leaf path: DTensor or leaf}}:
    params and opt (m, v, step) and the batch for a train cell; params
    and the batch for prefill; params, the token and the cache for
    decode."""
    params, opt = abstract_state(cfg)
    p_shard = param_shardings(mesh, params)
    out = {"params": {n: place(p, p_shard[n]) for n, p in params.items()}}
    if shape.kind == "train":
        o_shard = opt_shardings(p_shard)
        out["opt"] = {f"{key}/{n}": place(t, o_shard[key][n])
                      for key in ("m", "v") for n, t in opt[key].items()}
        out["opt"]["step"] = opt["step"]
        batch = registry.train_batch_specs(cfg, shape)
    elif shape.kind == "prefill":
        batch = registry.prefill_specs(cfg, shape)
    else:
        token, cache = registry.decode_specs(cfg, shape)
        out["token"] = {"token": place(token, batch_shardings(
            mesh, token, shape.global_batch))}
        out["cache"] = _place_tree(cache, cache_shardings(
            mesh, cache, shape.global_batch))
        return out
    batch = {k: v for k, v in batch.items() if v is not None}
    b_shard = batch_shardings(mesh, batch, shape.global_batch)
    out["batch"] = {k: place(v, b_shard[k]) for k, v in batch.items()}
    return out


def leaf_bytes(leaf) -> int:
    """One rank's bytes of a placed leaf (a python scalar: an int32)."""
    from torch.distributed.tensor import DTensor
    if isinstance(leaf, DTensor):
        leaf = leaf.to_local()
    if not torch.is_tensor(leaf):
        return 4 * max(1, len(shape_of(leaf)))
    return leaf.numel() * leaf.element_size()


def rank_bytes(cell: dict) -> dict:
    """{part: one rank's bytes} of a built cell; the batch's token joins
    the batch."""
    out = {}
    for part, leaves in cell.items():
        key = "batch" if part == "token" else part
        out[key] = out.get(key, 0) + sum(leaf_bytes(v)
                                         for v in leaves.values())
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: pathlib.Path) -> dict:
    mesh_name = "multi" if multi_pod else "single"
    tag = f"{arch}__{shape_name}__{mesh_name}"
    out_path = out_dir / f"{tag}.json"
    if (arch, shape_name) in SKIPS:
        rec = {"cell": tag, "status": "skipped",
               "reason": SKIPS[(arch, shape_name)]}
        out_path.write_text(json.dumps(rec, indent=2))
        return rec
    cfg = get_arch(arch)
    shape = (DIT_SHAPES[arch] if arch in DIT_SHAPES
             else get_shape(shape_name))
    t0 = time.time()
    try:
        fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod)
        cell = build_cell(cfg, shape, mesh)
        per_rank = rank_bytes(cell)
        rec = {
            "cell": tag, "status": "ok", "arch": arch, "shape": shape_name,
            "kind": shape.kind,
            "mesh": [int(s) for s in mesh.shape],
            "mesh_axes": list(mesh.mesh_dim_names),
            "chips": mesh.size(),
            "bytes_per_rank": per_rank,
            "state_gib_per_rank": sum(per_rank.values()) / 2**30,
            "seconds": time.time() - t0,
            "measured": False,
        }
    except Exception as e:  # a failing cell is a bug in the system
        rec = {"cell": tag, "status": "error",
               "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-2000:]}
    out_path.write_text(json.dumps(rec, indent=2))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--include-paper-archs", action="store_true")
    args = ap.parse_args(argv)

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = (list(ASSIGNED_ARCHS) if args.arch == "all" else [args.arch])
    if args.include_paper_archs and args.arch == "all":
        archs = archs + list(PAPER_ARCHS)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    n_ok = n_fail = 0
    try:
        for arch in archs:
            shapes = (["dit"] if arch in DIT_SHAPES else
                      (list(SHAPES) if args.shape == "all"
                       else [args.shape]))
            for shape_name in shapes:
                for multi in meshes:
                    rec = run_cell(arch, shape_name, multi, out_dir)
                    status = rec["status"]
                    n_ok += status in ("ok", "skipped")
                    n_fail += status == "error"
                    extra = ""
                    if status == "ok":
                        b = rec["bytes_per_rank"]
                        extra = (" " + " ".join(
                            f"{k}={v / 2**30:.3f}GiB" for k, v in b.items())
                            + f" [{rec['seconds']:.2f}s]")
                    elif status == "error":
                        extra = " " + rec["error"][:160]
                    print(f"{rec['cell']:60s} {status}{extra}", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"\n{n_ok} ok/skipped, {n_fail} failed")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
