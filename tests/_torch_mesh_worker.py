"""One rank of a multi-rank case of the port, over gloo on the CPU.

    python tests/_torch_mesh_worker.py <case> <spec.json> <out.npz> <store>

Started by `tests/_torch_mesh.py::run_ranks` once per rank, with RANK,
LOCAL_RANK and WORLD_SIZE set; the process group (gloo) meets at a
FileStore (`file://<store>`), so no port is taken, and is up before a
case runs (the train CLI joins it). Imports torch and the port only.
Rank 0 writes the case's results to <out.npz>; every rank exits 0 or
raises.
"""
import dataclasses
import functools
import json
import os
import pathlib
import shutil
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import manager
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_arch, get_shape
from repro_torch.distributed import ctx, elastic, sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps, train
from repro_torch.models import moe, registry
from repro_torch.optim import adamw


def _full(t):
    return sharding.full(t).detach()


def _cfg(spec):
    """The smoke config of the case, with its overrides (a capacity
    factor that drops slots, rwkv6's 4-head twin)."""
    return dataclasses.replace(get_arch(spec["arch"]).smoke(),
                               **spec.get("overrides", {}))


def _model(spec):
    cfg = _cfg(spec)
    model = registry.get_model(cfg).init(None, cfg, device="cpu")
    weights = np.load(spec["weights"])
    model.load_state_dict({n: torch.from_numpy(weights[n])
                           for n in weights.files})
    return cfg, model


def _batches(spec):
    data = np.load(spec["batches"])
    n = 1 + max(int(k.split("/")[0]) for k in data.files)
    return [{k.split("/")[1]: torch.from_numpy(data[k]) for k in data.files
             if k.split("/")[0] == str(i)} for i in range(n)]


def case_train(spec, out):
    """`steps` AdamW steps of `make_train_step` (f32) over a mesh; with
    `grads`, first one backward of the loss, its gradients gathered."""
    cfg, model = _model(spec)
    mesh = mesh_lib.make_host_mesh(*spec["mesh"], "cpu")
    sharding.check_mesh_family(cfg, mesh)
    sharding.place_module(model, mesh)
    params = dict(model.named_parameters())
    batches = _batches(spec)
    shape = get_shape("train_4k", smoke=True)
    residual = ctx.default_residual_spec(mesh, batches[0][next(iter(
        batches[0]))].shape[0], shape.seq_len)
    out["residual"] = np.array(repr(residual))
    mdl = registry.get_model(cfg)
    seen = []  # the operand shapes each attention call got
    attend = getattr(mdl, "attention", None)  # rwkv6 does not attend

    def recorded(sla_params, q, k, v, *a, **kw):
        seen.append(list(q.shape) + list(k.shape))
        return attend(sla_params, q, k, v, *a, **kw)

    if attend is not None:
        mdl.attention = recorded
    slots = []  # every MoE call's kept slots, in the global order
    route = moe.route

    def recorded_route(*a, **kw):
        got = route(*a, **kw)
        slots.append(got["keep_all"])
        return got

    moe.route = recorded_route
    vocab = []  # the rows of each vocab-parallel table read, and its group
    vocab_shard = ctx.vocab_shard

    def recorded_vocab(w):
        got = vocab_shard(w)
        vocab.append([got[0].shape[0], got[2] is not None])
        return got

    ctx.vocab_shard = recorded_vocab
    with ctx.activation_sharding(mesh, residual, remat=True):
        if spec.get("grads"):
            loss = getattr(mdl, spec["losses"][0])(
                model, cfg, batches[0], torch.float32, spec["backend"])
            loss.backward()
            out["grad_loss"] = loss.detach().numpy()
            for n, p in params.items():
                g = _full(p.grad) if p.grad is not None else \
                    torch.zeros(p.shape)
                out[f"grad/{n}"] = g.numpy()
                p.grad = None
        opt_cfg = adamw.AdamWConfig(**spec.get("opt", {}))
        opt = adamw.init(params)
        losses = []
        for i, batch in enumerate(batches[:spec["steps"]]):
            loss_name = spec["losses"][i]
            step = steps.make_train_step(
                cfg, opt_cfg, spec["backend"],
                distill=loss_name == "distill_loss_fn", compute_bf16=False,
                compute_dtype=torch.float32)
            model, opt, loss, gnorm = step(model, opt, batch)
            losses.append((float(loss), float(gnorm)))
    if attend is not None:
        mdl.attention = attend
    ctx.vocab_shard = vocab_shard
    moe.route = route
    out["vocab"] = np.array(vocab, dtype=np.int64).reshape(-1, 2)
    out["slots"] = slot_record(slots)
    out["losses"] = np.array(losses)
    out["attn_shapes"] = np.array(seen)
    for n, p in params.items():
        out[f"param/{n}"] = _full(p).numpy()


def slot_record(slots) -> np.ndarray:
    """The MoE calls' kept slots as one (calls, slots) bool array (empty
    for a model without experts)."""
    if not slots:
        return np.zeros((0, 0), dtype=bool)
    return torch.stack(slots).numpy()


def case_cli(spec, out):
    """The train CLI on this world, its mesh from the flags; one run per
    argv, its loss in f32 (`make_train_step(compute_dtype=)`); with
    `drop`, that checkpoint directory is deleted after the first run."""
    train.make_train_step = functools.partial(steps.make_train_step,
                                              compute_dtype=torch.float32)
    for i, argv in enumerate(spec["argvs"]):
        out[f"losses{i}"] = np.array(train.main(argv))
        if i == 0 and spec.get("drop"):
            # the first run's last checkpoint goes: the next resumes from
            # the one before
            if dist.get_rank() == 0:
                shutil.rmtree(spec["drop"])
            dist.barrier()


def train_state(params):
    """AdamW state with moments made from the parameters, elementwise (the
    same values placed or not): m = p / 2, v = p * p, step 7."""
    opt = adamw.init(params)
    with torch.no_grad():
        for n, p in params.items():
            opt["m"][n].copy_(p * 0.5)
            opt["v"][n].copy_(p * p)
        opt["step"].fill_(7)
    return opt


def _placed(spec, mesh_shape):
    cfg, model = _model(spec)
    mesh = mesh_lib.make_host_mesh(*mesh_shape, "cpu")
    p_shard = sharding.place_module(model, mesh)
    params = dict(model.named_parameters())
    return mesh, p_shard, params, train_state(params)


def case_ckpt_save(spec, out):
    """Save the train state placed on `mesh`, counting the leaves each
    rank copied to host memory; place it on `remesh_from` and remesh it
    onto `mesh`: the same full values and local shards."""
    mesh, p_shard, params, opt = _placed(spec, spec["mesh"])
    mgr = CheckpointManager(spec["dir"])
    snapshot, kept = manager._snapshot, []

    def counted(leaf, keep=True):
        got = snapshot(leaf, keep)
        kept.append(got is not None)
        return got

    manager._snapshot = counted
    mgr.save(1, {"params": params, "opt": opt}, blocking=True)
    manager._snapshot = snapshot
    host = [None] * dist.get_world_size()
    dist.all_gather_object(host, [sum(kept), len(kept)])
    out["host_leaves"] = np.array(host)
    out["steps"] = np.array(mgr.steps())
    _, _, params_a, opt_a = _placed(spec, spec["remesh_from"])
    p2, o2 = elastic.remesh(params_a, opt_a, mesh)
    for n in params:
        assert p2[n].device_mesh is mesh
        assert p2[n].placements == p_shard[n].placements, n
        assert o2["m"][n].placements == p_shard[n].placements, n
        assert torch.equal(p2[n].to_local(), params[n].to_local()), n
        assert torch.equal(o2["v"][n].to_local(), opt["v"][n].to_local())
        out[f"remesh/{n}"] = _full(p2[n]).numpy()
    assert int(o2["step"]) == 7


def case_ckpt_restore(spec, out):
    """Restore a checkpoint onto this world's `mesh` with shardings=."""
    mesh, p_shard, params, _ = _placed(spec, spec["mesh"])
    opt = adamw.init(params)
    mgr = CheckpointManager(spec["dir"])
    state = mgr.restore(1, {"params": params, "opt": opt}, shardings={
        "params": p_shard, "opt": sharding.opt_shardings(p_shard)})
    for n in params:
        got = state["params"][n]
        assert got.placements == p_shard[n].placements, n
        assert got.device_mesh is mesh
        out[f"param/{n}"] = _full(got).numpy()
        out[f"m/{n}"] = _full(state["opt"]["m"][n]).numpy()
        out[f"v/{n}"] = _full(state["opt"]["v"][n]).numpy()
    out["step"] = state["opt"]["step"].numpy()


def main():
    case, spec_path, out_path, store = sys.argv[1:5]
    torch.set_num_threads(1)
    spec = json.loads(pathlib.Path(spec_path).read_text())
    spec["store"] = store
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    out = {}
    try:
        globals()[f"case_{case}"](spec, out)
        dist.barrier()
    finally:
        if dist.get_rank() == 0 and out:
            np.savez(out_path, **out)
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
