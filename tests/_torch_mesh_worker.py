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
import faulthandler
import functools
import json
import os
import pathlib
import shutil
import signal
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import manager
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_arch, get_shape
from repro_torch.configs.base import ShapeConfig
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


def _assemble(parts, spec, sizes):
    """The global array of a leaf from every rank's (coords, local) part,
    coords {axis: rank on it}: each dim sharded over axes (major first)
    takes the part's offset along it."""
    local0 = parts[0][1]
    spec = tuple(spec) + (None,) * (local0.ndim - len(spec))
    axes = [() if n is None else sharding._axes(n) for n in spec]
    out = np.zeros([dim * int(np.prod([sizes[a] for a in ax]))
                    for dim, ax in zip(local0.shape, axes)], local0.dtype)
    for coords, local in parts:
        idx = []
        for n, ax in zip(local.shape, axes):
            k = 0
            for a in ax:
                k = k * sizes[a] + coords[a]
            idx.append(slice(k * n, (k + 1) * n))
        out[tuple(idx)] = local
    return out


def _every_rank(obj):
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, obj)
    return got


def _replicas(parts, spec) -> tuple:
    """(whether the ranks holding the same shard of a leaf hold the same
    bits, how many ranks share a shard with another): parts are every
    rank's (coords, local), a shard named by the coordinates of the
    spec's axes."""
    spec = tuple(spec)
    axes = [a for n in spec if n is not None for a in sharding._axes(n)]
    groups = {}
    for coords, local in parts:
        groups.setdefault(tuple(coords[a] for a in axes), []).append(local)
    shared = sum(len(g) for g in groups.values() if len(g) > 1)
    same = all(np.array_equal(x, g[0]) for g in groups.values() for x in g)
    return same, shared


def _serve_one(case, out):
    """One serving case over its mesh (see case_serve)."""
    from repro_torch.launch import dryrun
    from repro_torch.models import common
    name = case["name"]
    cfg, model = _model(case)
    mesh = mesh_lib.make_host_mesh(*case["mesh"], "cpu")
    sizes = sharding.axis_sizes(mesh)
    coords = {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}
    sharding.check_mesh_family(cfg, mesh)
    data = np.load(case["inputs"])
    batch = {k: torch.from_numpy(data[k]) for k in data.files
             if k != "feed"}
    feed = torch.from_numpy(data["feed"])  # (steps, B) tokens to decode
    b, length = feed.shape[1], case["cache_len"]
    dtype = getattr(torch, case["dtype"])
    # the dry run's cell of this shape: one rank's bytes of its cache as
    # the rules place it (meta tensors), and the rules' specs
    shape = ShapeConfig("serve", length, b, "decode")
    out[f"{name}/dryrun_bytes"] = np.array(dryrun.rank_bytes(
        dryrun.build_cell(cfg, shape, mesh))["cache"])
    whole = registry.decode_specs(cfg, shape)[1]
    leaves = [k for k, v in whole.items()
              if torch.is_tensor(v) and v.ndim >= 2]
    specs = sharding.cache_shardings(mesh, whole, b)
    sharding.place_module(model, mesh)
    mdl = registry.get_model(cfg)
    seen, attend = [], getattr(mdl, "attention", None)

    def recorded(sla_params, q, k, v, kind, *a, **kw):
        seen.append([q.shape[0], q.shape[1], q.shape[2], k.shape[1],
                     k.shape[2], kind == "sla"])
        return attend(sla_params, q, k, v, kind, *a, **kw)

    prefill, decode = mdl.prefill, mdl.decode_step
    mdl.prefill = functools.partial(prefill, compute_dtype=dtype)
    mdl.decode_step = functools.partial(decode, compute_dtype=dtype)
    if attend is not None:
        mdl.attention = recorded
    residual = ctx.default_residual_spec(mesh, b, length)
    sized = cfg.family in ("dense", "moe", "vlm", "hybrid")
    logits = []
    try:
        with torch.no_grad(), ctx.activation_sharding(mesh, residual,
                                                       remat=False):
            empty = mdl.make_cache(cfg, b, length, dtype=torch.bfloat16,
                                   device="cpu")
            out[f"{name}/empty_bytes"] = np.array(sum(
                empty[key].numel() * empty[key].element_size()
                for key in leaves) + 4)
            got = steps.make_prefill_step(
                cfg, "kernel", cache_len=length if sized else None)(
                    model, batch)
            cache = got[1]
            for key in leaves:
                want = specs[key].shard_shape(whole[key].shape)
                assert tuple(empty[key].shape) == want, (key, want)
                assert tuple(cache[key].shape) == want, (key, want)
            del empty
            out[f"{name}/cache_bytes"] = np.array(sum(
                cache[key].numel() * cache[key].element_size()
                for key in leaves) + 4)
            if case.get("per_slot"):
                cache["pos"] = torch.tensor(case["per_slot"],
                                            dtype=torch.int32)
                cache["pos_host"] = np.array(case["per_slot"], np.int64)
            if cfg.family != "encdec":  # an LM's first token's logits
                logits.append(common.logits_from_hidden(model, got[0]))
            out[f"{name}/prefill_calls"] = np.array(len(seen))
            serve = steps.make_serve_step(cfg)
            for tok in feed:
                step, cache = serve(model, tok, cache)
                logits.append(step)
    finally:
        mdl.prefill, mdl.decode_step = prefill, decode
        if attend is not None:
            mdl.attention = attend
    out[f"{name}/attn_shapes"] = np.array(seen).reshape(-1, 6)
    out[f"{name}/residual"] = np.array(repr(residual))
    out[f"{name}/spec"] = np.array(json.dumps(specs[leaves[0]].spec))
    for key in leaves:
        out[f"{name}/spec/{key}"] = np.array(json.dumps(specs[key].spec))
    out[f"{name}/pos"] = np.array(cache["pos"])
    local = {key: cache[key].float().numpy() for key in leaves}
    mine = torch.stack(logits).numpy()  # (1 + steps, B_loc, V)
    ranks = _every_rank((coords, mine, local))
    if dist.get_rank():
        return
    # the ranks that hold the same rows: one data coordinate's under
    # data parallelism, every rank under context parallelism
    dp = b // mine.shape[1]
    rows = {}
    for c, lg, _ in ranks:
        rows.setdefault(c["data"] if dp > 1 else 0, []).append(lg)
    out[f"{name}/replicated_bitwise"] = np.array(all(
        np.array_equal(x, group[0])
        for group in rows.values() for x in group))
    out[f"{name}/logits"] = np.concatenate(
        [rows[r][0] for r in sorted(rows)], axis=1)
    shared = 0
    same = True
    for key in leaves:
        parts = [(c, loc[key]) for c, _, loc in ranks]
        ok, n = _replicas(parts, specs[key].spec)
        same, shared = same and ok, shared + n
        out[f"{name}/{key}"] = _assemble(parts, specs[key].spec, sizes)
    out[f"{name}/leaves_bitwise"] = np.array(same)
    out[f"{name}/leaf_replicas"] = np.array(shared)


def case_serve(spec, out):
    """Sharded serving of every case in `spec["cases"]`, one mesh each over
    this world: the family's smoke model from the case's weights placed
    by the rules, `make_prefill_step(cfg, "kernel", cache_len=)` on the
    global batch (an LM's caches sized to `cache_len`; the ssm and encdec
    families size their own) and one `make_serve_step` call per row of
    the case's `feed` tokens, in the case's compute dtype under
    `activation_sharding(mesh, default_residual_spec(mesh, batch,
    cache_len))`. Rank 0 records the logits (every data rank's rows, and
    whether the ranks holding the same rows returned them bitwise), every
    cache leaf assembled from every rank's part by the rule's spec and
    whether the ranks holding the same shard of it hold the same bits,
    each rank's cache bytes beside the dry run's for that cell, an empty
    `make_cache`'s, and the attention calls' shapes."""
    for case in spec["cases"]:
        _serve_one(case, out)
        dist.barrier()


def case_serve_sla(spec, out):
    """Decode-time SLA over a mesh, every case of `spec["cases"]`: the
    smoke model (`sla.decode_mode="sla"`) from the case's weights placed
    by the rules, `prefill(decode_max_len=)` on the global batch and one
    `make_serve_step` call per row of the case's `feed` (the kernel
    backend, the kernels' plain twins on these CPU tensors) under
    `activation_sharding(mesh, default_residual_spec(mesh, batch,
    cache_len))`. Rank 0 records the logits of every data rank's rows
    (and whether the ranks holding the same rows returned them bitwise),
    every cache leaf assembled from every rank's part by the rule's spec
    (and whether the ranks holding the same shard hold the same bits),
    each rank's cache bytes (of the filled cache and of an empty
    `make_cache`) beside the dry run's for that cell."""
    from repro_torch.launch import dryrun
    from repro_torch.models import common
    for case in spec["cases"]:
        name = case["name"]
        cfg, model = _model(case)
        cfg = dataclasses.replace(cfg, sla=cfg.sla.replace(decode_mode="sla"))
        mesh = mesh_lib.make_host_mesh(*case["mesh"], "cpu")
        sizes = sharding.axis_sizes(mesh)
        coords = {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}
        sharding.check_mesh_family(cfg, mesh)
        data = np.load(case["inputs"])
        feed = torch.from_numpy(data["feed"])
        tokens = torch.from_numpy(data["tokens"])
        b, length = feed.shape[1], case["cache_len"]
        dtype = getattr(torch, case["dtype"])
        shape = ShapeConfig("serve", length, b, "decode")
        cell = dryrun.build_cell(cfg, shape, mesh)
        out[f"{name}/dryrun_bytes"] = np.array(
            dryrun.rank_bytes(cell)["cache"])
        whole = registry.decode_specs(cfg, shape)[1]
        specs = sharding.cache_shardings(mesh, whole, b)
        sharding.place_module(model, mesh)
        mdl = registry.get_model(cfg)
        decode = mdl.decode_step
        mdl.decode_step = functools.partial(decode, compute_dtype=dtype,
                                            backend="kernel")
        residual = ctx.default_residual_spec(mesh, b, length)
        logits = []

        def nbytes(cache):
            return sum(leaf.numel() * leaf.element_size()
                       if torch.is_tensor(leaf) else 4
                       for _, leaf in sharding.tree_leaves(cache))

        try:
            with torch.no_grad(), ctx.activation_sharding(mesh, residual,
                                                           remat=False):
                empty = mdl.make_cache(cfg, b, length, device="cpu")
                out[f"{name}/empty_bytes"] = np.array(nbytes(empty))
                wholes = dict(sharding.tree_leaves(whole))
                for path, leaf in sharding.tree_leaves(empty):
                    if torch.is_tensor(leaf):
                        want = specs[path].shard_shape(wholes[path].shape)
                        assert tuple(leaf.shape) == want, (path, want)
                del empty
                hidden, cache = mdl.prefill(model, cfg, tokens, dtype,
                                            "kernel", decode_max_len=length)
                out[f"{name}/cache_bytes"] = np.array(nbytes(cache))
                logits.append(common.logits_from_hidden(model, hidden))
                serve = steps.make_serve_step(cfg)
                for tok in feed:
                    step, cache = serve(model, tok, cache)
                    logits.append(step)
        finally:
            mdl.decode_step = decode
        local = {}
        for path, leaf in sharding.tree_leaves(cache):
            if torch.is_tensor(leaf):
                leaf = leaf.float() if leaf.is_floating_point() else leaf
                local[path] = leaf.numpy()
        out[f"{name}/sla/rows"] = np.array(cache["sla"]["rows"])
        out[f"{name}/pos"] = np.array(cache["pos"])
        mine = torch.stack(logits).float().numpy()
        ranks = _every_rank((coords, mine, local))
        dist.barrier()
        if dist.get_rank():
            continue
        dp = b // mine.shape[1]
        rows = {}
        for c, lg, _ in ranks:
            rows.setdefault(c["data"] if dp > 1 else 0, []).append(lg)
        out[f"{name}/replicated_bitwise"] = np.array(all(
            np.array_equal(x, group[0])
            for group in rows.values() for x in group))
        out[f"{name}/logits"] = np.concatenate(
            [rows[r][0] for r in sorted(rows)], axis=1)
        same = True
        for path in local:
            parts = [(c, loc[path]) for c, _, loc in ranks]
            ok, _ = _replicas(parts, specs[path].spec)
            same = same and ok
            out[f"{name}/{path}"] = _assemble(parts, specs[path].spec,
                                              sizes)
            out[f"{name}/spec/{path}"] = np.array(
                json.dumps(specs[path].spec))
        out[f"{name}/leaves_bitwise"] = np.array(same)


def case_plan_reuse(spec, out):
    """Plan reuse over a mesh, every case of `spec["cases"]`
    (`tests/_torch_mesh_plan_reuse.py`)."""
    from _torch_mesh_plan_reuse import run_cases
    run_cases(spec, out)


def case_slots(spec, out):
    """Continuous-batching decode over a mesh, every case of
    `spec["cases"]` (`tests/_torch_mesh_slots.py`)."""
    from _torch_mesh_slots import run_cases
    run_cases(spec, out)


def case_paged(spec, out):
    """Paged caches and chunked admission over a mesh, every case of
    `spec["cases"]` (`tests/_torch_mesh_paged.py`)."""
    from _torch_mesh_paged import run_cases
    run_cases(spec, out)


def main():
    case, spec_path, out_path, store = sys.argv[1:5]
    # `run_ranks` sends SIGUSR1 before it kills a rank that outlived its
    # wait: the rank's stack then shows where it waited
    faulthandler.register(signal.SIGUSR1, all_threads=True)
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
