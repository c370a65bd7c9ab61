"""Continuous-batching decode over a ("data", "model") mesh: the cases of
tests/test_torch_mesh_slots.py as one process runs them, on one device
(the test's own process) or as one gloo rank
(`tests/_torch_mesh_worker.py::case_slots`). Imports torch and the port
only.

`run_case(case, model, cfg, inputs, mesh)` runs a case on one device
(`mesh` None) or over `mesh`, and returns its records, {key: numpy
array}: "logits" (tokens, B, V) of every decoded token of the global
batch (gathered over the data ranks), "prefill<i>" the last-position
logits of each admitted prompt, and under "cache/" every tensor of the
final cache, this rank's part of it. `run_cases` is the worker's side:
each case on its own mesh over the world, its records gathered to rank
0, the cache's parts assembled into global leaves by the rules.

Kinds of case:
  slots   a per-slot decode-SLA cache (`make_cache(per_slot=True)`):
          batch-1 prefills admitted with `insert_slot` at the steps of
          `admit` ([step, slot, prompt]), one `decode_step` a row of
          `feed` (B,) per step, each slot at its own position;
  static  `prefill(decode_max_len=)` (or `cache_len=` for dense decode)
          of the batch's prompts, then `ops`: ["step", n] for n
          `decode_step`s, ["chunk", C] for one `decode_chunk` of C
          tokens (with `steps_only`, C `decode_step`s instead).
A prefill runs under the batch-1 scope
(`default_residual_spec(mesh, 1, cache_len)`: the sequence over "data"),
everything else under the batch's.
"""
import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.distributed import ctx, sharding
from repro_torch.models import common, transformer


def case_cfg(case: dict):
    """The smoke config of the case's arch with its `sla` fields
    (decode-time SLA, learned routing)."""
    cfg = get_arch(case["arch"]).smoke()
    return dataclasses.replace(cfg, sla=cfg.sla.replace(**case["sla"]))


def case_model(case: dict, cfg):
    """The case's model on the CPU, its weights from the case's file."""
    model = transformer.init(None, cfg, device="cpu")
    weights = np.load(case["weights"])
    model.load_state_dict({n: torch.from_numpy(weights[n])
                           for n in weights.files})
    return model


def _np(t) -> np.ndarray:
    t = t.detach()
    return (t.float() if t.is_floating_point() else t).cpu().numpy()


def _scope(mesh, batch: int, length: int):
    if mesh is None:
        return contextlib.nullcontext()
    return ctx.activation_sharding(
        mesh, ctx.default_residual_spec(mesh, batch, length), remat=False)


def global_cache(cfg, case: dict) -> dict:
    """{path: meta tensor} of the case's cache at its global shapes (the
    rules' input)."""
    cache = transformer.make_cache(
        cfg, case["batch"], case["cache_len"], dtype=torch.float32,
        decode_sla=cfg.sla.decode_mode == "sla",
        per_slot=case["kind"] == "slots", device="meta")
    return {p: leaf for p, leaf in sharding.tree_leaves(cache)
            if torch.is_tensor(leaf)}


def _slots(case, model, cfg, inputs, mesh, rec):
    b, length = case["batch"], case["cache_len"]
    feed = inputs["feed"]
    with _scope(mesh, b, length):
        cache = transformer.make_cache(cfg, b, length, dtype=torch.float32,
                                       per_slot=True, device="cpu")
    logits = []
    for i, tok in enumerate(feed):
        for at, slot, k in case["admit"]:
            if at != i:
                continue
            with _scope(mesh, 1, length):
                hidden, single = transformer.prefill(
                    model, cfg, torch.from_numpy(inputs[f"prompt{k}"]),
                    torch.float32, "kernel", decode_max_len=length)
                rec[f"prefill{k}"] = _np(common.logits_from_hidden(
                    model, hidden))
            with _scope(mesh, b, length):
                transformer.insert_slot(cache, single, slot, cfg)
            del single
        with _scope(mesh, b, length):
            lg, cache = transformer.decode_step(
                model, cfg, torch.from_numpy(tok), cache, torch.float32,
                backend="kernel")
            logits.append(_np(ctx.gather_batch(lg)))
    rec["logits"] = np.stack(logits)
    return cache


def _static(case, model, cfg, inputs, mesh, rec):
    b, length = case["batch"], case["cache_len"]
    feed = inputs["feed"]  # (tokens, B)
    sla = cfg.sla.decode_mode == "sla"
    logits = []
    with _scope(mesh, b, length):
        kw = {"decode_max_len": length} if sla else {"cache_len": length}
        hidden, cache = transformer.prefill(
            model, cfg, torch.from_numpy(inputs["prompt0"]), torch.float32,
            "kernel", **kw)
        rec["prefill0"] = _np(ctx.gather_batch(common.logits_from_hidden(
            model, hidden)))
        at = 0
        for op, n in case["ops"]:
            toks = torch.from_numpy(feed[at:at + n])
            at += n
            if op == "chunk" and not case.get("steps_only"):
                lg, cache = transformer.decode_chunk(
                    model, cfg, toks.t().contiguous(), cache,
                    torch.float32, backend="kernel")
                logits.extend(_np(ctx.gather_batch(lg)).transpose(1, 0, 2))
                continue
            for tok in toks:
                lg, cache = transformer.decode_step(
                    model, cfg, tok, cache, torch.float32, backend="kernel")
                logits.append(_np(ctx.gather_batch(lg)))
    rec["logits"] = np.stack(logits)
    return cache


KINDS = {"slots": _slots, "static": _static}


def run_case(case: dict, model, cfg, inputs: dict, mesh=None) -> dict:
    """The case's records (module docstring)."""
    rec = {}
    with torch.no_grad():
        cache = KINDS[case["kind"]](case, model, cfg, inputs, mesh, rec)
    for path, leaf in sharding.tree_leaves(cache):
        if torch.is_tensor(leaf):
            rec[f"cache/{path}"] = _np(leaf).copy()
        elif path == "sla/rows" or path == "pos":
            rec[f"cache/{path}"] = np.asarray(leaf)
    return rec


def run_cases(spec: dict, out: dict) -> None:
    """The worker's side: every case of `spec["cases"]` on its own mesh
    over this world (the case's weights placed by the rules). Rank 0
    writes each global record once (and whether every rank held its
    bits), each cache leaf assembled from every rank's part by the rule's
    spec (and whether the ranks that hold the same shard hold the same
    bits)."""
    import torch.distributed as dist

    from _torch_mesh_worker import _assemble, _every_rank, _replicas
    from repro_torch.launch import mesh as mesh_lib
    for case in spec["cases"]:
        name = case["name"]
        cfg = case_cfg(case)
        model = case_model(case, cfg)
        mesh = mesh_lib.make_host_mesh(*case["mesh"], "cpu")
        sizes = sharding.axis_sizes(mesh)
        coords = {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}
        sharding.place_module(model, mesh)
        data = np.load(case["inputs"])
        inputs = {k: data[k] for k in data.files}
        rec = run_case(case, model, cfg, inputs, mesh)
        specs = sharding.cache_shardings(mesh, global_cache(cfg, case),
                                         case["batch"])
        ranks = _every_rank((coords, rec))
        dist.barrier()
        if dist.get_rank():
            continue
        same = True
        for key, val in rec.items():
            path = key.removeprefix("cache/")
            if path in specs:
                parts = [(c, other[key]) for c, other in ranks]
                ok, _ = _replicas(parts, specs[path].spec)
                same = same and ok
                out[f"{name}/{key}"] = _assemble(parts, specs[path].spec,
                                                 sizes)
                out[f"{name}/spec/{path}"] = np.array(
                    repr(specs[path].spec))
                continue
            same = same and all(np.array_equal(other[key], val)
                                for _, other in ranks)
            out[f"{name}/{key}"] = val
        out[f"{name}/ranks_bitwise"] = np.array(same)
