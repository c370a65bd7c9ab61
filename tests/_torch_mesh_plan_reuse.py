"""Plan reuse over a ("data", "model") mesh: the cases of
tests/test_torch_mesh_plan_reuse.py as one process runs them, on one
device (the test's own process) or as one gloo rank
(`tests/_torch_mesh_worker.py::case_plan_reuse`). Imports torch and the
port only.

`run_case(case, model, cfg)` runs a case in the caller's scope (no mesh,
or `activation_sharding(mesh, ...)` over a mesh) and returns its
records, {key: numpy array}: keys under "part/" hold this rank's part of
a plan stack (leaves (L, B_local, H_local, ...)), every other key a
global value, the same on every rank. Every call of the drift gate's MIN
(`ctx.min_over_ranks`) is recorded under "gate/": this rank's local
value and the global one. `run_cases` is the worker's side: a mesh a
case, every rank's records gathered to rank 0, the plan parts assembled
into global stacks.

Kinds of case:
  sample  `dit.sample` (fixed or adaptive refresh) with its trace; every
          forward's inputs, velocity, plans and drift info;
  serve   a `DiffusionScheduler` draining requests through its slots:
          each request's final latent, the counters, the plan pool and
          each slot's rows of it (`dit.take_slot_plans`);
  prefill the LM's `prefill(return_plans=True)` on one prompt, then
          `prefill(plans=, drift_threshold=, return_plans=True)` on a
          second of the same shape: logits, K/V caches, plans, drift info.
"""
import numpy as np
import torch

from repro_torch.core import plan as plan_lib
from repro_torch.distributed import ctx, serving
from repro_torch.models import common, dit, registry
from repro_torch.serving.diffusion import DenoiseParams, DiffusionScheduler


def _np(t) -> np.ndarray:
    t = t.detach()
    return (t.float() if t.is_floating_point() else t).cpu().numpy()


def _put_plans(rec: dict, key: str, plans, split=None) -> None:
    """This rank's part of a plan stack, and under "split/" whether its
    rows are split over the data ranks (by default: whether the active
    layout splits the batch)."""
    for name in plan_lib.PLAN_LEAVES:
        rec[f"part/{key}/{name}"] = _np(getattr(plans, name)).copy()
    if split is None:
        lay = ctx.layout()
        split = lay is not None and lay.dp > 1
    rec[f"split/{key}"] = np.array(split)


def _recording(rec: dict):
    """Patch `dit.forward` (each call's inputs, velocity of the global
    batch, whether it was given plans, the plans it returned and its
    info into `rec` under f<i>/) and `ctx.min_over_ranks`
    (gate/<i>/local, /global); returns the undo."""
    forward, gate = dit.forward, ctx.min_over_ranks
    calls = [0, 0]

    def recorded_forward(*a, **kw):
        out = forward(*a, **kw)
        outs = out if isinstance(out, tuple) else (out,)
        i = calls[0]
        calls[0] += 1
        rec[f"f{i}/x"] = _np(a[2]).copy()
        rec[f"f{i}/t"] = _np(torch.as_tensor(a[3])).copy()
        rec[f"f{i}/vel"] = _np(ctx.gather_tokens(outs[0])).copy()
        rec[f"f{i}/given"] = np.array(kw.get("plans") is not None)
        if kw.get("return_plans"):
            _put_plans(rec, f"f{i}/plans", outs[1])
        if kw.get("drift_threshold") is not None:
            info = outs[-1]
            for k in ("retention", "replanned"):
                v = info[k]
                if kw.get("per_sample_refresh"):
                    v = ctx.gather_batch(v, dim=1)
                rec[f"f{i}/info/{k}"] = _np(v).copy()
        return out

    def recorded_gate(x, *a, **kw):
        got = gate(x, *a, **kw)
        i = calls[1]
        calls[1] += 1
        rec[f"gate/{i}/local"] = _np(x).copy()
        rec[f"gate/{i}/global"] = _np(got).copy()
        return got

    dit.forward, ctx.min_over_ranks = recorded_forward, recorded_gate

    def undo():
        dit.forward, ctx.min_over_ranks = forward, gate
    return undo


def _sample(case, model, cfg, inputs, rec):
    kw = dict(refresh_mode=case["mode"])
    if case["mode"] == "fixed":
        kw["refresh_interval"] = case["interval"]
    else:
        kw["drift_threshold"] = case["threshold"]
    x, trace = dit.sample(model, cfg, torch.from_numpy(inputs["noise"]),
                          num_steps=case["steps"],
                          compute_dtype=torch.float32, backend="kernel",
                          return_trace=True, **kw)
    rec["final"] = _np(x).copy()
    for k, v in trace.items():
        rec[f"trace/{k}"] = _np(v).copy()


def _serve(case, model, cfg, inputs, rec):
    sched = DiffusionScheduler(
        cfg, model, num_slots=case["slots"], seq_len=case["seq"],
        backend="kernel", compute_dtype=torch.float32,
        refresh_mode="adaptive", drift_threshold=case["threshold"],
        device="cpu")
    for lat, t0 in zip(inputs["latents"], case["t_starts"]):
        sched.submit(lat, DenoiseParams(num_steps=case["steps"],
                                        t_start=t0))
    done = sched.drain()
    rec["results"] = np.stack([r.result for r in done])
    st = sched.stats
    rec["stats"] = np.array([st.admissions, st.denoise_steps,
                             st.plan_builds, st.plan_replans,
                             st.plan_reuses, st.slot_steps_active,
                             st.slot_steps_total], np.int64)
    rec["last_retention"] = np.array(st.last_retention, np.float32)
    with sched._scope(sched.num_slots):  # the pool's layout
        _put_plans(rec, "pool", sched._plans)
        for j in range(sched.num_slots):  # every data rank gets the rows
            _put_plans(rec, f"slot{j}", dit.take_slot_plans(sched._plans,
                                                            j), False)


def _prefill(case, model, cfg, inputs, rec):
    mdl = registry.get_model(cfg)
    first, second = (torch.from_numpy(inputs[k]) for k in ("first",
                                                           "second"))
    hidden, cache, plans = mdl.prefill(model, cfg, first, torch.float32,
                                       "kernel", return_plans=True)
    rec["logits0"] = _np(ctx.gather_batch(
        common.logits_from_hidden(model, hidden))).copy()
    _put_plans(rec, "plans0", plans)
    hidden, cache, plans, info = mdl.prefill(
        model, cfg, second, torch.float32, "kernel", plans=plans,
        drift_threshold=case["threshold"], return_plans=True)
    rec["logits1"] = _np(ctx.gather_batch(
        common.logits_from_hidden(model, hidden))).copy()
    _put_plans(rec, "plans1", plans)
    for k in ("k", "v"):
        rec[f"kv/{k}"] = _np(cache[k]).copy()
    for k, v in info.items():
        rec[f"info/{k}"] = _np(v).copy()


KINDS = {"sample": _sample, "serve": _serve, "prefill": _prefill}


def run_case(case: dict, model, cfg, inputs: dict) -> dict:
    """The case's records in the caller's scope (module docstring)."""
    rec = {}
    undo = _recording(rec)
    try:
        with torch.no_grad():
            KINDS[case["kind"]](case, model, cfg, inputs, rec)
    finally:
        undo()
    return rec


def run_cases(spec: dict, out: dict) -> None:
    """The worker's side: every case of `spec["cases"]` on its own mesh
    over this world (the case's weights placed by the rules, its global
    inputs on every rank), under `activation_sharding(mesh,
    default_residual_spec(mesh, batch, seq))`. Rank 0 writes each global
    record once (and whether every rank held its bits), each plan part
    assembled from every rank's, with whether the ranks that hold the same
    shard hold the same bits, and every rank's gate records. A plan
    part's leaves are split (layers, rows, heads), its rows over "data"
    where the layout it was made in splits the batch (its "split/"
    record), a K/V cache's by its rule."""
    import torch.distributed as dist

    from _torch_mesh_worker import _assemble, _every_rank, _model, \
        _replicas
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as mesh_lib
    for case in spec["cases"]:
        name = case["name"]
        cfg, model = _model(case)
        mesh = mesh_lib.make_host_mesh(*case["mesh"], "cpu")
        sizes = sharding.axis_sizes(mesh)
        coords = {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}
        sharding.place_module(model, mesh)
        data = np.load(case["inputs"])
        inputs = {k: data[k] for k in data.files}
        residual = ctx.default_residual_spec(mesh, case["batch"],
                                             case["seq"])
        with ctx.activation_sharding(mesh, residual, remat=False):
            rec = run_case(case, model, cfg, inputs)
        ranks = _every_rank((coords, rec))
        dist.barrier()
        if dist.get_rank():
            continue
        out[f"{name}/residual"] = np.array(repr(residual))
        same = True
        for key, val in rec.items():
            if key.startswith("split/"):
                continue
            if key.startswith("gate/"):
                for r, (_, other) in enumerate(ranks):
                    out[f"{name}/rank{r}/{key}"] = other[key]
                continue
            if not key.startswith(("part/", "kv/")):
                same = same and all(np.array_equal(other[key], val)
                                    for _, other in ranks)
                out[f"{name}/{key}"] = val
                continue
            if key.startswith("kv/"):
                leaf_spec = serving.kv_layout(mesh, case["batch"],
                                              cfg.num_kv_heads).spec
            else:
                stack = key.removeprefix("part/").rpartition("/")[0]
                split = bool(rec[f"split/{stack}"])
                leaf_spec = (None, "data" if split else None, "model")
            parts = [(c, other[key]) for c, other in ranks]
            ok, _ = _replicas(parts, leaf_spec)
            same = same and ok
            out[f"{name}/{key.removeprefix('part/')}"] = _assemble(
                parts, leaf_spec, sizes)
        out[f"{name}/ranks_bitwise"] = np.array(same)
        out[f"{name}/gate_calls"] = np.array(
            sum(k.startswith("gate/") and k.endswith("/local")
                for k in rec))
