"""Plan reuse over a ("data", "model") DeviceMesh of 1 and 4 gloo ranks:
`dit.sample`, the `DiffusionScheduler` and the LM's plan-reusing prefill,
against the port on one device and the reference on one device.

One spawn a world size (`tests/_torch_mesh_plan_reuse.py`, the worker's
`case_plan_reuse`), each case on its own mesh over that world, the smoke
model from the reference's perturbed init carried over with
`repro_torch.bridge` and placed by the rules, on the kernel backend (the
kernels' plain twins on these CPU tensors), f32:

- lightningdit, `dit.sample` of 4 steps at 128 tokens (8 blocks of 16),
  adaptive (drift threshold THR, THR_CP) and fixed (re-plan every 2 steps)
  refresh, over (2, 2) and (1, 4) at batch 2 (data parallelism; on (1,
  4) one query head a rank), and over (4, 1) at batch 1 (context
  parallelism: every data rank plans the whole sequence);
- lightningdit served by a `DiffusionScheduler` over (2, 2): 3 requests
  (t_start 1.0, 0.75, 1.0; 3 steps, adaptive) through 2 slots: batch-1
  admissions under context parallelism, ticks under data parallelism;
- smoke qwen3 over (2, 2): `prefill(return_plans=True)` on one prompt,
  then `prefill(plans=, drift_threshold=, return_plans=True)` on a
  second of the same shape;
- the DiT sample, the scheduler and the prefill over a 1 x 1 mesh.

Held: every record (each forward's inputs, velocity, plans and drift
info; the trace; the final latents, logits, K/V caches, plan pool and
each slot's rows of it through `dit.take_slot_plans`)
against the port on one device, integer leaves bitwise (the plans
assembled from the ranks' parts), the drift flags and `ServeStats`
counters exactly, floats within 5e-5 x max(1, max |want|); on the 1 x 1
mesh everything bitwise, the drift gate's MIN included. Every rank holds
the same global records and the ranks that hold the same part of a plan
the same bits. Against the reference on one device: each forward of a
sample, and the second prefill, executed by the reference on the plans
the mesh gave it (its velocity or logits within the tolerance, its drift
flags exact); plans bitwise where the port on one device plans as the
reference does (ROADMAP's planning-parity rule: this seed has no
near-tied block); the scheduler's final latents and counters against the
reference's scheduler. Every drift decision clears its threshold by
MARGIN on one device, and some rank's decision from its own MIN differs
from the global one: without the cross-rank MIN that layer would re-plan
on one rank and not on another.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_mesh import run_ranks, save_weights
from _torch_mesh_plan_reuse import run_case
from _torch_mesh_serve import _weights
from _torch_threads import one_torch_thread  # noqa: F401
from repro.configs import get_arch as jax_get_arch
from repro.core import plan as jplan
from repro.models import common as jcommon
from repro.models import dit as jdit
from repro.models import transformer as jtransformer
from repro.serving.diffusion import DenoiseParams as JaxDenoiseParams
from repro.serving.diffusion import DiffusionScheduler as JaxScheduler
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.core import plan as plan_lib
from repro_torch.models import registry

DIT, LM = "lightningdit_1b", "qwen3-1.7b"
SEQ, STEPS = 128, 4
# drift thresholds: each case's trace has layers that re-plan and layers
# that do not (the DiT sample's THR, the context-parallel sample's and
# the scheduler's and prefill's own, from their one-device retentions)
THR = 0.3
THR_CP, THR_SERVE, THR_PREFILL = 0.175, 0.25, 0.1
TOL = 5e-5
MARGIN = 1e-4  # |1 - retention - threshold| of every drift decision
STATS = ("admissions", "denoise_steps", "plan_builds", "plan_replans",
         "plan_reuses", "slot_steps_active", "slot_steps_total")


def _sample(name, mesh, batch, mode, threshold=THR):
    return dict(name=name, arch=DIT, mesh=mesh, batch=batch, seq=SEQ,
                kind="sample", mode=mode, threshold=threshold, interval=2,
                steps=STEPS)


def _serve(name, mesh):
    return dict(name=name, arch=DIT, mesh=mesh, batch=2, seq=SEQ,
                kind="serve", slots=2, t_starts=[1.0, 0.75, 1.0], steps=3,
                threshold=THR_SERVE)


def _prefill(name, mesh):
    return dict(name=name, arch=LM, mesh=mesh, batch=2, seq=SEQ,
                kind="prefill", threshold=THR_PREFILL)


CASES = [
    _sample("dit-2x2-adaptive", [2, 2], 2, "adaptive"),
    _sample("dit-2x2-fixed", [2, 2], 2, "fixed"),
    _sample("dit-1x4-adaptive", [1, 4], 2, "adaptive"),
    _sample("dit-1x4-fixed", [1, 4], 2, "fixed"),
    _sample("dit-4x1-cp", [4, 1], 1, "adaptive", THR_CP),
    _serve("serve-2x2", [2, 2]),
    _prefill("qwen3-2x2", [2, 2]),
    _sample("dit-1x1", [1, 1], 2, "adaptive"),
    _serve("serve-1x1", [1, 1]),
    _prefill("qwen3-1x1", [1, 1]),
]
BY_NAME = {c["name"]: c for c in CASES}


def _world(case) -> int:
    return case["mesh"][0] * case["mesh"][1]


@functools.lru_cache(maxsize=None)
def _inputs(name: str) -> dict:
    case = BY_NAME[name]
    cfg = get_arch(case["arch"]).smoke()
    rs = np.random.default_rng([case["batch"], 3])
    if case["kind"] == "sample":
        return {"noise": rs.standard_normal(
            (case["batch"], SEQ, cfg.patch_dim)).astype(np.float32)}
    if case["kind"] == "serve":
        return {"latents": rs.standard_normal(
            (len(case["t_starts"]), SEQ, cfg.patch_dim)).astype(np.float32)}
    first = rs.integers(0, cfg.vocab_size, size=(case["batch"], SEQ))
    second = first.copy()  # the same prompt with its second half redrawn
    second[:, SEQ // 2:] = rs.integers(0, cfg.vocab_size,
                                       size=(case["batch"], SEQ // 2))
    return {"first": first.astype(np.int32),
            "second": second.astype(np.int32)}


def _run_world(world: int, tmp_path) -> dict:
    """Every case of `world` in one spawn: {case name: {key: array}}."""
    specs = []
    for case in CASES:
        if _world(case) != world:
            continue
        path = tmp_path / f"{case['name']}.npz"
        np.savez(path, **_inputs(case["name"]))
        specs.append(dict(case, inputs=str(path), weights=save_weights(
            tmp_path / f"{case['arch']}.w.npz",
            bridge.params_from_numpy(_weights(case["arch"], ()), "cpu"))))
    res = run_ranks("plan_reuse", world, tmp_path, cases=specs)
    out = {c["name"]: {} for c in specs}
    for key, val in res.items():
        if key != "logs":
            name, _, leaf = key.partition("/")
            out[name][leaf] = val
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world size: {case: rank 0's records}}, one spawn a world size,
    run when its first case asks."""
    done = {}

    def get(world):
        if world not in done:
            try:
                done[world] = _run_world(world, tmp_path_factory.mktemp(
                    f"world{world}"))
            except Exception as e:  # one spawn: every case of it fails
                done[world] = e
        if isinstance(done[world], Exception):
            raise done[world]
        return done[world]

    return get


@functools.lru_cache(maxsize=None)
def _one_device(name: str) -> dict:
    """The case on one device in this process (no mesh)."""
    case = BY_NAME[name]
    cfg = get_arch(case["arch"]).smoke()
    model = registry.get_model(cfg).init(None, cfg, device="cpu")
    model.load_state_dict(bridge.params_from_numpy(_weights(case["arch"],
                                                            ()), "cpu"))
    return run_case(case, model, cfg, _inputs(name))


def _close(got, want, name):
    want = np.asarray(want, dtype=np.float32)
    atol = TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32), want,
                               atol=atol, rtol=0, err_msg=name)


def _check_one_device(case, got: dict, one: dict) -> None:
    bitwise = _world(case) == 1
    for key, want in one.items():
        if key.startswith(("gate/", "split/")):
            continue
        mine = got[key.removeprefix("part/")]
        assert mine.shape == want.shape, key
        if want.dtype.kind == "f" and not bitwise:
            _close(mine, want, key)
        else:
            np.testing.assert_array_equal(mine, want, err_msg=key)
    if bitwise:  # the gate's MIN over one rank is the identity, bitwise
        n = int(got["gate_calls"])
        assert n == sum(k.endswith("/local") for k in one
                        if k.startswith("gate/"))
        for i in range(n):
            for side in ("local", "global"):
                np.testing.assert_array_equal(
                    got[f"rank0/gate/{i}/{side}"], one[f"gate/{i}/local"])


def _forwards(rec: dict) -> int:
    return sum(k.endswith("/vel") for k in rec)


def _stack(rec: dict, prefix: str):
    return {n: rec[f"{prefix}/{n}"] for n in plan_lib.PLAN_LEAVES}


def _jplan(stack: dict):
    return jplan.SLAPlan(**{n: jnp.asarray(v) for n, v in stack.items()})


def _jparams(arch: str):
    return jax.tree_util.tree_map(jnp.asarray, _weights(arch, ()))


@functools.lru_cache(maxsize=None)
def _jforward(given: bool, return_plans: bool, adaptive: bool):
    jcfg = jax_get_arch(DIT).smoke()

    def f(params, lat, t, plans, thr):
        return jdit.forward(params, jcfg, lat, t, None, jnp.float32,
                            "gather", plans=plans if given else None,
                            return_plans=return_plans,
                            drift_threshold=thr if adaptive else None)
    return jax.jit(f)


def _check_sample_reference(case, got: dict, one: dict) -> None:
    """Each forward of the mesh's sample executed by the reference on the
    plans the mesh gave it; plans where the port on one device plans as
    the reference does."""
    params = _jparams(DIT)
    last = None  # the plans the sampler gives a forward: the last returned
    for i in range(_forwards(got)):
        given = bool(got[f"f{i}/given"])
        returned = f"f{i}/plans/mc" in got
        adaptive = f"f{i}/info/replanned" in got
        out = _jforward(given, returned, adaptive)(
            params, jnp.asarray(got[f"f{i}/x"]), jnp.asarray(got[f"f{i}/t"]),
            _jplan(last) if given else None,
            jnp.float32(case["threshold"]))
        outs = out if isinstance(out, tuple) else (out,)
        _close(got[f"f{i}/vel"], np.asarray(outs[0]), f"f{i} velocity vs "
               f"the reference")
        if adaptive:
            np.testing.assert_array_equal(
                got[f"f{i}/info/replanned"], np.asarray(outs[-1]["replanned"]))
            np.testing.assert_allclose(
                got[f"f{i}/info/retention"],
                np.asarray(outs[-1]["retention"]), atol=1e-6, rtol=0)
        if returned:
            mine = _stack(got, f"f{i}/plans")
            for n, leaf in mine.items():  # planning parity on one device
                np.testing.assert_array_equal(
                    one[f"part/f{i}/plans/{n}"], np.asarray(
                        getattr(outs[1], n)), err_msg=f"f{i} plans {n}")
            last = mine


def _check_serve_reference(case, got: dict) -> None:
    cfg = get_arch(DIT).smoke()
    js = JaxScheduler(jax_get_arch(DIT).smoke(), _jparams(DIT), num_slots=2,
                      seq_len=SEQ, backend="gather",
                      compute_dtype=jnp.float32, refresh_mode="adaptive",
                      drift_threshold=case["threshold"])
    for lat, t0 in zip(_inputs(case["name"])["latents"], case["t_starts"]):
        js.submit(lat, JaxDenoiseParams(num_steps=case["steps"],
                                        t_start=t0))
    done = js.drain()
    want = np.stack([r.result for r in done])
    assert want.shape == (3, SEQ, cfg.patch_dim)
    _close(got["results"], want, "final latents vs the reference")
    np.testing.assert_array_equal(
        got["stats"], [getattr(js.stats, n) for n in STATS])


def _check_prefill_reference(case, got: dict, one: dict) -> None:
    jcfg = jax_get_arch(LM).smoke()
    params = _jparams(LM)
    inputs = _inputs(case["name"])
    hidden, _, plans0 = jtransformer.prefill(
        params, jcfg, jnp.asarray(inputs["first"]), jnp.float32, "gather",
        return_plans=True)
    _close(got["logits0"], np.asarray(jcommon.logits_from_hidden(
        params, hidden)), "first prefill's logits vs the reference")
    for n in plan_lib.PLAN_LEAVES:  # planning parity on one device
        np.testing.assert_array_equal(one[f"part/plans0/{n}"],
                                      np.asarray(getattr(plans0, n)))
    hidden, _, plans1, info = jtransformer.prefill(
        params, jcfg, jnp.asarray(inputs["second"]), jnp.float32, "gather",
        plans=_jplan(_stack(got, "plans0")),
        drift_threshold=case["threshold"],
        return_plans=True)
    _close(got["logits1"], np.asarray(jcommon.logits_from_hidden(
        params, hidden)), "second prefill's logits vs the reference")
    np.testing.assert_array_equal(got["info/replanned"],
                                  np.asarray(info["replanned"]))
    for n in plan_lib.PLAN_LEAVES:
        np.testing.assert_array_equal(one[f"part/plans1/{n}"],
                                      np.asarray(getattr(plans1, n)))


def _decisions(one: dict, case) -> list:
    """Every scalar drift decision's (1 - retention) on one device."""
    if case["kind"] == "sample":
        return [1.0 - one[k] for k in one if k.endswith("/info/retention")]
    if case["kind"] == "prefill":
        return [1.0 - one["info/retention"]]
    return []


@pytest.mark.parametrize("name", list(BY_NAME))
def test_plan_reuse_over_a_mesh_matches_one_device_and_the_reference(
        name, ranks):
    case = BY_NAME[name]
    got = ranks(_world(case))[name]
    one = _one_device(name)
    assert bool(got["ranks_bitwise"])
    rows = "(None" if case["batch"] % case["mesh"][0] else "(('data',)"
    assert str(got["residual"]).startswith(rows), got["residual"]
    _check_one_device(case, got, one)
    for drift in _decisions(one, case):
        assert np.abs(np.asarray(drift) - case["threshold"]).min() \
            > MARGIN
    if case["kind"] == "sample":
        flags = got["trace/replanned"]
        assert flags.shape == (STEPS - 1, get_arch(DIT).smoke().num_layers)
        if case["mode"] == "adaptive":  # data-dependent, both outcomes
            assert 0 < int(flags.sum()) < flags.size
        _check_sample_reference(case, got, one)
    elif case["kind"] == "serve":
        stats = dict(zip(STATS, got["stats"].tolist()))
        assert stats["plan_replans"] > 0 and stats["plan_reuses"] > 0
        _check_serve_reference(case, got)
    else:
        assert 0 < int(got["info/replanned"].sum()) \
            < got["info/replanned"].size
        _check_prefill_reference(case, got, one)


@pytest.mark.parametrize("name", ["dit-2x2-adaptive", "dit-1x4-adaptive"])
def test_a_rank_alone_would_take_another_drift_decision(name, ranks):
    """The drift gate's records on every rank: for some layer, the
    decision a rank would take from its own rows' and heads' MIN differs
    from the global one every rank takes."""
    case = BY_NAME[name]
    got = ranks(_world(case))[name]
    differ = 0
    for r in range(_world(case)):
        for i in range(int(got["gate_calls"])):
            thr = case["threshold"]
            local = 1.0 - got[f"rank{r}/gate/{i}/local"] >= thr
            glob = 1.0 - got[f"rank{r}/gate/{i}/global"] >= thr
            differ += int(local != glob)
            assert got[f"rank{r}/gate/{i}/global"] == \
                got[f"rank0/gate/{i}/global"]
    assert differ > 0

