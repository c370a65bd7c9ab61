"""The port's cross-request plan cache against the JAX package's.

* `plan_compat_key`: the same tuple as the reference's for the same
  config and shape, telling apart the same fields.
* `serialize_plan`: leaves bitwise equal to the reference's for the same
  bridged plan; the round trip is bitwise and a wrong version refused.
* `PlanCache`: the port's and the reference's get the same script of
  `get` / `put` / `put_if_absent` / `update` calls at a small
  `max_entries`; counters, `len()` and returned stacks are equal,
  bitwise. The bucket of t agrees at the edges.
* The DiffusionScheduler with `plan_cache=True` on the reference's
  plan-cache trace (`benchmarks/fig_dit_serving.py`: smoke model, seq 32,
  2 slots, 6 requests of 4 steps, adaptive, threshold 0.3, 8 buckets) on
  the kernel and gather backends against the JAX scheduler on the gather
  backend: every ServeStats counter equal (hits 5, misses 1, plan builds
  one miss's layers), final latents within atol = rtol = 1e-4; at
  lightningdit_1b and at wan2_1_1_3b (cross-attention).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.configs import get_arch as jax_get_arch
from repro.core import plan as jplan
from repro.models import dit as jdit
from repro.serving.diffusion import DenoiseParams as JaxDenoiseParams
from repro.serving.diffusion import DiffusionScheduler as JaxScheduler
from repro.serving.plan_cache import PlanCache as JaxPlanCache
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.core import plan as tplan
from repro_torch.models import dit as tdit
from repro_torch.serving.api import RequestState, ServeStats
from repro_torch.serving.diffusion import DenoiseParams, DiffusionScheduler
from repro_torch.serving.plan_cache import PlanCache

TOL = dict(atol=1e-4, rtol=1e-4)
SEQ = 32  # the reference's plan-cache stage
CACHE_REQS, CACHE_STEPS, CACHE_THRESHOLD, T_BUCKETS = 6, 4, 0.3, 8
# ServeStats fields that are wall-clock times, not counters
TIMES = ("prefill_s", "decode_s", "max_decode_gap_s")


def _sla_pair(arch="lightningdit_1b"):
    jcfg, tcfg = jax_get_arch(arch).smoke(), get_arch(arch).smoke()
    return (dataclasses.replace(jcfg.sla, causal=False),
            dataclasses.replace(tcfg.sla, causal=False), jcfg)


def _jax_stack(jsla, cfg, seed, heads=None, seq=SEQ):
    """Per-layer stacked batch-1 JAX plans (leaves (L, 1, ...)), the way
    the scheduler stores them."""
    h, dh = heads or cfg.num_heads, cfg.head_dim
    rows = []
    for layer in range(cfg.num_layers):
        r = jax.random.split(jax.random.PRNGKey(seed + 17 * layer), 2)
        q = jax.random.normal(r[0], (1, h, seq, dh), jnp.float32)
        k = jax.random.normal(r[1], (1, h, seq, dh), jnp.float32)
        rows.append(jplan.plan_attention(q, k, jsla))
    return jax.tree_util.tree_map(lambda *ls: jnp.stack(ls), *rows)


def _bridge(jstack):
    return bridge.plan_from_numpy(
        {name: np.asarray(getattr(jstack, name))
         for name in tplan.PLAN_LEAVES}, device="cpu")


def _assert_plans_equal(tp, jp):
    for name in tplan.PLAN_LEAVES:
        a, b = getattr(tp, name).numpy(), np.asarray(getattr(jp, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


# ---------------------------------------------------------------------------
# compat key + serialization
# ---------------------------------------------------------------------------
CHANGES = [("block_q", 32), ("block_kv", 32), ("kh_frac", 0.4),
           ("kl_frac", 0.35), ("mode", "sparse_only"), ("causal", True),
           ("force_diagonal", False), ("fixed_budget", 2),
           ("col_capacity_factor", None), ("routing_mode", "learned"),
           ("window", 64)]


@pytest.mark.parametrize("field,value", CHANGES,
                         ids=[f for f, _ in CHANGES])
def test_compat_key_equals_reference_and_tells_fields_apart(field, value):
    jsla, tsla, _ = _sla_pair()
    base = tplan.plan_compat_key(tsla, 4, 2, 2)
    assert base == jplan.plan_compat_key(jsla, 4, 2, 2)
    jo = dataclasses.replace(jsla, **{field: value})
    to = dataclasses.replace(tsla, **{field: value})
    key = tplan.plan_compat_key(to, 4, 2, 2)
    assert key == jplan.plan_compat_key(jo, 4, 2, 2)
    assert key != base


def test_compat_key_shapes_and_execution_fields():
    jsla, tsla, _ = _sla_pair()
    base = tplan.plan_compat_key(tsla, 4, 2, 2)
    for shape in ((8, 2, 2), (4, 4, 2), (4, 2, 4)):
        assert tplan.plan_compat_key(tsla, *shape) == \
            jplan.plan_compat_key(jsla, *shape) != base
    # execution-only fields keep cached structure
    for field, value in (("phi", "relu"), ("decode_mode", "sla")):
        other = dataclasses.replace(tsla, **{field: value})
        assert tplan.plan_compat_key(other, 4, 2, 2) == base


def test_serialize_matches_reference_and_round_trips():
    jsla, _, cfg = _sla_pair()
    jstack = _jax_stack(jsla, cfg, seed=3)
    tstack = _bridge(jstack)
    tdata, jdata = tplan.serialize_plan(tstack), jplan.serialize_plan(jstack)
    assert list(tdata) == list(jdata)  # version first, leaves in order
    assert tdata["__version__"] == jdata["__version__"]
    for name in tplan.PLAN_LEAVES:
        a, b = tdata[name], jdata[name]
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), name
    back = tplan.deserialize_plan(tdata, "cpu")
    _assert_plans_equal(back, jstack)
    # neither side aliases the other: the entry outlives in-place writes
    tstack.mc.fill_(7)
    assert (tdata["mc"] != 7).any()
    tdata["lut"][...] = -5
    assert (back.lut != -5).any()
    # a reference entry deserializes in the port, bitwise
    _assert_plans_equal(tplan.deserialize_plan(jdata, "cpu"), jstack)
    tdata["__version__"] = 99
    with pytest.raises(ValueError, match="wire version"):
        tplan.deserialize_plan(tdata, "cpu")


# ---------------------------------------------------------------------------
# PlanCache against the reference on one call script
# ---------------------------------------------------------------------------
def _script(nl):
    """(op, bucket, stack seed, replanned flags) calls; max_entries is
    2 * nl + 1, so the LRU evicts buckets in part too."""
    one = np.zeros((nl,), bool)
    one[0] = True
    return [("get", 3, None, None), ("put", 3, 1, None),
            ("get", 3, None, None), ("put_if_absent", 3, 2, None),
            ("put_if_absent", 5, 2, None), ("update", 3, 4, one),
            ("get", 3, None, None), ("put", 0, 1, None),
            ("get", 5, None, None), ("put", 1, 4, None),
            ("get", 3, None, None), ("get", 1, None, None),
            ("update", 1, 2, np.ones((nl, 2), bool)),
            ("put_if_absent", 1, 1, None), ("get", 0, None, None),
            ("put", 6, 2, None), ("get", 1, None, None),
            ("update", 6, 1, np.zeros((nl,), bool)),
            ("get", 6, None, None), ("get", 7, None, None)]


def test_plan_cache_matches_reference_on_a_call_script():
    jsla, tsla, cfg = _sla_pair()
    nl = cfg.num_layers
    jc = JaxPlanCache(jsla, nl, t_buckets=8, max_entries=2 * nl + 1)
    tc = PlanCache(tsla, nl, t_buckets=8, max_entries=2 * nl + 1,
                   device="cpu")
    stacks = {s: _jax_stack(jsla, cfg, seed=s) for s in (1, 2, 4)}
    hits = 0
    for op, bucket, seed, flags in _script(nl):
        if op == "get":
            a, b = tc.get(bucket), jc.get(bucket)
            assert (a is None) == (b is None), (op, bucket)
            if a is not None:
                assert all(getattr(a, n).device.type == "cpu"
                           for n in tplan.PLAN_LEAVES)
                _assert_plans_equal(a, b)
                hits += 1
        else:
            args = (bucket, _bridge(stacks[seed])) + (
                () if flags is None else (flags,))
            ret = getattr(tc, op)(*args)
            want = getattr(jc, op)(bucket, stacks[seed], *(
                () if flags is None else (flags,)))
            assert ret == want, (op, bucket)
        assert tc.stats() == jc.stats(), (op, bucket)
        assert len(tc) == len(jc)
    st = tc.stats()
    assert hits >= 4 and st["evictions"] > 0 and st["invalidations"] > 0
    assert tc.host_bytes() == sum(
        a.nbytes for e in jc._entries.values()
        for n, a in e.items() if n != "__version__")


def test_plan_cache_refuses_what_the_reference_refuses():
    jsla, tsla, cfg = _sla_pair()
    nl = cfg.num_layers
    for kw in (dict(t_buckets=0), dict(max_entries=nl - 1)):
        with pytest.raises(ValueError):
            JaxPlanCache(jsla, nl, **kw)
        with pytest.raises(ValueError, match="t_buckets|max_entries"):
            PlanCache(tsla, nl, device="cpu", **kw)
    tc = PlanCache(tsla, nl, device="cpu")
    jc = JaxPlanCache(jsla, nl)
    small, wide = (_jax_stack(jsla, cfg, seed=1),
                   _jax_stack(jsla, cfg, seed=1, seq=2 * SEQ))
    tc.put(0, _bridge(small))
    jc.put(0, small)
    with pytest.raises(ValueError, match="incompatible"):
        jc.put(1, wide)
    with pytest.raises(ValueError, match="incompatible"):
        tc.put(1, _bridge(wide))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PlanCache(tsla, nl)


@pytest.mark.parametrize("t", [0.0, 1 / 8, 1.0, 1.5, -0.25, 0.999, 0.5])
def test_bucket_of_t_matches_reference(t):
    jsla, tsla, cfg = _sla_pair()
    for buckets in (1, 8):
        assert PlanCache(tsla, cfg.num_layers, t_buckets=buckets,
                         device="cpu").bucket(t) == JaxPlanCache(
            jsla, cfg.num_layers, t_buckets=buckets).bucket(t)


# ---------------------------------------------------------------------------
# the scheduler on the reference's plan-cache trace
# ---------------------------------------------------------------------------
def _models(arch):
    """Bridged smoke DiT weights, perturbed so that the velocity (and the
    latent comparison) is not trivially zero."""
    jcfg, tcfg = jax_get_arch(arch).smoke(), get_arch(arch).smoke()
    rs = np.random.default_rng(1)
    tree = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rs.standard_normal(a.shape))
        .astype(np.float32), jdit.init(jax.random.PRNGKey(0), jcfg))
    model = tdit.init(None, tcfg, device="cpu")
    model.load_state_dict(bridge.params_from_numpy(tree, device="cpu"))
    return jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree), model


def _trace(cfg):
    """The reference stage's latents (`_latent(cfg, i)`), plus a seeded
    text condition per request where the model cross-attends."""
    rs = np.random.default_rng(7)
    out = []
    for i in range(CACHE_REQS):
        lat = np.asarray(jax.random.normal(
            jax.random.PRNGKey(i + 1), (SEQ, cfg.patch_dim), jnp.float32))
        cond = (rs.standard_normal((cfg.cond_len, cfg.d_model),
                                   dtype=np.float32)
                if cfg.cross_attn else None)
        out.append((lat, cond))
    return out


def _drain(sched, trace, params_cls):
    for lat, cond in trace:
        sched.submit(lat, params_cls(num_steps=CACHE_STEPS), cond=cond)
    sched.drain()
    return sched


KW = dict(num_slots=2, seq_len=SEQ, refresh_mode="adaptive",
          drift_threshold=CACHE_THRESHOLD, plan_cache=True,
          t_buckets=T_BUCKETS)


@pytest.fixture(scope="module", params=["lightningdit_1b", "wan2_1_1_3b"])
def reference_run(request):
    jcfg, tcfg, jparams, model = _models(request.param)
    trace = _trace(tcfg)
    js = _drain(JaxScheduler(jcfg, jparams, backend="gather",
                             compute_dtype=jnp.float32, **KW),
                trace, JaxDenoiseParams)
    return tcfg, model, trace, js


@pytest.mark.parametrize("backend", ["kernel", "gather"])
def test_plan_cache_scheduler_matches_jax_scheduler(reference_run, backend):
    tcfg, model, trace, js = reference_run
    ts = _drain(DiffusionScheduler(tcfg, model, backend=backend,
                                   compute_dtype=torch.float32,
                                   device="cpu", **KW), trace, DenoiseParams)
    for f in dataclasses.fields(ServeStats):
        a, b = getattr(ts.stats, f.name), getattr(js.stats, f.name)
        if f.name == "last_retention":
            assert a == pytest.approx(b, abs=1e-5)
        elif f.name not in TIMES:
            assert a == b, f.name
    st = ts.stats
    # the reference stage's record: one miss fills the bucket, 5 hits
    assert (st.plan_cache_hits, st.plan_cache_misses) == (5, 1)
    assert st.plan_builds == tcfg.num_layers
    assert st.plan_cache_evictions == 0
    assert ts.cache.stats() == js.cache.stats()
    for a, b in zip(ts._requests, js._requests):
        assert a.state == RequestState.FINISHED
        assert a.result.shape == (SEQ, tcfg.patch_dim)
        np.testing.assert_allclose(a.result, b.result, **TOL,
                                   err_msg=f"rid {a.rid}")


def test_a_shared_cache_serves_a_second_scheduler():
    """A `PlanCache` passed to two schedulers: the second one's
    admissions hit the bucket the first filled and plan nothing; a cache
    on another device is refused."""
    _, tcfg, _, model = _models("lightningdit_1b")
    sla = dataclasses.replace(tcfg.sla, causal=False)
    shared = PlanCache(sla, tcfg.num_layers, device="cpu")
    kw = dict(KW, plan_cache=shared)
    trace = _trace(tcfg)[:2]
    first = _drain(DiffusionScheduler(tcfg, model, device="cpu", **kw),
                   trace, DenoiseParams)
    assert first.stats.plan_cache_misses == 1
    second = _drain(DiffusionScheduler(tcfg, model, device="cpu", **kw),
                    trace, DenoiseParams)
    # the counters are the shared cache's, fleet-wide: 1 + 2 hits
    assert (second.stats.plan_cache_hits, second.stats.plan_builds) == (3, 0)
    assert second.cache is shared and shared.stats()["misses"] == 1
    with pytest.raises(ValueError, match="plan cache serves"):
        DiffusionScheduler(tcfg, model, device="cpu", **dict(
            KW, plan_cache=PlanCache(sla, tcfg.num_layers, device="meta")))
