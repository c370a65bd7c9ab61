"""The port's DiT (repro_torch.models.dit) against the JAX DiT.

Both sides run the same weights — the JAX init, perturbed with seeded
numpy noise so that the zero-initialized leaves (output projection, SLA
Proj, norms) are live, and carried over with `repro_torch.bridge` — on
the same numpy latents, timesteps and conditioning, at f32. Velocities
and sampled latents agree within 1e-4 (atol and rtol); block plans and
per-(step, layer) re-plan flags are equal.

The bf16 cases run the DiT's default compute dtype and hold the port to
the bf16 conformance limit, 5e-2 x max(1, max |v|). Both sides then get
JAX's f32 plans (the planning-parity rule: top-k over bf16 scores can
flip a near-tied block between the two frameworks); the count of blocks
that differ when each side plans inline in bf16 is kept as the test's
user property `bf16_inline_plan_blocks_differ` (0 on wan2_1_1_3b and 1
on lightningdit_1b at these inputs, for every backend).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import dit as jdit
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.models import dit as tdit

TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = 5e-2  # tests/test_conformance.py's bf16 limit, x max(1, max |v|)
SEQ = 128  # 8 blocks of 16: enough structure for plans to drift
LEAVES = ("mc", "lut", "counts", "col_lut", "col_counts", "marginal")


def _models(arch, **sla_kw):
    jcfg, tcfg = jax_get_arch(arch).smoke(), get_arch(arch).smoke()
    if sla_kw:
        jcfg = dataclasses.replace(jcfg, sla=jcfg.sla.replace(**sla_kw))
        tcfg = dataclasses.replace(tcfg, sla=tcfg.sla.replace(**sla_kw))
    rs = np.random.default_rng(1)
    tree = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rs.standard_normal(a.shape))
        .astype(np.float32), jdit.init(jax.random.PRNGKey(0), jcfg))
    model = tdit.init(None, tcfg, device="cpu")
    model.load_state_dict(bridge.params_from_numpy(tree, device="cpu"))
    return jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree), model


@pytest.fixture(scope="module", params=["wan2_1_1_3b", "lightningdit_1b"])
def models(request):
    return _models(request.param)


def _inputs(cfg, b=2, seed=0):
    rs = np.random.default_rng(seed)
    lat = rs.standard_normal((b, SEQ, cfg.patch_dim), dtype=np.float32)
    cond = (rs.standard_normal((b, cfg.cond_len, cfg.d_model),
                               dtype=np.float32) if cfg.cross_attn else None)
    return lat, cond


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def test_bridge_fills_every_parameter(models):
    _, tcfg, jparams, model = models
    state = model.state_dict()
    assert len(state) == len(bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu"))
    assert torch.equal(state["layers.1.wq"],
                       _t(jparams["layers"]["wq"][1]))


def _plans_to_torch(pj):
    return bridge.plan_from_numpy({n: np.asarray(getattr(pj, n))
                                   for n in LEAVES}, device="cpu")


def _assert_bf16_close(got, want):
    """bf16 conformance: max |got - want| <= 5e-2 x max(1, max |want|)."""
    want = np.asarray(want, np.float32)
    limit = BF16_TOL * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert np.isfinite(err) and err <= limit, (err, limit)


@pytest.mark.parametrize("backend,dtype", [
    pytest.param(b, dt, id=b if dt == "f32" else f"{b}-bf16")
    for dt in ("f32", "bf16") for b in ("reference", "gather", "kernel")])
def test_forward_velocity_matches_jax(models, backend, dtype, request):
    jcfg, tcfg, jparams, model = models
    lat, cond = _inputs(tcfg)
    t = np.array([0.9, 0.35], np.float32)
    vj, pj = jdit.forward(jparams, jcfg, _j(lat), _j(t), _j(cond),
                          jnp.float32, backend, return_plans=True)
    if dtype == "bf16":
        # both sides execute on JAX's f32 plans; inline bf16 planning is
        # only counted
        _, pj16 = jdit.forward(jparams, jcfg, _j(lat), _j(t), _j(cond),
                               jnp.bfloat16, backend, return_plans=True)
        vj = jdit.forward(jparams, jcfg, _j(lat), _j(t), _j(cond),
                          jnp.bfloat16, backend, plans=pj)
        with torch.no_grad():
            _, pt16 = tdit.forward(model, tcfg, _t(lat), _t(t), _t(cond),
                                   torch.bfloat16, backend,
                                   return_plans=True)
            vt = tdit.forward(model, tcfg, _t(lat), _t(t), _t(cond),
                              torch.bfloat16, backend,
                              plans=_plans_to_torch(pj))
        differ = int((pt16.mc.numpy() != np.asarray(pj16.mc)).sum())
        request.node.user_properties.append(
            ("bf16_inline_plan_blocks_differ", differ))
        assert differ <= 0.01 * pt16.mc.numel()  # near-ties only
        assert vt.dtype == torch.bfloat16
        _assert_bf16_close(vt.float().numpy(), np.asarray(vj, np.float32))
        return
    with torch.no_grad():
        vt, pt = tdit.forward(model, tcfg, _t(lat), _t(t), _t(cond),
                              torch.float32, backend, return_plans=True)
    assert float(np.abs(np.asarray(vj)).max()) > 0.1  # a live velocity
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), **TOL)
    for name in LEAVES:  # (L, B, H, ...) plan stacks
        assert np.array_equal(getattr(pt, name).numpy(),
                              np.asarray(getattr(pj, name))), name


def test_forward_reused_plans_and_per_sample_refresh_match_jax(models):
    jcfg, tcfg, jparams, model = models
    lat, cond = _inputs(tcfg, seed=1)
    lat2, _ = _inputs(tcfg, seed=2)
    t = np.array([0.8, 0.5], np.float32)
    _, pj = jdit.forward(jparams, jcfg, _j(lat), _j(t), _j(cond),
                         jnp.float32, "kernel", return_plans=True)
    pt = _plans_to_torch(pj)
    thr = np.array([[0.0, 1.0]] * tcfg.num_layers, np.float32)
    vj, pj2, ij = jdit.forward(jparams, jcfg, _j(lat2), _j(t), _j(cond),
                               jnp.float32, "kernel", plans=pj,
                               return_plans=True, drift_threshold=_j(thr),
                               per_sample_refresh=True)
    with torch.no_grad():
        vt, pt2, it = tdit.forward(model, tcfg, _t(lat2), _t(t), _t(cond),
                                   torch.float32, "kernel", plans=pt,
                                   return_plans=True,
                                   drift_threshold=_t(thr),
                                   per_sample_refresh=True)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), **TOL)
    assert np.array_equal(it["replanned"].numpy(),
                          np.asarray(ij["replanned"]))
    assert it["replanned"][:, 0].all() and not it["replanned"][:, 1].any()
    np.testing.assert_allclose(it["retention"].numpy(),
                               np.asarray(ij["retention"]), atol=1e-6)
    for name in LEAVES:
        assert np.array_equal(getattr(pt2, name).numpy(),
                              np.asarray(getattr(pj2, name))), name


def _given_plans(forward, plans):
    """`forward` with `plans` in place of inline planning: a call that
    would plan (plans=None) executes on `plans` instead."""
    def wrapped(*a, plans=None, **kw):
        return forward(*a, plans=given if plans is None else plans, **kw)
    given = plans
    return wrapped


@pytest.mark.parametrize("mode,kw,dtype", [
    pytest.param("adaptive", dict(drift_threshold=0.25), "f32",
                 id="adaptive-kw0"),
    pytest.param("fixed", dict(refresh_interval=2), "f32", id="fixed-kw1"),
    pytest.param("fixed", dict(refresh_interval=4), "bf16", id="fixed-bf16"),
])
def test_sample_matches_jax(models, mode, kw, dtype, monkeypatch):
    """4-step Euler sampling on the kernel backend: final latent and the
    per-(step, layer) re-plan flags. In bf16 each layer plans once, at
    step 0 on the noise, and both samplers get JAX's f32 plans of that
    step in place of their inline planning."""
    jcfg, tcfg, jparams, model = models
    lat, cond = _inputs(tcfg, b=1, seed=3)
    jdt, tdt = jnp.float32, torch.float32
    if dtype == "bf16":
        jdt, tdt = jnp.bfloat16, torch.bfloat16
        _, pj = jdit.forward(jparams, jcfg, _j(lat), jnp.ones((1,)),
                             _j(cond), jnp.float32, "kernel",
                             return_plans=True)
        monkeypatch.setattr(jdit, "forward", _given_plans(jdit.forward, pj))
        monkeypatch.setattr(tdit, "forward",
                            _given_plans(tdit.forward, _plans_to_torch(pj)))
    xj, trj = jdit.sample(jparams, jcfg, _j(lat), num_steps=4,
                          cond=_j(cond), compute_dtype=jdt,
                          backend="kernel", refresh_mode=mode,
                          return_trace=True, **kw)
    xt, trt = tdit.sample(model, tcfg, _t(lat), num_steps=4, cond=_t(cond),
                          compute_dtype=tdt, backend="kernel",
                          refresh_mode=mode, return_trace=True, **kw)
    if dtype == "bf16":
        _assert_bf16_close(xt.float().numpy(), np.asarray(xj, np.float32))
    else:
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), **TOL)
    assert np.array_equal(trt["replanned"].numpy(),
                          np.asarray(trj["replanned"]))
    assert np.array_equal(trt["replan_count"].numpy(),
                          np.asarray(trj["replan_count"]))
    np.testing.assert_allclose(trt["retention"].numpy(),
                               np.asarray(trj["retention"]), atol=1e-6)
    if mode == "adaptive":  # data-dependent decisions, both outcomes
        assert 0 < int(trt["replanned"].sum()) < trt["replanned"].numel()


def test_scalar_vs_vector_t_bitwise_and_t_start(models):
    _, tcfg, _, model = models
    lat, cond = _inputs(tcfg)
    with torch.no_grad():
        a = tdit.forward(model, tcfg, _t(lat), 0.625, _t(cond),
                         torch.float32, "gather")
        b = tdit.forward(model, tcfg, _t(lat), torch.full((2,), 0.625),
                         _t(cond), torch.float32, "gather")
    assert torch.equal(a, b)
    # per-sample t_start: each row integrates its own trajectory. Batch
    # size changes the CPU GEMM blocking, so rows agree to f32 noise, not
    # bitwise as under XLA
    both = tdit.sample(model, tcfg, _t(lat), num_steps=2, cond=_t(cond),
                       compute_dtype=torch.float32, backend="gather",
                       t_start=[1.0, 0.5])
    row = tdit.sample(model, tcfg, _t(lat[1:]), num_steps=2,
                      cond=_t(None if cond is None else cond[1:]),
                      compute_dtype=torch.float32, backend="gather",
                      t_start=0.5)
    torch.testing.assert_close(both[1:], row, atol=1e-5, rtol=1e-5)


def test_slot_surgery_round_trip():
    _, tcfg, _, model = _models("lightningdit_1b")
    lat, _ = _inputs(tcfg, b=1)
    with torch.no_grad():
        _, row_plans = tdit.forward(model, tcfg, _t(lat), 0.5, None,
                                    torch.float32, "gather",
                                    return_plans=True)
    pool = torch.zeros((3, SEQ, tcfg.patch_dim))
    from repro_torch.core import plan as plan_lib
    proto = plan_lib.empty_plan(dataclasses.replace(tcfg.sla, causal=False),
                                3, tcfg.num_heads, SEQ // 16, SEQ // 16)
    plans = plan_lib.plan_map(lambda leaf: torch.stack(
        [leaf] * tcfg.num_layers), proto)
    pool, plans = tdit.insert_denoise_slot(pool, plans, 1, _t(lat),
                                           row_plans)
    assert torch.equal(tdit.retire_denoise_slot(pool, 1), _t(lat[0]))
    back = tdit.take_slot_plans(plans, 1)
    for name in LEAVES:
        assert torch.equal(getattr(back, name), getattr(row_plans, name))
    assert (plans.mc[:, 0] == -1).all() and (plans.mc[:, 2] == -1).all()


def test_init_is_seeded_and_refuses_missing_gpu():
    cfg = get_arch("lightningdit_1b").smoke()
    a = tdit.init(torch.Generator().manual_seed(3), cfg, device="cpu")
    b = tdit.init(torch.Generator().manual_seed(3), cfg, device="cpu")
    assert all(torch.equal(x, y) for x, y in
               zip(a.state_dict().values(), b.state_dict().values()))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdit.init(None, cfg)
