"""Planning parity: repro_torch.core.{masks,plan} against repro.core.

Integer structure (mc, lut, counts, col_lut, col_counts) must be bitwise
equal; float score maps and retentions agree within f32 noise (1e-6).
Classification is held two ways: on the SAME score map (bitwise, any
input), and end to end from (q, k) on inputs without near-ties.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.core import masks as jmasks
from repro.core import plan as jplan
from repro.core.config import SLAConfig as JaxSLAConfig
from repro_torch.core import masks as tmasks
from repro_torch.core import plan as tplan
from repro_torch.core.config import SLAConfig

F32_TOL = dict(atol=1e-6, rtol=1e-6)
INT_LEAVES = ("mc", "lut", "counts", "col_lut", "col_counts")

CFGS = {
    "bidir": dict(block_q=16, block_kv=16, kh_frac=0.25, kl_frac=0.25),
    "causal": dict(block_q=16, block_kv=16, kh_frac=0.25, kl_frac=0.25,
                   causal=True),
    "window": dict(block_q=16, block_kv=16, kh_frac=0.5, kl_frac=0.1,
                   window=32),
    "uncapped": dict(block_q=16, block_kv=16, kh_frac=0.5, kl_frac=0.25,
                     col_capacity_factor=None),
    "tight_cap": dict(block_q=16, block_kv=16, kh_frac=0.5, kl_frac=0.0,
                      col_capacity_factor=1.0),
    "rect": dict(block_q=32, block_kv=16, kh_frac=0.25, kl_frac=0.25),
    "wan_fracs": dict(block_q=16, block_kv=16, kh_frac=0.05, kl_frac=0.10),
}


def _cfgs(name):
    return JaxSLAConfig(**CFGS[name]), SLAConfig(**CFGS[name])


def _qk(seed, b=2, h=2, n=256, d=16, hkv=None):
    rs = np.random.default_rng(seed)
    q = rs.standard_normal((b, h, n, d), dtype=np.float32)
    k = rs.standard_normal((b, hkv or h, n, d), dtype=np.float32)
    return q, k


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_plan_equal(jp, tp, float_tol=None):
    for name in INT_LEAVES:
        a, b = _np(getattr(jp, name)), _np(getattr(tp, name))
        assert a.dtype == b.dtype, name
        assert np.array_equal(a, b), name
    if float_tol is None:
        assert np.array_equal(_np(jp.marginal), _np(tp.marginal))
    else:
        np.testing.assert_allclose(_np(tp.marginal), _np(jp.marginal),
                                   **float_tol)


@pytest.mark.parametrize("name", list(CFGS))
def test_classify_same_scores_bitwise(name):
    jcfg, tcfg = _cfgs(name)
    q, k = _qk(0)
    pc = np.asarray(jmasks.predict_pc(jnp.asarray(q), jnp.asarray(k), jcfg))
    want = np.asarray(jmasks.classify_blocks(jnp.asarray(pc), jcfg))
    got = tmasks.classify_blocks(torch.from_numpy(pc), tcfg).numpy()
    assert got.dtype == np.int8 and np.array_equal(got, want)


@pytest.mark.parametrize("name", list(CFGS))
def test_luts_bitwise_given_same_mc(name):
    jcfg, tcfg = _cfgs(name)
    q, k = _qk(1)
    jp = jplan.plan_attention(jnp.asarray(q), jnp.asarray(k), jcfg)
    tp = tplan.plan_from_mask(torch.from_numpy(np.asarray(jp.mc)), tcfg)
    _assert_plan_equal(jp, tp)
    assert tp.k_sel == jp.k_sel and tp.w_col == jp.w_col


@pytest.mark.parametrize("name", list(CFGS))
@pytest.mark.parametrize("seed", [2, 3])
def test_plan_attention_end_to_end(name, seed):
    """No near-ties in these inputs: the score maps agree to f32 noise
    and the whole plan is equal."""
    jcfg, tcfg = _cfgs(name)
    q, k = _qk(seed)
    jpc = np.asarray(jmasks.predict_pc(jnp.asarray(q), jnp.asarray(k), jcfg))
    tpc = tmasks.predict_pc(torch.from_numpy(q), torch.from_numpy(k), tcfg)
    np.testing.assert_allclose(tpc.numpy(), jpc, **F32_TOL)
    jp = jplan.plan_attention(jnp.asarray(q), jnp.asarray(k), jcfg)
    tp = tplan.plan_attention(torch.from_numpy(q), torch.from_numpy(k), tcfg)
    _assert_plan_equal(jp, tp)


def test_plan_attention_gqa_broadcasts_kv_heads():
    jcfg, tcfg = _cfgs("bidir")
    q, k = _qk(4, h=4, hkv=2)
    jp = jplan.plan_attention(jnp.asarray(q), jnp.asarray(k), jcfg)
    tp = tplan.plan_attention(torch.from_numpy(q), torch.from_numpy(k), tcfg)
    _assert_plan_equal(jp, tp)


def test_learned_routing_identity_and_gates():
    """Identity-initialized learned routing plans exactly like threshold
    routing; the marginal gates are forward-equal to the hard mask."""
    jcfg, tcfg = _cfgs("bidir")
    jcfg = dataclasses.replace(jcfg, routing_mode="learned")
    tcfg = dataclasses.replace(tcfg, routing_mode="learned")
    q, k = _qk(5)
    jr = jmasks.routing_init(2, 16)
    rs = np.random.default_rng(6)
    jr = {n: np.asarray(w) + 0.1 * rs.standard_normal(w.shape)
          .astype(np.float32) for n, w in jr.items()}
    tr = {n: torch.from_numpy(w) for n, w in jr.items()}
    jp = jplan.plan_attention(jnp.asarray(q), jnp.asarray(k), jcfg,
                              routing={n: jnp.asarray(w)
                                       for n, w in jr.items()})
    tp = tplan.plan_attention(torch.from_numpy(q), torch.from_numpy(k),
                              tcfg, routing=tr)
    _assert_plan_equal(jp, tp)
    eye = tmasks.routing_init(2, 16)
    a = tplan.plan_attention(torch.from_numpy(q), torch.from_numpy(k),
                             tcfg, routing=eye)
    b = tplan.plan_attention(torch.from_numpy(q), torch.from_numpy(k),
                             _cfgs("bidir")[1])
    assert torch.equal(a.mc, b.mc)
    with pytest.raises(ValueError, match="routing parameters"):
        tplan.plan_attention(torch.from_numpy(q), torch.from_numpy(k), tcfg)


@pytest.mark.parametrize("thr", [0.0, 0.05, 1.0])
def test_refresh_plan_agrees(thr):
    jcfg, tcfg = _cfgs("bidir")
    q0, k0 = _qk(7)
    q1, k1 = (x + 0.6 * y for x, y in zip(_qk(7), _qk(8)))
    jp0 = jplan.plan_attention(jnp.asarray(q0), jnp.asarray(k0), jcfg)
    tp0 = tplan.plan_from_mask(torch.from_numpy(np.asarray(jp0.mc)), tcfg)
    jp, jret, jrep = jplan.refresh_plan(jp0, jnp.asarray(q1),
                                        jnp.asarray(k1), jcfg, thr)
    tp, tret, trep = tplan.refresh_plan(tp0, torch.from_numpy(q1),
                                        torch.from_numpy(k1), tcfg, thr)
    np.testing.assert_allclose(float(tret), float(jret), **F32_TOL)
    assert bool(trep) == bool(jrep)
    _assert_plan_equal(jp, tp)


def test_refresh_plan_per_sample_agrees():
    """Per-row decisions (force / measure / pin) and every leaf."""
    jcfg, tcfg = _cfgs("bidir")
    q0, k0 = _qk(9, b=3)
    q1, k1 = (x + 0.6 * y for x, y in zip(_qk(9, b=3), _qk(10, b=3)))
    thr = np.array([0.0, 0.05, 1.0], np.float32)
    jp0 = jplan.plan_attention(jnp.asarray(q0), jnp.asarray(k0), jcfg)
    tp0 = tplan.plan_from_mask(torch.from_numpy(np.asarray(jp0.mc)), tcfg)
    jp, jret, jrep = jplan.refresh_plan_per_sample(
        jp0, jnp.asarray(q1), jnp.asarray(k1), jcfg, thr)
    tp, tret, trep = tplan.refresh_plan_per_sample(
        tp0, torch.from_numpy(q1), torch.from_numpy(k1), tcfg,
        torch.from_numpy(thr))
    np.testing.assert_allclose(tret.numpy(), np.asarray(jret), **F32_TOL)
    assert np.array_equal(trep.numpy(), np.asarray(jrep))
    assert bool(trep[0]) and not bool(trep[2])
    _assert_plan_equal(jp, tp)
    # the same rows through plan_drift
    np.testing.assert_allclose(
        tplan.plan_drift(tp0, torch.from_numpy(q1), torch.from_numpy(k1),
                         tcfg).numpy(),
        np.asarray(jplan.plan_drift(jp0, jnp.asarray(q1), jnp.asarray(k1),
                                    jcfg)), **F32_TOL)


def test_empty_plan_and_stats_equal():
    jcfg, tcfg = _cfgs("bidir")
    jp = jplan.empty_plan(jcfg, 2, 3, 4, 4)
    tp = tplan.empty_plan(tcfg, 2, 3, 4, 4)
    _assert_plan_equal(jp, tp)
    q, k = _qk(11)
    jp = jplan.plan_attention(jnp.asarray(q), jnp.asarray(k), jcfg)
    tp = tplan.plan_attention(torch.from_numpy(q), torch.from_numpy(k), tcfg)
    js, ts = jp.stats(), tp.stats()
    for key in js:
        assert float(ts[key]) == pytest.approx(float(js[key]))
    ss = tmasks.sparsity_stats(tp.mc)
    assert float(ss["sparsity"]) == pytest.approx(float(js["sparsity"]))


def test_expand_mask_and_stale_plan_errors():
    mc = np.random.default_rng(12).integers(-1, 2, (1, 2, 3, 4)) \
        .astype(np.int8)
    want = np.asarray(jmasks.expand_mask(jnp.asarray(mc), 2, 3))
    got = tmasks.expand_mask(torch.from_numpy(mc), 2, 3).numpy()
    assert np.array_equal(got, want)
    _, tcfg = _cfgs("bidir")
    q, k = _qk(13)
    tp = tplan.plan_attention(torch.from_numpy(q), torch.from_numpy(k), tcfg)
    q2 = torch.from_numpy(np.concatenate([q, q], axis=2))
    with pytest.raises(ValueError, match="stale SLAPlan"):
        tplan.plan_drift(tp, q2, q2, tcfg)
