"""The conformance matrix (tests/test_conformance.py), port against JAX.

Every execution backend of `repro_torch.core.backends` is held to the
JAX backend of the same name — reference / gather / kernel (JAX: Pallas
in interpret mode; port: the CUDA kernel's plain twin on the CPU) — across
f32 / bf16, causal / bidirectional, and fresh / reused plans, on the same
numpy inputs and the same plan. Tolerances are the matrix's: f32 5e-5,
bf16 5e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backends as jbackends
from repro.core import plan as jplan
from repro.core import sla as jsla
from repro.core.config import SLAConfig as JaxSLAConfig
from repro.core.phi import phi as jphi
from repro_torch import bridge
from repro_torch.core import backends as tbackends
from repro_torch.core import sla as tsla
from repro_torch.core.config import SLAConfig
from repro_torch.core.phi import phi as tphi

BACKENDS = ("reference", "gather", "kernel")
TOL = {"f32": dict(atol=5e-5, rtol=5e-5), "bf16": dict(atol=5e-2, rtol=5e-2)}
JD = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TD = {"f32": torch.float32, "bf16": torch.bfloat16}
LEAVES = ("mc", "lut", "counts", "col_lut", "col_counts", "marginal")


def _cfgs(causal, phi_kind="softmax", mode="sla"):
    kw = dict(block_q=16, block_kv=16, kh_frac=0.25, kl_frac=0.25,
              causal=causal, phi=phi_kind, proj_init="identity", mode=mode)
    return JaxSLAConfig(**kw), SLAConfig(**kw)


def _round(x, dtype):
    return np.asarray(jnp.asarray(x, JD[dtype]), np.float32)


def _case(seed, dtype, causal, plan_state, phi_kind="softmax", b=1, h=2,
          n=128, d=16, hkv=None, mode="sla"):
    """Numpy q/k/v for one matrix cell plus the JAX plan for it. "reused"
    plans were built from earlier (q0, k0); the inputs then moved on."""
    jcfg, tcfg = _cfgs(causal, phi_kind, mode)
    rs = np.random.default_rng(seed)
    hkv = hkv or h
    q0 = _round(rs.standard_normal((b, h, n, d)), dtype)
    k0 = _round(rs.standard_normal((b, hkv, n, d)), dtype)
    jp = jplan.plan_attention(jnp.asarray(q0, JD[dtype]),
                              jnp.asarray(k0, JD[dtype]), jcfg)
    if plan_state == "reused":
        q = _round(q0 + 0.3 * rs.standard_normal(q0.shape), dtype)
        k = _round(k0 + 0.3 * rs.standard_normal(k0.shape), dtype)
    else:
        q, k = q0, k0
    v = _round(rs.standard_normal((b, hkv, n, d)), dtype)
    tp = bridge.plan_from_numpy({n_: np.asarray(getattr(jp, n_))
                                 for n_ in LEAVES}, device="cpu")
    return jcfg, tcfg, jp, tp, q, k, v


def _both(x, dtype):
    return jnp.asarray(x, JD[dtype]), torch.from_numpy(x).to(TD[dtype])


def _close(got, want, dtype, msg=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype],
                               err_msg=msg)


MATRIX = [
    pytest.param(backend, dtype, causal, plan_state,
                 id=f"{backend}-{dtype}-"
                    f"{'causal' if causal else 'bidir'}-{plan_state}")
    for backend in BACKENDS
    for dtype in ("f32", "bf16")
    for causal in (False, True)
    for plan_state in ("fresh", "reused")
]


@pytest.mark.parametrize("backend,dtype,causal,plan_state", MATRIX)
def test_backend_forward_matches_jax(backend, dtype, causal, plan_state):
    """(O^s, O^l) of each port backend match the JAX backend's."""
    jcfg, tcfg, jp, tp, q, k, v = _case(0, dtype, causal, plan_state)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, k, v))
    want = jbackends.get_backend(backend)(
        jp, jq, jk, jv, jphi(jq, jcfg.phi), jphi(jk, jcfg.phi), jcfg, None)
    got = tbackends.get_backend(backend)(
        tp, tq, tk, tv, tphi(tq, tcfg.phi), tphi(tk, tcfg.phi), tcfg, None)
    for name, g, w in zip(("O^s", "O^l"), got, want):
        assert g.dtype == torch.float32
        _close(g, w, dtype, f"{backend} {name}")


@pytest.mark.parametrize("backend,dtype,causal,plan_state", MATRIX)
def test_public_api_matches_jax(backend, dtype, causal, plan_state):
    """The same matrix through sla_attention (Proj merge, Eq. 6)."""
    jcfg, tcfg, jp, tp, q, k, v = _case(1, dtype, causal, plan_state)
    rs = np.random.default_rng(2)
    proj = (0.3 * rs.standard_normal((2, 16, 16))).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, k, v))
    want = jsla.sla_attention({"proj": jnp.asarray(proj)}, jq, jk, jv, jcfg,
                              backend=backend, plan=jp)
    got = tsla.sla_attention({"proj": torch.from_numpy(proj)}, tq, tk, tv,
                             tcfg, backend=backend, plan=tp)
    assert got.dtype == TD[dtype]
    _close(got, want, dtype, backend)


@pytest.mark.parametrize("phi_kind", ["elu1", "relu"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_phi_variants_match_jax(backend, phi_kind):
    jcfg, tcfg, jp, tp, q, k, v = _case(3, "f32", False, "fresh",
                                        phi_kind=phi_kind)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, "f32") for x in (q, k, v))
    _, want = jbackends.get_backend(backend)(
        jp, jq, jk, jv, jphi(jq, phi_kind), jphi(jk, phi_kind), jcfg, None)
    _, got = tbackends.get_backend(backend)(
        tp, tq, tk, tv, tphi(tq, phi_kind), tphi(tk, phi_kind), tcfg, None)
    _close(got, want, "f32", phi_kind)


@pytest.mark.parametrize("mode", ["full", "linear_only", "sparse_only",
                                  "l_plus_s"])
@pytest.mark.parametrize("causal", [False, True])
def test_modes_match_jax(mode, causal):
    jcfg, tcfg, jp, tp, q, k, v = _case(4, "f32", causal, "fresh",
                                        mode=mode)
    proj = np.eye(16, dtype=np.float32)[None].repeat(2, 0) * 0.5
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, "f32") for x in (q, k, v))
    want = jbackends.execute(jp, {"proj": jnp.asarray(proj)}, jq, jk, jv,
                             jcfg, backend="gather")
    got = tbackends.execute(tp, {"proj": torch.from_numpy(proj)}, tq, tk,
                            tv, tcfg, backend="gather")
    _close(got, want, "f32", mode)


@pytest.mark.parametrize("backend", BACKENDS)
def test_gqa_and_inline_planning_match_jax(backend):
    """KV-head broadcast (GQA) with the plan built inline on each side."""
    jcfg, tcfg, _, _, q, k, v = _case(5, "f32", False, "fresh", h=4, hkv=2)
    params = jsla.sla_init(None, 4, 16, jcfg)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, "f32") for x in (q, k, v))
    want = jsla.sla_attention(params, jq, jk, jv, jcfg, backend=backend)
    got = tsla.sla_attention(tsla.sla_init(4, 16, tcfg), tq, tk, tv, tcfg,
                             backend=backend)
    _close(got, want, "f32", backend)


def test_resolve_aliases_and_loud_failures():
    assert tbackends.available_backends() == ("gather", "kernel",
                                              "reference")
    assert tbackends.resolve("pallas") == "kernel"
    assert tbackends.resolve("xla") == "gather"
    assert tbackends.resolve("dense") == "reference"
    with pytest.raises(ValueError, match="unknown SLA backend"):
        tbackends.resolve("cuda")
    _, tcfg, _, tp, q, k, v = _case(6, "f32", False, "fresh")
    t = torch.from_numpy(np.concatenate([q, q], axis=2))
    with pytest.raises(ValueError, match="stale SLAPlan"):
        tsla.sla_attention(tsla.sla_init(2, 16, tcfg), t, t, t, tcfg,
                           plan=tp)


def test_kernel_backend_is_forward_only():
    """Inputs that require grad are refused with a pointer to the
    training slice; the gather backend differentiates."""
    _, tcfg, _, tp, q, k, v = _case(7, "f32", False, "fresh")
    tq = torch.from_numpy(q).requires_grad_()
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    params = tsla.sla_init(2, 16, tcfg)
    with pytest.raises(RuntimeError, match="forward-only"):
        tsla.sla_attention(params, tq, tk, tv, tcfg, backend="kernel",
                           plan=tp)
    out = tsla.sla_attention(params, tq, tk, tv, tcfg, backend="gather",
                             plan=tp)
    out.sum().backward()
    assert tq.grad is not None and torch.isfinite(tq.grad).all()
    with torch.no_grad():
        tsla.sla_attention(params, tq, tk, tv, tcfg, backend="kernel",
                           plan=tp)
