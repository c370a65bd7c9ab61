"""Gradients through the port's kernel op against the reference's
custom_vjp.

`repro_torch.kernels.ops.sla_attention_core` (a `torch.autograd.Function`
whose backward runs the dQ and dK/dV kernels, here their plain twins on
CPU tensors, and the linear-branch matmuls) is held to
`repro.kernels.ops.sla_attention_core` (custom_vjp over the Pallas
kernels in interpret mode) on the same numpy inputs and the same plan:
gradients of q, k, v, qp and kp of one random linear functional of
(O^s, O^l), for fresh and stale plans, causal and not, in f32, within
5e-5 x max(1, max |g|).

Routing gradients mirror tests/test_routing.py: exactly zero through the
kernel backend (the plan is a constant there), non-zero through gather
and reference, where they also match JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.core import plan as jplan
from repro.core import sla as jsla
from repro.core.config import SLAConfig as JaxSLAConfig
from repro.core.masks import routing_init as jrouting_init
from repro.core.phi import phi as jphi
from repro.kernels import ops as jops
from repro_torch import bridge
from repro_torch.core import plan as tplan
from repro_torch.core import sla as tsla
from repro_torch.core.config import SLAConfig
from repro_torch.core.masks import routing_init
from repro_torch.core.phi import phi as tphi
from repro_torch.kernels import ops, sla_bwd

TOL = 5e-5
NAMES = ("q", "k", "v", "qp", "kp")
LEAVES = ("mc", "lut", "counts", "col_lut", "col_counts", "marginal")


def _close(got, want, name, tol=TOL):
    want = np.asarray(want)
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=atol,
                               rtol=0, err_msg=name)


def _setup(seed, stale, causal):
    kw = dict(block_q=16, block_kv=16, kh_frac=0.25, kl_frac=0.25,
              causal=causal)
    jcfg, tcfg = JaxSLAConfig(**kw), SLAConfig(**kw)
    rs = np.random.default_rng(seed)
    b, h, n, d = 1, 2, 128, 16
    q, k, v = (rs.standard_normal((b, h, n, d), dtype=np.float32)
               for _ in range(3))
    jp = jplan.plan_attention(jnp.asarray(q), jnp.asarray(k), jcfg)
    if stale:  # the plan stays; the inputs move on
        q = q + 0.3 * rs.standard_normal(q.shape).astype(np.float32)
        k = k + 0.3 * rs.standard_normal(k.shape).astype(np.float32)
    ws, wl = (rs.standard_normal((b, h, n, d), dtype=np.float32)
              for _ in range(2))
    tp = bridge.plan_from_numpy({name: np.asarray(getattr(jp, name))
                                 for name in LEAVES}, device="cpu")
    return jcfg, tcfg, jp, tp, (q, k, v), ws, wl


@pytest.mark.parametrize("causal", [False, True],
                         ids=["bidir", "causal"])
@pytest.mark.parametrize("stale", [False, True],
                         ids=["fresh-plan", "stale-plan"])
def test_kernel_op_grads_match_jax_custom_vjp(stale, causal):
    jcfg, tcfg, jp, tp, (q, k, v), ws, wl = _setup(3 + int(stale), stale,
                                                   causal)
    jin = [jnp.asarray(x) for x in (q, k, v)]
    jin += [jphi(jin[0], jcfg.phi), jphi(jin[1], jcfg.phi)]

    def jloss(*xs):
        o_s, o_l = jops.sla_attention_core(*xs, jp, jcfg)
        return jnp.sum(o_s * ws) + jnp.sum(o_l * wl)

    jg = jax.grad(jloss, argnums=tuple(range(5)))(*jin)

    tin = [torch.from_numpy(x) for x in (q, k, v)]
    tin += [tphi(tin[0], tcfg.phi), tphi(tin[1], tcfg.phi)]
    tin = [x.detach().requires_grad_() for x in tin]
    launches = (sla_bwd.LAUNCHES_DQ, sla_bwd.LAUNCHES_DKV)
    o_s, o_l = ops.sla_attention_core(*tin, tp, tcfg)
    loss = (o_s * torch.from_numpy(ws)).sum() \
        + (o_l * torch.from_numpy(wl)).sum()
    tg = torch.autograd.grad(loss, tin)
    assert (sla_bwd.LAUNCHES_DQ, sla_bwd.LAUNCHES_DKV) == launches
    for name, g, w in zip(NAMES, tg, jg):
        assert g.dtype == torch.float32 and float(g.abs().max()) > 0, name
        _close(g, w, name)


def test_none_cotangent_skips_its_branch():
    """Only O^s (or only O^l) in the loss: the other branch's cotangent
    is None, its inputs get no gradient from it, and the result equals
    the full backward with that cotangent set to zero."""
    _, tcfg, _, tp, (q, k, v), ws, wl = _setup(5, False, False)
    tin = [torch.from_numpy(x) for x in (q, k, v)]
    tin += [tphi(tin[0], tcfg.phi), tphi(tin[1], tcfg.phi)]
    tin = [x.detach().requires_grad_() for x in tin]
    o_s, o_l = ops.sla_attention_core(*tin, tp, tcfg)
    w = torch.from_numpy(ws)
    only_s = torch.autograd.grad((o_s * w).sum(), tin, retain_graph=True,
                                 allow_unused=True)
    both = torch.autograd.grad((o_s * w).sum() + (o_l * 0.0).sum(), tin,
                               retain_graph=True)
    assert only_s[3] is None and only_s[4] is None  # qp, kp: linear only
    for a, b in zip(only_s[:3], both[:3]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    only_l = torch.autograd.grad((o_l * torch.from_numpy(wl)).sum(), tin,
                                 allow_unused=True)
    assert only_l[0] is None and only_l[1] is None  # q, k: sparse only
    assert float(only_l[2].abs().max()) > 0  # v through the linear branch


# ---------------------------------------------------------------------------
# routing gradients: the plan's straight-through gates
# ---------------------------------------------------------------------------
def _routing_grads(backend, seed=6):
    kw = dict(block_q=16, block_kv=16, kh_frac=0.25, kl_frac=0.25,
              causal=False, col_capacity_factor=2.0, routing_mode="learned",
              proj_init="identity")
    rs = np.random.default_rng(seed)
    q, k, v = (rs.standard_normal((1, 2, 128, 16), dtype=np.float32)
               for _ in range(3))
    tcfg = SLAConfig(**kw)
    routing = {n: w.requires_grad_()
               for n, w in routing_init(2, 16).items()}
    params = tsla.sla_init(2, 16, tcfg)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    plan = tplan.plan_attention(tq, tk, tcfg, routing=routing)
    out = tsla.sla_attention(params, tq, tk, tv, tcfg, backend=backend,
                             plan=plan)
    tg = torch.autograd.grad((out.float() ** 2).sum(),
                             [routing["wq"], routing["wk"]])

    jcfg = JaxSLAConfig(**kw)
    jparams = jsla.sla_init(jax.random.PRNGKey(0), 2, 16, jcfg)

    def jloss(r):
        p = jplan.plan_attention(jnp.asarray(q), jnp.asarray(k), jcfg,
                                 routing=r)
        o = jsla.sla_attention(jparams, jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jcfg, backend=backend,
                               plan=p)
        return jnp.sum(o.astype(jnp.float32) ** 2)

    jg = jax.grad(jloss)(jrouting_init(2, 16))
    return tg, (jg["wq"], jg["wk"])


@pytest.mark.parametrize("backend", ["reference", "gather"])
def test_routing_grads_nonzero_and_match_jax_on_autodiff_backends(backend):
    tg, jg = _routing_grads(backend)
    for name, g, w in zip(("wq", "wk"), tg, jg):
        assert float(g.abs().max()) > 0, name
        _close(g, w, name, tol=1e-4)


def test_routing_grads_exactly_zero_through_kernel_backend():
    """The kernel op treats the plan as a constant: zero routing
    gradient, as the reference's custom_vjp returns."""
    tg, jg = _routing_grads("kernel")
    for g, w in zip(tg, jg):
        assert torch.count_nonzero(g) == 0
        assert float(jnp.abs(w).max()) == 0.0
