"""The MoE FFN and the MoE LM's serving path, port against JAX.

`repro_torch.models.moe` is held to `repro.models.moe` on the smoke
moonshot-v1-16b-a3b (d 128, 4 experts, top-2, expert width 64, a shared
expert) with JAX-initialized weights carried over by `bridge`, at f32:

- `moe_apply`'s output, aux loss and the gradients of x and every leaf
  within 5e-5 x max(1, max |ref|), in a call where capacity binds (slots
  drop) and one where it cannot; the routing integers (top-k experts,
  `keep`, `dst`) bitwise, on inputs whose k-th and (k+1)-th probabilities
  keep a margin (the premise is checked: one ulp of router difference may
  flip a near-tied expert, as in planning);
- exact ties go to the lower expert index, as `jax.lax.top_k`;
- the bridge carries the `moe` leaves and `compute_params` casts the
  experts once and keeps the router f32;
- the static engine serves the MoE LM with decode-time SLA on the kernel
  backend with the reference engine's tokens and counters, and the paged
  continuous Scheduler with the reference scheduler's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.configs import get_arch as jax_get_arch
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from repro_torch.serving.engine import Request, ServingEngine

TOL = 5e-5
BF16_TOL = 5e-2
ARCH = "moonshot-v1-16b-a3b"
MARGIN = 1e-5  # least gap between the k-th and (k+1)-th probability


def _cfgs(**kw):
    j, t = jax_get_arch(ARCH).smoke(), get_arch(ARCH).smoke()
    return dataclasses.replace(j, **kw), dataclasses.replace(t, **kw)


def _close(got, want, name, tol=TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    limit = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= limit, (name, err, limit)


def _jax_routing(params, x, cfg):
    """The reference's routing and dispatch lines (`repro.models.moe`,
    moe_apply: the top-k experts, keep and dst), in JAX."""
    e, k = cfg.num_experts, cfg.experts_per_token
    tokens = x.reshape(-1, x.shape[-1])
    cap = max(1, int(cfg.capacity_factor * tokens.shape[0] * k / e))
    probs = jax.nn.softmax(jnp.einsum(
        "td,de->te", tokens.astype(jnp.float32),
        params["router"].astype(jnp.float32)), axis=-1)
    _, eidx = jax.lax.top_k(probs, k)
    flat_e = eidx.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, e, dtype=jnp.int32)
    my_pos = jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, -1)
    keep = my_pos < cap
    dst = jnp.where(keep, flat_e * cap + my_pos, e * cap)
    return (np.asarray(probs), np.asarray(eidx), np.asarray(keep),
            np.asarray(dst), cap)


def _module(tcfg, params):
    mod = tmoe.moe_init(None, tcfg, device="cpu")
    mod.load_state_dict({n: torch.from_numpy(np.array(a))
                         for n, a in params.items()})
    return mod


CAP_CASES = [(0.5, True), (2.0, False)]


@pytest.mark.parametrize("capacity_factor,drops", CAP_CASES,
                         ids=["capacity-binds", "capacity-free"])
def test_moe_apply_matches_jax(capacity_factor, drops):
    """64 tokens, 4 experts, top-2: at factor 0.5 each expert takes 16 of
    128 slots, so slots drop; at 2.0 it takes 64, a slot for every token,
    so none can."""
    jcfg, tcfg = _cfgs(capacity_factor=capacity_factor)
    params = jax.tree_util.tree_map(
        np.asarray, jmoe.moe_init(jax.random.PRNGKey(3), jcfg))
    rs = np.random.default_rng(5)
    x = rs.standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    cot = rs.standard_normal(x.shape).astype(np.float32)
    probs, eidx, keep, dst, cap = _jax_routing(params, x, jcfg)
    top = np.sort(probs, axis=-1)[:, ::-1]
    k = jcfg.experts_per_token
    assert float((top[:, k - 1] - top[:, k]).min()) > MARGIN  # the premise
    assert bool((~keep).any()) == drops

    def objective(p, xx):
        out, aux = jmoe.moe_apply(p, xx, jcfg)
        return jnp.sum(out * cot) + aux, (out, aux)

    (_, (jout, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        objective, argnums=(0, 1), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))

    mod = _module(tcfg, params)
    tx = torch.from_numpy(x).requires_grad_()
    r = tmoe.route(mod.router, tx.reshape(-1, tcfg.d_model), tcfg)
    assert r["cap"] == cap
    assert np.array_equal(r["eidx"].numpy(), eidx)
    assert np.array_equal(r["keep"].numpy(), keep)
    assert np.array_equal(r["dst"].numpy(), dst)
    out, aux = tmoe.moe_apply(mod, tx, tcfg)
    ((out * torch.from_numpy(cot)).sum() + aux).backward()
    _close(out, jout, "out")
    _close(aux, jaux, "aux")
    _close(tx.grad, jgx, "dx")
    for name, p in mod.named_parameters():
        _close(p.grad, jgp[name], name)


def test_top_k_ties_go_to_the_lower_index():
    """A router whose columns repeat gives exactly tied probabilities:
    the experts, keep and dst equal the reference's (jax.lax.top_k keeps
    the lower index first)."""
    jcfg, tcfg = _cfgs(capacity_factor=0.5)
    rs = np.random.default_rng(2)
    col = rs.standard_normal((jcfg.d_model, 2)).astype(np.float32)
    router = np.concatenate([col[:, :1], col[:, :1], col[:, 1:],
                             col[:, 1:]], axis=1)
    x = rs.standard_normal((1, 24, jcfg.d_model)).astype(np.float32)
    _, eidx, keep, dst, _ = _jax_routing({"router": router}, x, jcfg)
    r = tmoe.route(torch.from_numpy(router),
                   torch.from_numpy(x).reshape(-1, jcfg.d_model), tcfg)
    assert np.array_equal(r["eidx"].numpy(), eidx)
    assert set(map(tuple, eidx.tolist())) <= {(0, 1), (2, 3)}
    assert np.array_equal(r["keep"].numpy(), keep)
    assert np.array_equal(r["dst"].numpy(), dst)


def test_bridge_and_compute_params_carry_the_moe_leaves():
    jcfg, tcfg = _cfgs()
    params = jax.tree_util.tree_map(
        np.asarray, jtfm.init(jax.random.PRNGKey(0), jcfg))
    model = ttfm.init(None, tcfg, device="cpu")
    model.load_state_dict(bridge.params_from_numpy(params, device="cpu"))
    state = model.state_dict()
    for key, arr in params["layers"]["moe"].items():
        for li in range(tcfg.num_layers):
            assert np.array_equal(state[f"layers.{li}.moe.{key}"].numpy(),
                                  arr[li]), key
    assert not any("mlp_w" in name for name in state)
    cp = ttfm.compute_params(model)
    moe = cp.layers[0].moe
    assert moe.router.dtype == torch.float32
    assert torch.equal(moe.router, model.layers[0].moe.router.detach())
    for name in ttfm.MOE_MATMUL_WEIGHTS:
        assert getattr(moe, name).dtype == torch.bfloat16, name
        assert torch.equal(getattr(moe, name), getattr(
            model.layers[0].moe, name).detach().bfloat16()), name


PLEN, MAX_NEW = 48, (12, 9, 12, 9)
COUNTERS = ("prefill_tokens", "decode_tokens", "plan_builds",
            "decode_plan_builds", "decode_plan_extends",
            "decode_plan_replans", "decode_plan_reuses", "admissions")


def test_static_engine_serves_moe_with_the_reference_tokens():
    """The static engine, decode-time SLA, kernel backend (the CUDA
    kernels' plain twins here), the engines' bf16 compute: counters equal,
    first-token logits within 5e-2 x max(1, max |logits|), and greedy
    tokens equal on a seed whose first-token top-2 margins exceed twice
    the measured difference of the two packages' logits."""
    jcfg, tcfg = _cfgs()
    params = jtfm.init(jax.random.PRNGKey(1), jcfg)
    rs = np.random.default_rng(8)
    params["layers"]["sla_proj"] = jnp.asarray(0.1 * rs.standard_normal(
        params["layers"]["sla_proj"].shape, dtype=np.float32))
    model = ttfm.init(None, tcfg, device="cpu")
    model.load_state_dict(bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), device="cpu"))
    prompts = [np.random.default_rng(20 + i).integers(
        0, jcfg.vocab_size, size=PLEN).astype(np.int32) for i in range(4)]
    kw = dict(batch_size=2, max_len=PLEN + max(MAX_NEW) + 4,
              backend="kernel", decode_sla=True)
    jeng, teng = JEngine(jcfg, params, **kw), ServingEngine(tcfg, model, **kw)
    jdone = jeng.run([JRequest(rid=i, prompt=p, max_new_tokens=m)
                      for i, (p, m) in enumerate(zip(prompts, MAX_NEW))])
    tdone = teng.run([Request(rid=i, prompt=p, max_new_tokens=m)
                      for i, (p, m) in enumerate(zip(prompts, MAX_NEW))])
    for name in COUNTERS:
        assert getattr(teng.stats, name) == getattr(jeng.stats, name), name
    toks = np.stack(prompts[:2])
    jlast = jeng._prefill(params, jnp.asarray(toks))[0]
    jlogits = np.asarray(jnp.einsum("bd,vd->bv", jlast.astype(jnp.float32),
                                    params["embed"]))
    with torch.no_grad():
        tlast = teng._prefill(teng._cparams, torch.from_numpy(toks).long())[0]
        tlogits = (tlast.float() @ model.embed.t()).numpy()
    noise = float(np.abs(tlogits - jlogits).max())
    assert noise <= BF16_TOL * max(1.0, float(np.abs(jlogits).max()))
    top2 = np.sort(jlogits, axis=-1)[:, -2:]
    assert float((top2[:, 1] - top2[:, 0]).min()) > 2 * noise
    for t, j in zip(tdone, jdone):
        assert t.tokens_out == j.tokens_out, t.rid
        assert len(t.tokens_out) == t.max_new_tokens


def test_paged_scheduler_serves_moe_with_the_reference_tokens():
    """The continuous Scheduler over the paged, prefix-shared cache with
    decode-time SLA (the paged decode kernel's plain twin here) in f32:
    3 greedy requests sharing a 16-token prefix through 2 slots, tokens
    and every counter equal to the reference scheduler's (its gather
    backend), page counters included."""
    from repro.serving import api as japi
    from repro_torch.serving import api as tapi
    sla = dict(kh_frac=0.25, kl_frac=0.0, col_capacity_factor=None,
               decode_mode="sla")
    jcfg, tcfg = (dataclasses.replace(c, sla=c.sla.replace(**sla))
                  for c in _cfgs())
    params = jtfm.init(jax.random.PRNGKey(2), jcfg)
    params["layers"]["sla_proj"] = jax.random.normal(
        jax.random.PRNGKey(7), params["layers"]["sla_proj"].shape) * 0.3
    model = ttfm.init(None, tcfg, device="cpu")
    model.load_state_dict(bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), device="cpu"))
    rs = np.random.default_rng(4)
    shared = rs.integers(0, jcfg.vocab_size, size=16).astype(np.int32)
    prompts = [np.concatenate([shared, rs.integers(
        0, jcfg.vocab_size, size=n - 16).astype(np.int32)])
        for n in (32, 24, 32)]
    budgets = (6, 8, 5)
    runs = []
    for api, cfg, weights, kw in (
            (japi, jcfg, params, dict(compute_dtype=jnp.float32)),
            (tapi, tcfg, model, dict(compute_dtype=torch.float32,
                                     backend="kernel"))):
        sched = api.Scheduler(cfg, weights, num_slots=2, max_len=64,
                              prefill_bucket=32, decode_sla=True,
                              paged=True, **kw)
        for p, n in zip(prompts, budgets):
            sched.submit(p, api.SamplingParams(max_new_tokens=n))
        done = sched.drain()
        runs.append(([r.tokens_out for r in done],
                     dataclasses.asdict(sched.stats)))
    (jtoks, jstats), (ttoks, tstats) = runs
    assert ttoks == jtoks
    assert [len(t) for t in ttoks] == list(budgets)
    assert tstats["prefix_hits"] > 0
    for name, want in jstats.items():
        if name == "decode_last_retention":
            assert abs(tstats[name] - want) <= 1e-4
        elif name not in ("prefill_s", "decode_s", "max_decode_gap_s"):
            assert tstats[name] == want, name
