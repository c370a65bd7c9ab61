"""The port's examples (`examples_torch/`) against the reference's
(`examples/`), on shared numpy inputs: torch's random streams are not
JAX's, so the examples' printed numbers differ and their functions are
held instead.

- quickstart: on seeded q, k and v at the example's shape (B 1, H 4, N
  1,024, D 64, f32, 64 x 64 blocks), `compute_mask` and `sparsity_stats`
  equal the reference's (no block is near-tied on these inputs); on the
  reference's plan the port's three backends agree with the reference's
  `reference` backend within 5e-5 x max(1, max |ref|), with the example's
  zero Proj and with a random one; the gradient norms of `proj` and `q`
  match the reference's (its default gather backend) within 1e-4
  relative for each of the port's backends; `main`
  runs on the CPU for each backend.
- finetune_dit: `build` equals the reference's config for each preset
  and mode. `train` from the same (perturbed) JAX weights on the same
  batches gives the reference `train`'s 3 losses at the small preset cut
  to 2 layers: `full` and `linear_only` (no plans) against the
  reference's own `train`, `sla` on shared plans (each step's block plans
  of the reference's bf16 forward, given to both sides), all at the bf16
  limit 5e-2 x max(1, |loss|); the count of `mc` blocks that differ when
  the port plans inline is the test's user property
  `sla_inline_plan_blocks_differ`. `main` runs on the CPU at the small
  preset.
- ablations: `attention_fidelity` equals the reference's within 5e-5
  relative on the same q, k and v for each phi, k_h and mode of the
  example's sweeps; `main` runs on the CPU.
- serve_lm, serve_stream and serve_routing: `main` on the CPU passes the
  example's own assertions.
"""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from examples import ablations as jabl
from examples import finetune_dit as jft
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core.config import SLAConfig as JSLAConfig
from repro.core import (compute_mask as jcompute_mask,
                        plan_attention as jplan_attention,
                        sla_attention as jsla_attention,
                        sla_init as jsla_init,
                        sparsity_stats as jsparsity_stats)
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import latent_batch as jlatent_batch
from repro.models import dit as jdit
from repro.models.common import mse_loss
from repro.optim import adamw as jadamw
from examples_torch import ablations as tabl
from examples_torch import finetune_dit as tft
from examples_torch import quickstart
from examples_torch import serve_lm, serve_routing, serve_stream
from repro_torch import bridge
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import (SLAConfig, compute_mask, sla_attention,
                              sparsity_stats)
from repro_torch.models import dit as tdit

TOL = 5e-5
GRAD_RTOL = 1e-4
BF16_TOL = 5e-2  # tests/test_conformance.py's bf16 limit, x max(1, |loss|)
BACKENDS = ("reference", "gather", "kernel")
FT_LAYERS, FT_STEPS = 2, 3


def _quiet(fn, *a, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a, **kw)


# ------------------------------------------------------------- quickstart
@pytest.fixture(scope="module")
def qkv():
    rs = np.random.default_rng(0)
    return tuple(rs.standard_normal((quickstart.B, quickstart.H,
                                     quickstart.N, quickstart.D),
                                    dtype=np.float32) for _ in range(3))


def _jcfg():
    c = quickstart.CFG
    return JSLAConfig(block_q=c.block_q, block_kv=c.block_kv,
                      kh_frac=c.kh_frac, kl_frac=c.kl_frac, phi=c.phi,
                      causal=c.causal)


def test_quickstart_classification_equals_reference(qkv, record_property):
    q, k, _ = qkv
    jmc = np.asarray(jcompute_mask(jnp.asarray(q), jnp.asarray(k), _jcfg()))
    tmc = compute_mask(torch.from_numpy(q), torch.from_numpy(k),
                       quickstart.CFG).numpy()
    differ = int((tmc != jmc).sum())
    record_property("quickstart_mc_blocks_differ", differ)
    assert differ == 0  # these inputs hold no near-tied block
    jstats = jsparsity_stats(jnp.asarray(jmc))
    tstats = sparsity_stats(torch.from_numpy(tmc))
    assert {k: float(v) for k, v in jstats.items()} == \
        {k: float(v) for k, v in tstats.items()}


@pytest.mark.parametrize("proj", ["init", "random"])
def test_quickstart_backends_agree_on_the_reference_plan(qkv, proj):
    q, k, v = qkv
    jcfg = _jcfg()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    jparams = jsla_init(jax.random.PRNGKey(0), quickstart.H, quickstart.D,
                        jcfg)
    if proj == "random":
        jparams = {"proj": jnp.asarray(np.random.default_rng(1)
                                       .standard_normal(jparams["proj"]
                                                        .shape)
                                       .astype(np.float32) * 0.1)}
    jplan = jplan_attention(jq, jk, jcfg)
    want = np.asarray(jsla_attention(jparams, jq, jk, jv, jcfg,
                                     backend="reference", plan=jplan))
    params = {"proj": torch.from_numpy(np.array(jparams["proj"]))}
    plan = bridge.plan_from_numpy(
        {n: np.asarray(getattr(jplan, n)) for n in bridge.PLAN_LEAVES},
        device="cpu")
    limit = TOL * max(1.0, float(np.abs(want).max()))
    for backend in BACKENDS:
        got = sla_attention(params, *map(torch.from_numpy, (q, k, v)),
                            quickstart.CFG, backend=backend, plan=plan)
        err = float(np.abs(got.numpy() - want).max())
        assert err <= limit, (backend, err, limit)


@pytest.fixture(scope="module")
def jax_grads(qkv):
    """The reference quickstart's gradient norms of `proj` and `q` on its
    default backend ("gather": autodiff through the LUT gather; the Pallas
    kernel's interpret mode is too slow at N 1,024), and its params."""
    q, k, v = qkv
    jcfg = _jcfg()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    jparams = jsla_init(jax.random.PRNGKey(0), quickstart.H, quickstart.D,
                        jcfg)

    def loss(p, q):
        return jnp.sum(jsla_attention(p, q, jk, jv, jcfg,
                                      backend="gather") ** 2)

    gp, gq = jax.grad(loss, argnums=(0, 1))(jparams, jq)
    return ((float(jnp.linalg.norm(gp["proj"])),
             float(jnp.linalg.norm(gq))),
            {"proj": torch.from_numpy(np.array(jparams["proj"]))})


@pytest.mark.parametrize("backend", BACKENDS)
def test_quickstart_gradients_match_reference(qkv, jax_grads, backend):
    q, k, v = qkv
    want, params = jax_grads
    out = _quiet(quickstart.run, *map(torch.from_numpy, (q, k, v)),
                 backend=backend, params=params)
    for got, ref in zip((out["grad_proj"], out["grad_q"]), want):
        assert abs(got - ref) <= GRAD_RTOL * abs(ref), (backend, got, ref)


@pytest.mark.parametrize("backend", BACKENDS)
def test_quickstart_main_on_cpu(backend):
    out = _quiet(quickstart.main, ["--device", "cpu", "--backend", backend])
    limit = TOL * max(1.0, out["ref_max_abs"])
    assert out["backend"] == backend
    assert out["gather_err"] <= limit and out["kernel_err"] <= limit
    assert np.isfinite(out["grad_proj"]) and np.isfinite(out["grad_q"])
    assert out["flops"]["reduction_x"] > 1.0
    assert set(out["stats"]) == {"critical_frac", "marginal_frac",
                                 "negligible_frac", "sparsity"}


def test_quickstart_rejects_an_unknown_backend():
    with pytest.raises(ValueError):
        _quiet(quickstart.main, ["--device", "cpu", "--backend", "nope"])


# ----------------------------------------------------------- finetune_dit
@pytest.mark.parametrize("mode", ["full", "sla", "sparse_only",
                                  "linear_only", "l_plus_s"])
@pytest.mark.parametrize("preset", sorted(tft.PRESETS))
def test_build_equals_reference(preset, mode):
    assert tft.PRESETS == jft.PRESETS
    assert dataclasses.asdict(tft.build(preset, mode)) == \
        dataclasses.asdict(jft.build(preset, mode))


def _ft_models(mode):
    jcfg = dataclasses.replace(jft.build("small", mode),
                               num_layers=FT_LAYERS)
    tcfg = dataclasses.replace(tft.build("small", mode),
                               num_layers=FT_LAYERS)
    rs = np.random.default_rng(3)
    tree = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rs.standard_normal(a.shape))
        .astype(np.float32), jdit.init(jax.random.PRNGKey(0), jcfg))
    model = tdit.init(None, tcfg, device="cpu")
    model.load_state_dict(bridge.params_from_numpy(tree, device="cpu"))
    return jcfg, tcfg, tree, model


def _ft_shape():
    p = tft.PRESETS["small"]
    return (JShapeConfig("dit", p["seq"], p["batch"], "train"),
            ShapeConfig("dit", p["seq"], p["batch"], "train"))


def _jax_sla_steps(jcfg, tree, jshape, lr, seed):
    """The reference example's `train` step by step on sla mode, each
    step's loss on the block plans of the reference's bf16 forward at
    that step's params (what its inline planning computes), returned
    beside the losses."""
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    opt_cfg = jadamw.AdamWConfig(lr=lr, total_steps=FT_STEPS,
                                 warmup_steps=max(FT_STEPS // 10, 1),
                                 schedule="cosine")
    opt = jadamw.init(params)

    @jax.jit
    def plans_of(params, batch):
        x0, noise, t = batch["latents"], batch["noise"], batch["t"]
        xt = (1.0 - t[:, None, None]) * x0 + t[:, None, None] * noise
        return jdit.forward(params, jcfg, xt, t, None, jnp.bfloat16,
                            "gather", "sla", return_plans=True)[1]

    @jax.jit
    def step_fn(params, opt, batch, plans):
        def loss_fn(p):
            x0, noise, t = batch["latents"], batch["noise"], batch["t"]
            xt = (1.0 - t[:, None, None]) * x0 + t[:, None, None] * noise
            pred = jdit.forward(p, jcfg, xt, t, None, jnp.bfloat16,
                                "gather", "sla", plans=plans)
            return mse_loss(pred, noise - x0)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        params, opt, _ = jadamw.update(params, grads, opt, opt_cfg)
        return params, opt, loss

    losses, plans = [], []
    for s in range(FT_STEPS):
        batch = {k: jnp.asarray(v) for k, v in jlatent_batch(
            jcfg, jshape, JDataConfig(seed=seed), s).items()}
        plan = plans_of(params, batch)
        params, opt, loss = step_fn(params, opt, batch, plan)
        losses.append(float(loss))
        plans.append({n: np.asarray(getattr(plan, n))
                      for n in bridge.PLAN_LEAVES})
    return losses, plans


@pytest.mark.parametrize("mode", ["full", "linear_only", "sla"])
def test_finetune_train_matches_reference(mode, monkeypatch,
                                          record_property):
    jcfg, tcfg, tree, model = _ft_models(mode)
    jshape, tshape = _ft_shape()
    lr, seed = 3e-4 * 0.5, 1
    sla_mode = None if mode == "full" else mode
    if mode == "sla":
        want, plans = _jax_sla_steps(jcfg, tree, jshape, lr, seed)
        # the port's inline plans at step 0 (the same params) beside the
        # reference's: the count of blocks a near-tie flips
        inline = []
        real = tdit.plan_lib.plan_attention

        def capture(q, k, cfg, **kw):
            inline.append(real(q, k, cfg, **kw))
            return inline[-1]
        batch = tft.to_device(tft.latent_batch(
            tcfg, tshape, tft.DataConfig(seed=seed), 0), "cpu")
        with monkeypatch.context() as m, torch.no_grad():
            m.setattr(tdit.plan_lib, "plan_attention", capture)
            tdit.loss_fn(model, tcfg, batch, sla_mode="sla")
        differ = sum(int((p.mc.numpy() != plans[0]["mc"][li]).sum())
                     for li, p in enumerate(inline))
        record_property("sla_inline_plan_blocks_differ", differ)
        given = iter([bridge.plan_from_numpy(
            {n: leaf[li] for n, leaf in step.items()}, device="cpu")
            for step in plans for li in range(FT_LAYERS)])
        monkeypatch.setattr(tdit.plan_lib, "plan_attention",
                            lambda *a, **kw: next(given))
    else:
        _, want = _quiet(jft.train, jcfg,
                         jax.tree_util.tree_map(jnp.asarray, tree), jshape,
                         FT_STEPS, lr, seed, sla_mode=sla_mode)
    _, got = _quiet(tft.train, tcfg, model, tshape, FT_STEPS, lr, seed,
                    sla_mode=sla_mode)
    assert len(got) == FT_STEPS
    for g, w in zip(got, want):
        assert abs(g - w) <= BF16_TOL * max(1.0, abs(w)), (mode, got, want)
    if mode == "sla":
        with pytest.raises(StopIteration):
            next(given)  # every shared plan was used, one a layer a step


def test_finetune_main_on_cpu():
    res = _quiet(tft.main, ["--device", "cpu", "--pretrain-steps", "2",
                            "--finetune-steps", "2", "--modes",
                            "sla,linear_only", "--backend", "kernel"])
    assert set(res) == {"full_attention", "sla", "linear_only"}
    assert all(np.isfinite(v) for v in res.values())


# -------------------------------------------------------------- ablations
@pytest.fixture(scope="module")
def abl_qkv():
    rs = np.random.default_rng(7)
    return tuple(rs.standard_normal((2, 4, 256, 64), dtype=np.float32)
                 for _ in range(3))


def _abl_cases():
    base = dict(block_q=32, block_kv=32, kh_frac=0.10, kl_frac=0.20)
    cases = [dict(phi=p) for p in ("softmax", "elu1", "relu")]
    cases += [dict(kh_frac=kh) for kh in (0.05, 0.10, 0.20)]
    cases += [dict(mode=m) for m in ("sla", "sparse_only", "linear_only",
                                     "l_plus_s")]
    return [(JSLAConfig(**{**base, **c}), SLAConfig(**{**base, **c}))
            for c in cases]


@pytest.mark.parametrize("i", range(10))
def test_attention_fidelity_equals_reference(abl_qkv, i):
    jcfg, tcfg = _abl_cases()[i]
    want = jabl.attention_fidelity(*map(jnp.asarray, abl_qkv), jcfg,
                                   jax.random.PRNGKey(0))
    got = tabl.attention_fidelity(*map(torch.from_numpy, abl_qkv), tcfg)
    assert abs(got - want) <= TOL * abs(want), (got, want)


def test_ablations_main_on_cpu():
    out = _quiet(tabl.main, ["--device", "cpu", "--train-steps", "2",
                             "--seq", "128"])
    assert set(out["mode"]) == {"sla", "sparse_only", "linear_only",
                                "l_plus_s"}
    assert all(np.isfinite(e) for table in out.values()
               for e in table.values())


# ---------------------------------------------------------------- serving
def test_serve_lm_main_on_cpu():
    done = _quiet(serve_lm.main, ["--device", "cpu"])
    assert len(done) == 8
    assert all(len(r.tokens_out) == r.max_new_tokens for r in done)


def test_serve_stream_main_on_cpu():
    done = _quiet(serve_stream.main, ["--device", "cpu"])
    assert [len(r.tokens_out) for r in done[:3]] == [6, 14, 4]


def test_serve_routing_main_on_cpu():
    tokens = _quiet(serve_routing.main, ["--device", "cpu"])
    assert set(tokens) == {name for name, _ in serve_routing.CONFIGS}
    assert tokens["decode-sla+learned"] == tokens["decode-sla"]
