"""The port's LM training path against the reference's.

Both sides start from the same weights (the JAX init perturbed with
seeded numpy noise so that the zero-initialized leaves are live, carried
over with `repro_torch.bridge`) and see bitwise the same token batches, on
the smoke qwen3-1.7b (dense) and moonshot-v1-16b-a3b (MoE: 4 experts,
top-2, a shared expert).

- `token_batch` is bitwise the reference's; `make_iterator`,
  `registry.get_model` and `configs.get_arch` take every LM arch.
- `chunked_softmax_xent` value and gradients, with and without a mask,
  at a length whose chunk the rule cuts below 512: within 5e-5 x max(1,
  max |ref|).
- `loss_fn` / `distill_loss_fn` values and parameter gradients in f32 on
  the port's kernel and gather backends, against the reference's kernel
  backend (its Pallas kernels, in interpret mode; computed once for
  both): within 5e-5 x max(1, max |g|).
- Remat on and off give bitwise the same loss and gradients, with one
  plan per layer either way.
- 3 `make_train_step` steps (bf16 compute, the port's kernel backend,
  remat) against the reference's at its default gather backend, on the
  MoE config: losses within 5e-2.
- `train.main` matches `repro.launch.train.main` losses within 5e-2.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.configs import get_arch as jax_get_arch
from repro.configs import get_shape as jax_get_shape
from repro.data import pipeline as jpipeline
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import common as jcommon
from repro.models import transformer as jtfm
from repro.optim import adamw as jadamw
from repro_torch import bridge
from repro_torch.configs import get_arch, get_shape
from repro_torch.core import plan as plan_lib
from repro_torch.data import pipeline
from repro_torch.distributed import ctx
from repro_torch.launch import steps, train
from repro_torch.models import common, registry
from repro_torch.models import transformer as ttfm
from repro_torch.optim import adamw

TOL = 5e-5
LOSS_TOL = 5e-2
LM_ARCHS = ("qwen3-1.7b", "moonshot-v1-16b-a3b")


def _cfgs(arch, **sla_kw):
    jcfg, tcfg = jax_get_arch(arch).smoke(), get_arch(arch).smoke()
    if sla_kw:
        jcfg = dataclasses.replace(jcfg, sla=jcfg.sla.replace(**sla_kw))
        tcfg = dataclasses.replace(tcfg, sla=tcfg.sla.replace(**sla_kw))
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _tree_of(arch, routing_mode, seed):
    jcfg, _ = _cfgs(arch, routing_mode=routing_mode)
    rs = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rs.standard_normal(a.shape))
        .astype(np.float32), jtfm.init(jax.random.PRNGKey(0), jcfg))


def _tree(jcfg, seed=1):
    """The JAX init with every leaf perturbed, as numpy (built once per
    config and seed; callers copy it: bridge and jnp.asarray do)."""
    return _tree_of(jcfg.name, jcfg.sla.routing_mode, seed)


def _model(tcfg, tree):
    model = ttfm.init(None, tcfg, device="cpu")
    model.load_state_dict(bridge.params_from_numpy(tree, device="cpu"))
    return model


def _batch(jcfg, step=0):
    shape = jax_get_shape("train_4k", smoke=True)
    return jpipeline.token_batch(jcfg, shape, jpipeline.DataConfig(seed=3),
                                 step)


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, name, tol=TOL):
    want = np.asarray(want)
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_token_batch_is_bitwise_the_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    for name in ("train_4k", "prefill_32k"):
        jshape = jax_get_shape(name, smoke=True)
        tshape = get_shape(name, smoke=True)
        for step in (0, 5):
            dc = dict(seed=7, num_hosts=2, host_id=1)
            want = jpipeline.token_batch(jcfg, jshape,
                                         jpipeline.DataConfig(**dc), step)
            got = pipeline.token_batch(tcfg, tshape,
                                       pipeline.DataConfig(**dc), step)
            assert sorted(got) == sorted(want) == ["targets", "tokens"]
            for key in want:
                assert got[key].dtype == want[key].dtype
                assert np.array_equal(got[key], want[key]), key
    it = pipeline.make_iterator(tcfg, get_shape("train_4k", smoke=True),
                                start_step=2)
    assert np.array_equal(next(it)["tokens"], pipeline.token_batch(
        tcfg, get_shape("train_4k", smoke=True), pipeline.DataConfig(),
        2)["tokens"])


def test_every_lm_arch_is_accepted():
    """The configs equal the reference's (tests/test_torch_config.py);
    here each resolves to the transformer module and gets token batches,
    at full size (llama4 too: nothing is built)."""
    shape = get_shape("train_4k", smoke=True)
    for arch in (*LM_ARCHS, "llama4-maverick-400b-a17b"):
        cfg = get_arch(arch)
        assert registry.get_model(cfg) is ttfm
        batch = next(pipeline.make_iterator(cfg, shape))
        assert batch["tokens"].shape == (2, 128)
        assert int(batch["tokens"].max()) < cfg.vocab_size


XENT_CASES = [(600, None), (600, "mask"), (30, "mask")]


@pytest.mark.parametrize("s,mask", XENT_CASES,
                         ids=[f"s{s}-{m or 'nomask'}" for s, m in XENT_CASES])
def test_chunked_softmax_xent_matches_jax(s, mask):
    """S 600 cuts the 512 chunk to 300 (the rule `while s % chunk`); S 30
    with chunk 8 cuts it to 6. Value and gradients of x and the table."""
    rs = np.random.default_rng(s)
    b, d, v = 2, 24, 97
    x = rs.standard_normal((b, s, d)).astype(np.float32)
    table = (0.3 * rs.standard_normal((v, d))).astype(np.float32)
    tgt = rs.integers(0, v, size=(b, s)).astype(np.int32)
    m = (rs.random((b, s)) > 0.3).astype(np.float32) if mask else None
    chunk = 512 if s == 600 else 8
    jl, (jgx, jgt) = jax.value_and_grad(
        lambda x_, t_: jcommon.chunked_softmax_xent(
            x_, t_, jnp.asarray(tgt), None if m is None else jnp.asarray(m),
            chunk=chunk), argnums=(0, 1))(jnp.asarray(x), jnp.asarray(table))
    tx = torch.from_numpy(x).requires_grad_()
    tt = torch.from_numpy(table).requires_grad_()
    tl = common.chunked_softmax_xent(
        tx, tt, torch.from_numpy(tgt),
        None if m is None else torch.from_numpy(m), chunk=chunk)
    tl.backward()
    _close(tl.detach().numpy(), jl, "loss")
    _close(tx.grad.numpy(), jgx, "dx")
    _close(tt.grad.numpy(), jgt, "dtable")


LOSS_CASES = [
    pytest.param(arch, loss, backend, id=f"{arch}-{loss}-{backend}")
    for arch in LM_ARCHS
    for loss in ("loss_fn", "distill_loss_fn")
    for backend in ("kernel", "gather")
]


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(arch, loss):
    """The reference's loss and gradients on its kernel backend, as
    numpy, once for both port backends."""
    jcfg, _ = _cfgs(arch)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: getattr(jtfm, loss)(p, jcfg, _batch(jcfg), jnp.float32,
                                      "kernel")))(
        jax.tree_util.tree_map(jnp.asarray, _tree(jcfg)))
    return float(jl), jax.tree_util.tree_map(np.asarray, jg)


@pytest.mark.parametrize("arch,loss,backend", LOSS_CASES)
def test_loss_and_grads_match_jax(arch, loss, backend):
    jcfg, tcfg = _cfgs(arch)
    tree = _tree(jcfg)
    batch = _batch(jcfg)
    jl, jg = _jax_loss_and_grads(arch, loss)
    model = _model(tcfg, tree)
    tl = getattr(ttfm, loss)(model, tcfg, _torch(batch), torch.float32,
                             backend)
    tl.backward()
    assert float(jl) > 1e-3
    _close(tl.detach().numpy(), jl, "loss")
    want = bridge.params_from_numpy(jg, device="cpu")
    assert sorted(want) == sorted(n for n, _ in model.named_parameters())
    for name, p in model.named_parameters():
        _close(p.grad.numpy(), want[name].numpy(), name)


def _count_plans(monkeypatch):
    calls = []
    orig = plan_lib.plan_attention
    monkeypatch.setattr(plan_lib, "plan_attention",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    return calls


@pytest.mark.parametrize("arch,routing_mode,backend", [
    ("qwen3-1.7b", "threshold", "kernel"),
    ("moonshot-v1-16b-a3b", "learned", "gather"),
])
def test_remat_on_and_off_give_the_same_grads(arch, routing_mode, backend,
                                              monkeypatch):
    """Per-layer remat recomputes each layer (its MoE routing included)
    in the backward over the plan its first pass built: bitwise the same
    loss and gradients (routing ones included) and one plan per layer
    either way."""
    jcfg, tcfg = _cfgs(arch, routing_mode=routing_mode)
    tree = _tree(jcfg)
    batch = _torch(_batch(jcfg))
    calls = _count_plans(monkeypatch)
    runs = []
    for remat in (False, True):
        model = _model(tcfg, tree)
        calls.clear()
        with ctx.activation_sharding(remat=remat):
            loss = ttfm.distill_loss_fn(model, tcfg, batch, torch.float32,
                                        backend)
            loss.backward()
        runs.append((loss.detach(), {n: p.grad for n, p in
                                     model.named_parameters()},
                     len(calls)))
    (l0, g0, c0), (l1, g1, c1) = runs
    assert torch.equal(l0, l1) and c0 == c1 == tcfg.num_layers
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    if routing_mode == "learned":  # straight-through grads survive remat
        assert float(g1["layers.0.routing.wq"].abs().max()) > 0
    if tcfg.num_experts:
        assert float(g1["layers.1.moe.router"].abs().max()) > 0


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b"])
def test_train_step_bf16_matches_jax(arch, monkeypatch):
    """Three AdamW steps in bf16 compute from the same f32 masters, the
    port on its kernel backend, the reference on its default (gather):
    losses and grad norms within 5e-2, one plan per layer per step, and
    the steps really moved the parameters. The MoE config runs the dense
    attention path too; qwen3's bf16 loss is held by the CLI test below,
    its bf16 step on the card (`tests/test_torch_gpu.py`)."""
    jcfg, tcfg = _cfgs(arch)
    tree = _tree(jcfg)
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jadamw.AdamWConfig(**opt)))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jadamw.init(jparams)
    model = _model(tcfg, tree)
    tstep = steps.make_train_step(tcfg, adamw.AdamWConfig(**opt),
                                  backend="kernel")
    tstate = adamw.init(dict(model.named_parameters()))
    before = model.layers[0].wq.detach().clone()
    calls = _count_plans(monkeypatch)
    for step in range(3):
        batch = _batch(jcfg, step)
        jparams, jstate, jl, jg = jstep(jparams, jstate, batch)
        calls.clear()
        with ctx.activation_sharding(remat=True):
            model, tstate, tl, tg = tstep(model, tstate, _torch(batch))
        assert len(calls) == tcfg.num_layers
        assert np.isfinite(float(tl)) and np.isfinite(float(tg))
        assert abs(float(tl) - float(jl)) <= LOSS_TOL, step
        assert abs(float(tg) - float(jg)) <= LOSS_TOL * max(1.0,
                                                            float(jg))
    assert not torch.equal(model.layers[0].wq.detach(), before)
    assert all(p.grad is None for p in model.parameters())


def test_cast_params_bf16_reaches_the_moe_leaves():
    _, tcfg = _cfgs("moonshot-v1-16b-a3b")
    model = ttfm.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    tree = steps.cast_params_bf16(model)
    for name in ("router", "wi", "wo", "shared_wi", "shared_wo"):
        assert getattr(tree.layers[1].moe, name).dtype == torch.bfloat16
    tree.layers[0].moe.router.float().sum().backward()
    assert model.layers[0].moe.router.grad.dtype == torch.float32
    assert torch.equal(model.layers[0].moe.router.grad,
                       torch.ones_like(model.layers[0].moe.router))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_train_cli_matches_jax(arch, monkeypatch):
    """Both CLIs from the same perturbed weights (each package's `init`
    is patched to hand them over): the losses within 5e-2."""
    jcfg, tcfg = _cfgs(arch)
    tree = _tree(jcfg, seed=4)
    model = _model(tcfg, tree)
    monkeypatch.setattr(jtfm, "init", lambda rng, cfg, dtype=None:
                        jax.tree_util.tree_map(jnp.asarray, tree))
    monkeypatch.setattr(ttfm, "init", lambda gen, cfg, dtype=None,
                        device=None: model)
    argv = ["--arch", arch, "--smoke", "--steps", "3", "--log-every", "1"]
    want = jtrain.main(argv)
    got = train.main(argv + ["--device", "cpu"])
    assert len(got) == len(want) == 3
    assert all(np.isfinite(got)) and min(want) > 1.0
    np.testing.assert_allclose(got, want, atol=LOSS_TOL, rtol=0)
