"""The port's DiT training path against the reference's.

Both sides start from the same weights (the JAX init perturbed with
seeded numpy noise so that the zero-initialized leaves are live, carried
over with `repro_torch.bridge`) and see bitwise the same latent batches.

- `latent_batch` is bitwise the reference's.
- `loss_fn` / `distill_loss_fn` values and parameter gradients at smoke
  size in f32, kernel and gather backends: within 5e-5 x max(1, max |g|).
- Remat on and off give bitwise the same gradients, with one plan per
  layer either way.
- 3 `make_train_step` steps (bf16 compute, kernel backend, remat):
  losses within 5e-2 of the reference's (bf16 rounds at other places in
  the two frameworks).
- `make_train_step(grad_transform=)` updates on the transformed
  gradients: bitwise one step done by hand with error-feedback
  compression.
- `train.main` (the fine-tuning recipe, the plain flow-matching loop,
  with `--compress-grads`, and checkpointed and resumed through
  `--ckpt-dir`) matches `repro.launch.train.main` losses within 5e-2; a
  resumed run's losses are bitwise the straight run's.
"""
import dataclasses
import shutil
import types

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
from repro.models import dit as jdit
from repro.optim import adamw as jadamw
from repro_torch import bridge
from repro_torch.configs import get_arch, get_shape
from repro_torch.core import plan as plan_lib
from repro_torch.data import pipeline
from repro_torch.distributed import ctx
from repro_torch.launch import steps, train
from repro_torch.models import dit as tdit
from repro_torch.optim import adamw, compression

TOL = 5e-5
LOSS_TOL = 5e-2


def _cfgs(arch, **sla_kw):
    jcfg, tcfg = jax_get_arch(arch).smoke(), get_arch(arch).smoke()
    if sla_kw:
        jcfg = dataclasses.replace(jcfg, sla=jcfg.sla.replace(**sla_kw))
        tcfg = dataclasses.replace(tcfg, sla=tcfg.sla.replace(**sla_kw))
    return jcfg, tcfg


def _tree(jcfg, seed=1):
    """The JAX init with every leaf perturbed, as numpy."""
    rs = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rs.standard_normal(a.shape))
        .astype(np.float32), jdit.init(jax.random.PRNGKey(0), jcfg))


def _model(tcfg, tree, init=tdit.init):
    model = init(None, tcfg, device="cpu")
    model.load_state_dict(bridge.params_from_numpy(tree, device="cpu"))
    return model


def _batch(jcfg, step=0):
    shape = jax_get_shape("train_4k", smoke=True)
    return jpipeline.latent_batch(jcfg, shape, jpipeline.DataConfig(seed=3),
                                  step)


def _close(got, want, name, tol=TOL):
    want = np.asarray(want)
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("arch", ["wan2_1_1_3b", "lightningdit_1b"])
def test_latent_batch_is_bitwise_the_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    for name in ("train_4k", "prefill_32k"):
        jshape = jax_get_shape(name, smoke=True)
        tshape = get_shape(name, smoke=True)
        assert dataclasses.asdict(tshape) == dataclasses.asdict(jshape)
        for step in (0, 5):
            dc = dict(seed=7, num_hosts=2, host_id=1)
            want = jpipeline.latent_batch(jcfg, jshape,
                                          jpipeline.DataConfig(**dc), step)
            got = pipeline.latent_batch(tcfg, tshape,
                                        pipeline.DataConfig(**dc), step)
            assert sorted(got) == sorted(want)
            for key in want:
                assert got[key].dtype == want[key].dtype
                assert np.array_equal(got[key], want[key]), key
    it = pipeline.make_iterator(tcfg, get_shape("train_4k", smoke=True),
                                start_step=2)
    assert np.array_equal(next(it)["noise"], pipeline.latent_batch(
        tcfg, get_shape("train_4k", smoke=True), pipeline.DataConfig(),
        2)["noise"])


LOSS_CASES = [
    pytest.param(loss, backend, id=f"{loss}-{backend}")
    for loss in ("loss_fn", "distill_loss_fn")
    for backend in ("kernel", "gather")
]


@pytest.mark.parametrize("loss,backend", LOSS_CASES)
def test_loss_and_grads_match_jax(loss, backend):
    jcfg, tcfg = _cfgs("wan2_1_1_3b")
    tree = _tree(jcfg)
    batch = _batch(jcfg)
    jl, jg = jax.value_and_grad(
        lambda p: getattr(jdit, loss)(p, jcfg, batch, jnp.float32,
                                      backend))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    model = _model(tcfg, tree)
    tl = getattr(tdit, loss)(model, tcfg, {k: torch.from_numpy(v)
                                           for k, v in batch.items()},
                             torch.float32, backend)
    tl.backward()
    assert float(jl) > 1e-3
    _close(tl.detach().numpy(), jl, "loss")
    want = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jg),
                                    device="cpu")
    for name, p in model.named_parameters():
        _close(p.grad.numpy(), want[name].numpy(), name)


def _count_plans(monkeypatch):
    calls = []
    orig = plan_lib.plan_attention
    monkeypatch.setattr(plan_lib, "plan_attention",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    return calls


@pytest.mark.parametrize("arch,routing_mode,backend", [
    ("wan2_1_1_3b", "threshold", "kernel"),
    ("lightningdit_1b", "learned", "gather"),
])
def test_remat_on_and_off_give_the_same_grads(arch, routing_mode, backend,
                                              monkeypatch):
    """Per-layer remat recomputes each layer in the backward over the
    plan its first pass built: bitwise the same loss and gradients
    (routing ones included) and one plan per layer either way."""
    jcfg, tcfg = _cfgs(arch, routing_mode=routing_mode)
    tree = _tree(jcfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch(jcfg).items()}
    calls = _count_plans(monkeypatch)
    runs = []
    for remat in (False, True):
        model = _model(tcfg, tree)
        calls.clear()
        with ctx.activation_sharding(remat=remat):
            loss = tdit.distill_loss_fn(model, tcfg, batch, torch.float32,
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


def test_activation_sharding_refuses_a_mesh():
    """A mesh the port cannot run is refused when the hooks read its
    layout: here a data axis of 2 that splits neither the batch nor the
    sequence (residual spec ()). The scope ends cleanly."""
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(2, 1))
    with pytest.raises(NotImplementedError, match="replicated compute"):
        with ctx.activation_sharding(mesh=mesh, residual=()):
            ctx.layout()
    assert not ctx.use_remat() and ctx.layout() is None


def test_train_step_bf16_matches_jax(monkeypatch):
    """Three AdamW steps on the kernel backend in bf16 compute, from the
    same f32 masters: losses within 5e-2, one plan per layer per step,
    and the steps really moved the parameters."""
    jcfg, tcfg = _cfgs("wan2_1_1_3b")
    tree = _tree(jcfg)
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jadamw.AdamWConfig(**opt),
                                           backend="kernel"))
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
            model, tstate, tl, tg = tstep(
                model, tstate, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        assert len(calls) == tcfg.num_layers
        assert np.isfinite(float(tl)) and np.isfinite(float(tg))
        assert abs(float(tl) - float(jl)) <= LOSS_TOL, step
        assert abs(float(tg) - float(jg)) <= LOSS_TOL * max(1.0,
                                                            float(jg))
    assert not torch.equal(model.layers[0].wq.detach(), before)
    assert all(p.grad is None for p in model.parameters())


def test_train_step_options_of_the_cli():
    """The options the training CLI passes: a `trainable` mask updates
    only those parameters (their moments too), and a guard that refuses
    the loss skips the update and returns no grad norm."""
    jcfg, tcfg = _cfgs("lightningdit_1b", routing_mode="learned")
    model = _model(tcfg, _tree(jcfg))
    named = dict(model.named_parameters())
    mask = adamw.trainable_mask(named, ("sla_proj",))
    state = adamw.init(named)
    before = {n: p.detach().clone() for n, p in named.items()}
    batch = {k: torch.from_numpy(v) for k, v in _batch(jcfg).items()}
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    refused = steps.make_train_step(tcfg, opt_cfg, distill=True,
                                    compute_bf16=False,
                                    guard=lambda loss: False)
    model, state, loss, gnorm = refused(model, state, batch)
    assert gnorm is None and np.isfinite(float(loss))
    assert int(state["step"]) == 0
    assert all(torch.equal(p, before[n]) for n, p in named.items())
    step = steps.make_train_step(tcfg, opt_cfg, distill=True,
                                 trainable=mask, compute_bf16=False)
    model, state, loss, gnorm = step(model, state, batch)
    assert int(state["step"]) == 1 and float(gnorm) > 0
    for n, p in named.items():
        assert torch.equal(p, before[n]) != mask[n], n
        assert bool(state["m"][n].abs().max() > 0) == mask[n], n
    assert all(p.grad is None for p in model.parameters())


def test_train_step_grad_transform_runs_between_guard_and_update():
    """`grad_transform` (here the CLI's error-feedback compression) sees
    the raw gradients, and AdamW updates on its output: one step is
    bitwise the loss, backward, `ef_compress_decompress` and
    `adamw.update` done by hand, and the compressed gradients differ from
    the raw ones. A guard that refuses the loss skips the transform."""
    jcfg, tcfg = _cfgs("lightningdit_1b")
    tree = _tree(jcfg, seed=5)
    batch = {k: torch.from_numpy(v) for k, v in _batch(jcfg).items()}
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    seen = []

    def transform(grads):
        seen.append({n: g.clone() for n, g in grads.items()})
        error = compression.ef_init(grads)
        ghat, _, _ = compression.ef_compress_decompress(grads, error)
        return ghat

    model = _model(tcfg, tree)
    state = adamw.init(dict(model.named_parameters()))
    refused = steps.make_train_step(tcfg, opt_cfg, compute_bf16=False,
                                    guard=lambda loss: False,
                                    grad_transform=transform)
    refused(model, state, batch)
    assert not seen
    step = steps.make_train_step(tcfg, opt_cfg, compute_bf16=False,
                                 guard=lambda loss: True,
                                 grad_transform=transform)
    model, state, loss, gnorm = step(model, state, batch)
    assert len(seen) == 1

    hand = _model(tcfg, tree)
    named = dict(hand.named_parameters())
    hand_state = adamw.init(named)
    hand_loss = tdit.loss_fn(hand, tcfg, batch, backend="gather")
    hand_loss.backward()
    raw = {n: torch.zeros_like(p) if p.grad is None else p.grad
           for n, p in named.items()}
    ghat, error, _ = compression.ef_compress_decompress(
        raw, compression.ef_init(raw))
    _, hand_state, metrics = adamw.update(named, ghat, hand_state, opt_cfg)
    assert torch.equal(loss, hand_loss.detach())
    assert all(torch.equal(seen[0][n], raw[n]) for n in raw)
    assert any(not torch.equal(ghat[n], raw[n]) for n in raw)
    assert max(float(e.abs().max()) for e in error.values()) > 0
    assert torch.equal(gnorm, metrics["grad_norm"])
    for n, p in model.named_parameters():
        assert torch.equal(p, named[n]), n
        for moment in ("m", "v"):
            assert torch.equal(state[moment][n], hand_state[moment][n]), n


def test_cast_params_bf16_feeds_forward_and_grads_the_masters():
    _, tcfg = _cfgs("lightningdit_1b", routing_mode="learned")
    model = tdit.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    tree = steps.cast_params_bf16(model)
    assert tree.patch_in.dtype == torch.bfloat16
    assert tree.layers[1].routing["wq"].dtype == torch.bfloat16
    assert len(tree.layers) == tcfg.num_layers
    tree.layers[0].wq.float().sum().backward()
    assert model.layers[0].wq.grad.dtype == torch.float32
    assert torch.equal(model.layers[0].wq.grad,
                       torch.ones_like(model.layers[0].wq))


CLI = ["--arch", "lightningdit_1b", "--smoke", "--steps", "3",
       "--log-every", "1"]
RECIPE = ["--distill", "--routing-mode", "learned", "--train-only",
          "routing,sla_proj", "--routing-warm-init"]
# each CLI runs --steps 2, then --steps 4, into one checkpoint directory
RESUME = ["--ckpt-dir"]


@pytest.mark.parametrize("extra", [RECIPE, [], ["--compress-grads"],
                                   RESUME],
                         ids=["recipe", "flow", "compress", "resume"])
def test_train_cli_matches_jax(extra, monkeypatch, tmp_path):
    """Both CLIs from the same perturbed weights (each family's `init` is
    patched to hand them over), so the losses are live: the fine-tuning
    recipe (distillation, learned routing, only routing + sla_proj
    trained), the plain flow-matching loop, the loop with error-feedback
    gradient compression, and the loop checkpointed after 2 steps and
    resumed from there to 4 (each CLI from its own checkpoint). The port's
    compression is watched: it runs once a step, with a non-zero error,
    under `--compress-grads` only."""
    jcfg, tcfg = _cfgs("lightningdit_1b", routing_mode="learned"
                       if extra is RECIPE else "threshold")
    tree = _tree(jcfg, seed=4)
    monkeypatch.setattr(jdit, "init", lambda rng, cfg, dtype=None:
                        jax.tree_util.tree_map(jnp.asarray, tree))
    monkeypatch.setattr(tdit, "init", lambda gen, cfg, dtype=None,
                        device=None: _model(tcfg, tree))
    errors = []

    def compress(grads, error):
        out = compression.ef_compress_decompress(grads, error)
        errors.append(max(float(e.abs().max()) for e in out[1].values()))
        return out

    monkeypatch.setattr(train, "ef_compress_decompress", compress)
    if extra is RESUME:
        want, got = [], []
        for steps in ("2", "4"):
            run = CLI + ["--steps", steps, "--ckpt-dir"]
            want += jtrain.main(run + [str(tmp_path / "jax")])
            got += train.main(run + [str(tmp_path / "torch"), "--device",
                                     "cpu"])
        assert (tmp_path / "torch" / "step_4" / "manifest.json").exists()
    else:
        want = jtrain.main(CLI + extra)
        got = train.main(CLI + extra + ["--device", "cpu"])
    assert len(got) == len(want) == (4 if extra is RESUME else 3)
    assert all(np.isfinite(got)) and max(want) > 1e-4
    np.testing.assert_allclose(got, want, atol=LOSS_TOL, rtol=0)
    # the port's CLI compressed every step's gradients, and only when asked
    compressed = "--compress-grads" in extra
    assert len(errors) == (3 if compressed else 0)
    assert all(e > 0 for e in errors)


def test_train_cli_resume_is_bitwise_the_straight_run(tmp_path):
    """4 steps checkpointed every 2; with step_4 deleted, a second run
    resumes from step_2 (weights, moments, step, and the batches from
    step 2) and its two losses are the straight run's last two,
    bitwise."""
    ckpt = ["--steps", "4", "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    straight = train.main(CLI + ckpt + ["--ckpt-every", "2"])
    assert (tmp_path / "step_2").exists()
    shutil.rmtree(tmp_path / "step_4")
    resumed = train.main(CLI + ckpt)
    assert len(straight) == 4 and resumed == straight[2:]


def test_train_cli_resumed_at_its_last_step_takes_no_step(tmp_path):
    """A run whose checkpoint is already at --steps resumes there, takes
    no step and returns no loss (the reference's CLI raises IndexError on
    its empty loss list there: ROADMAP.md queue 3)."""
    ckpt = ["--steps", "2", "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    assert len(train.main(CLI + ckpt)) == 2
    assert train.main(CLI + ckpt) == []
    assert (tmp_path / "step_2" / "manifest.json").exists()


def test_dead_point_warning_fires():
    _, tcfg = _cfgs("lightningdit_1b", routing_mode="learned")
    model = tdit.init(None, tcfg, device="cpu")
    params = dict(model.named_parameters())
    mask = adamw.trainable_mask(params, ("routing",))
    with pytest.warns(UserWarning, match="dead point"):
        assert train.check_routing_dead_point(params, mask)
    assert not train.check_routing_dead_point(
        params, adamw.trainable_mask(params, ("sla_proj",)))
    train.routing_warm_init(model)
    eye = torch.eye(tcfg.head_dim).expand(tcfg.num_heads, -1, -1)
    assert torch.equal(model.layers[0].sla_proj.detach(),
                       eye * train.ROUTING_WARM_EPS)
    assert not train.check_routing_dead_point(params, mask)
    with pytest.warns(UserWarning, match="dead point"):
        train.main(["--arch", "lightningdit_1b", "--smoke", "--steps", "1",
                    "--routing-mode", "learned", "--train-only", "routing",
                    "--device", "cpu"])


def test_train_cli_refuses_what_is_not_ported():
    """A mesh of more than one rank needs torch.distributed (WORLD_SIZE,
    as torchrun sets it); without it the CLI refuses the mesh flags."""
    for flags in (["--data-mesh", "2"], ["--model-mesh", "2"]):
        with pytest.raises(ValueError, match="needs torch.distributed"):
            train.main(CLI + flags + ["--device", "cpu"])
