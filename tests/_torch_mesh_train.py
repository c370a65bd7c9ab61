"""The gloo training cases of tests/test_torch_mesh_train.py and
tests/test_torch_mesh_cp.py: the port's one-device run, the reference's,
and the check of a multi-rank run against both (see the first file's
docstring). CPU tests only (imports JAX).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_mesh import run_ranks, save_batches, save_weights
from _torch_mesh_worker import slot_record
from repro.configs import get_arch as jax_get_arch
from repro.models import registry as jregistry
from repro.optim import adamw as jadamw
from repro_torch import bridge
from repro_torch.configs import get_arch, get_shape
from repro_torch.data import pipeline
from repro_torch.distributed import ctx
from repro_torch.launch import steps, train
from repro_torch.models import moe, registry
from repro_torch.optim import adamw

TOL = 5e-5
# eps 1e-3: Adam's per-element normalization would turn a gradient element
# at rounding-noise level (|g| ~ 1e-7, summed in another order over the
# ranks) into a step of +-lr; with eps above that noise the parameters
# after the steps are a check of the gradients, which are held directly
OPT = dict(lr=1e-3, eps=1e-3, warmup_steps=1, total_steps=10)


def _close(got, want, name):
    want = np.asarray(want, dtype=np.float32)
    atol = TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32), want,
                               atol=atol, rtol=0, err_msg=name)


def _cfgs(arch, overrides=()):
    """(reference, port) smoke configs of `arch` with the case's
    overrides, ((name, value), ...), on both sides."""
    kw = dict(overrides)
    return (dataclasses.replace(jax_get_arch(arch).smoke(), **kw),
            dataclasses.replace(get_arch(arch).smoke(), **kw))


@functools.lru_cache(maxsize=None)
def _setup(arch, overrides=(), batch=None):
    """(perturbed reference tree as numpy, two batches as numpy, their
    first `batch` rows when given)."""
    jcfg, cfg = _cfgs(arch, overrides)
    rs = np.random.default_rng(11)
    tree = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rs.standard_normal(a.shape))
        .astype(np.float32),
        jregistry.get_model(jcfg).init(jax.random.PRNGKey(0), jcfg))
    it = pipeline.make_iterator(cfg, get_shape("train_4k", smoke=True),
                                pipeline.DataConfig(seed=3))
    batches = [next(it) for _ in range(2)]
    if batch is not None:
        batches = [{k: v[:batch] for k, v in b.items()} for b in batches]
    return tree, batches


def _reference(arch, losses, overrides=(), batch=None):
    """The reference on one device: first loss and grads, then a loss per
    AdamW step and the final params, all as port-named numpy."""
    jcfg, _ = _cfgs(arch, overrides)
    tree, batches = _setup(arch, overrides, batch)
    mdl = jregistry.get_model(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, tree)

    def loss_of(p, batch, name):
        return getattr(mdl, name)(p, jcfg, batch, jnp.float32, "gather")

    jb = [jax.tree_util.tree_map(jnp.asarray, b) for b in batches]
    grad = {name: jax.jit(jax.value_and_grad(
        functools.partial(loss_of, name=name))) for name in set(losses)}
    l0, g0 = grad[losses[0]](params, jb[0])
    opt = jadamw.init(params)
    opt_cfg = jadamw.AdamWConfig(**OPT)
    step_losses = []
    for batch, name in zip(jb, losses):
        loss, grads = grad[name](params, batch)
        params, opt, _ = jadamw.update(params, grads, opt, opt_cfg)
        step_losses.append(float(loss))
    names = lambda t: {n: v.numpy() for n, v in bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, t), device="cpu").items()}
    return dict(loss0=float(l0), grads=names(g0), losses=step_losses,
                params=names(params))


def _one_device(arch, losses, overrides=(), batch=None):
    """The port on one device, as the ranks run it; with the kept slots
    of its MoE calls."""
    _, cfg = _cfgs(arch, overrides)
    tree, batches = _setup(arch, overrides, batch)
    mdl = registry.get_model(cfg)
    slots, route = [], moe.route

    def recorded_route(*a, **kw):
        got = route(*a, **kw)
        slots.append(got["keep_all"])
        return got

    moe.route = recorded_route
    try:
        out = _one_device_run(cfg, mdl, tree, batches, losses)
    finally:
        moe.route = route
    out["slots"] = slot_record(slots)
    return out


def _one_device_run(cfg, mdl, tree, batches, losses):
    model = mdl.init(None, cfg, device="cpu")
    model.load_state_dict(bridge.params_from_numpy(tree, device="cpu"))
    tb = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    with ctx.activation_sharding(None, remat=True):
        loss0 = getattr(mdl, losses[0])(model, cfg, tb[0], torch.float32,
                                        "kernel")
        loss0.backward()
        grads = {n: (p.grad if p.grad is not None
                     else torch.zeros_like(p)).numpy().copy()
                 for n, p in model.named_parameters()}
        for p in model.parameters():
            p.grad = None
        opt = adamw.init(dict(model.named_parameters()))
        step_losses, gnorms = [], []
        for batch, name in zip(tb, losses):
            step = steps.make_train_step(
                cfg, adamw.AdamWConfig(**OPT), "kernel",
                distill=name == "distill_loss_fn", compute_bf16=False,
                compute_dtype=torch.float32)
            model, opt, loss, gnorm = step(model, opt, batch)
            step_losses.append(float(loss))
            gnorms.append(float(gnorm))
    return dict(loss0=float(loss0.detach()), grads=grads,
                losses=step_losses, gnorms=gnorms,
                params={n: p.detach().numpy().copy()
                        for n, p in model.named_parameters()})


def _run_case(arch, mesh, losses, tmp_path, overrides=(), batch=None):
    tree, batches = _setup(arch, overrides, batch)
    return run_ranks(
        "train", mesh[0] * mesh[1], tmp_path, arch=arch, mesh=list(mesh),
        steps=2, losses=list(losses), backend="kernel", grads=True,
        opt=OPT, overrides=dict(overrides), weights=save_weights(
            tmp_path / "w.npz", bridge.params_from_numpy(tree, "cpu")),
        batches=save_batches(tmp_path / "b.npz", batches))


def check_one_rank_is_plain(arch, losses, tmp_path):
    """A 1 x 1 mesh of one gloo rank runs the mesh path's collectives and
    DTensor gathers: its first loss and gradients, step losses, grad
    norms, final parameters and MoE kept slots are bitwise the port's
    one-device run."""
    res = _run_case(arch, (1, 1), losses, tmp_path)
    want = _one_device(arch, losses)
    assert np.array_equal(res["slots"], want["slots"])
    if res["vocab"].size:
        assert res["vocab"][:, 1].all()  # through the vocab-parallel code
    assert float(res["grad_loss"]) == want["loss0"]
    for n, g in want["grads"].items():
        assert np.array_equal(res[f"grad/{n}"], g), f"grad {n}"
    assert res["losses"][:, 0].tolist() == want["losses"]
    assert res["losses"][:, 1].tolist() == want["gnorms"]
    for n, p in want["params"].items():
        assert np.array_equal(res[f"param/{n}"], p), f"param {n}"


def check_train_case(arch, mesh, losses, tmp_path, overrides=(),
                     batch=None):
    """Run the case on mesh[0] x mesh[1] ranks and hold it to the port's
    and the reference's one-device runs (module docstring of
    tests/test_torch_mesh_train.py); `overrides` ((name, value), ...)
    change the smoke config on every side, `batch` keeps the batches'
    first rows. An MoE model's kept and dropped slots are bitwise the
    one-device run's, call by call."""
    tree, batches = _setup(arch, overrides, batch)
    _, cfg = _cfgs(arch, overrides)
    res = _run_case(arch, mesh, losses, tmp_path, overrides, batch)
    # each "model" rank read its rows of the vocabulary, never the whole
    if cfg.family != "dit":
        assert len(res["vocab"]) and (res["vocab"][:, 0]
                                      == cfg.vocab_size // mesh[1]).all()
        assert res["vocab"][:, 1].all()
    # the layout each rank attended in
    b = batches[0]["tokens" if "tokens" in batches[0] else "latents"]
    b, seq = b.shape[0], get_shape("train_4k", smoke=True).seq_len
    cp = b % mesh[0] != 0
    assert ("'data'" in str(res["residual"])) and \
        (str(res["residual"]).startswith("(None") == cp)
    shapes = res["attn_shapes"]
    if cfg.family == "ssm":
        assert shapes.size == 0  # no attention
    else:
        whole = {seq}
        queries = {seq}
        if cfg.family == "encdec":
            # the encoder's frames and the decoder's text; the
            # cross-attention's queries are this rank's text rows
            text = batches[0]["tokens"].shape[1]
            whole = {seq, text}
            queries = whole | {text // mesh[0] if cp else text}
        assert (shapes[:, 0] == (b if cp else b // mesh[0])).all()
        assert (shapes[:, 1] == cfg.num_heads // mesh[1]).all()
        assert set(shapes[:, 2].tolist()) <= queries
        assert set(shapes[:, 6].tolist()) <= whole
        kv = cfg.num_kv_heads
        assert (shapes[:, 5] == (kv // mesh[1] if kv % mesh[1] == 0
                                 else cfg.num_heads // mesh[1])).all()
    one = _one_device(arch, losses, overrides, batch)
    # the MoE's capacity decisions are the global ones, bitwise
    assert res["slots"].shape == one["slots"].shape
    assert np.array_equal(res["slots"], one["slots"])
    for want in (one, _reference(arch, losses, overrides, batch)):
        _close(res["grad_loss"], want["loss0"], "loss")
        for n, g in want["grads"].items():
            _close(res[f"grad/{n}"], g, f"grad {n}")
        _close(res["losses"][:, 0], want["losses"], "step losses")
        for n, p in want["params"].items():
            _close(res[f"param/{n}"], p, f"param {n}")
    return res


def check_cli_resume(arch, tmp_path, capsys, monkeypatch):
    """The train CLI at smoke `arch` on a 2 x 2 mesh of 4 ranks, its loss
    in f32 on both sides (`make_train_step(compute_dtype=)` patched in):
    3 steps checkpointing every step, the last checkpoint deleted, the
    same command again, which resumes from step 2. The straight run's
    losses are within 5e-5 x max(1, |loss|) of one device's, and the
    resumed step's loss is bitwise the straight run's."""
    monkeypatch.setattr(train, "make_train_step", functools.partial(
        steps.make_train_step, compute_dtype=torch.float32))
    cli = ["--arch", arch, "--smoke", "--steps", "3", "--device", "cpu",
           "--log-every", "1", "--seed", "2"]
    want = train.main(cli)
    capsys.readouterr()
    ckpt = tmp_path / "ckpt"
    argv = cli + ["--data-mesh", "2", "--model-mesh", "2", "--ckpt-dir",
                  str(ckpt), "--ckpt-every", "1"]
    res = run_ranks("cli", 4, tmp_path, argvs=[argv, argv],
                    drop=str(ckpt / "step_3"))
    got, resumed = res["losses0"], res["losses1"]
    assert len(got) == len(want) == 3 and len(resumed) == 1
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * max(1.0, max(map(abs, want))))
    assert resumed[0] == got[2]
    assert "resumed from step 2" in res["logs"][0]
    assert all("resumed" not in log for log in res["logs"][1:])
