"""The VLM family (internvl2-1b), port against JAX.

The port's transformer takes the VLM prefix as the reference's does: the
patch embeddings (the vision frontend is a stub in both packages) are
prepended to the token embeddings in the compute dtype, share the rope
positions 0 .. P + S - 1, and `loss_fn` leaves their P rows out. On the
smoke internvl2-1b (2 layers, d 128, 4 query / 2 kv heads of 32, 16
patches) with JAX-initialized weights carried over by
`bridge.params_from_numpy` (`sla_proj` drawn again) and the reference's
own `token_batch`, at f32 on the gather backend:

  * `token_batch` (tokens, targets and patch_embeds) is bitwise the
    reference's, and `registry.get_model` maps `vlm` to the transformer;
  * `forward` with the prefix, `loss_fn` with its gradients for every
    parameter, and `distill_loss_fn`, within 5e-5 x max(1, max |ref|);
  * two steps of the train CLI on the CPU from the same weights: the
    first loss (bf16 compute) within 5e-2 of the reference's f32 loss on
    the same batch.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.configs import get_arch as jax_get_arch
from repro.configs import get_shape as jax_get_shape
from repro.data import pipeline as jpipeline
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.configs import get_arch, get_shape
from repro_torch.data import pipeline
from repro_torch.launch import train
from repro_torch.models import registry
from repro_torch.models import transformer as ttfm

ARCH = "internvl2-1b"
TOL, LOSS_TOL = 5e-5, 5e-2


def _close(got, want, what, tol=TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    limit = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= limit, (what, err, limit)


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg, tcfg = jax_get_arch(ARCH).smoke(), get_arch(ARCH).smoke()
    params = jtfm.init(jax.random.PRNGKey(0), jcfg)
    rs = np.random.default_rng(7)
    params["layers"]["sla_proj"] = jnp.asarray(0.1 * rs.standard_normal(
        params["layers"]["sla_proj"].shape, dtype=np.float32))
    # the train CLI's first batch (seed 0, step 0)
    batch = jpipeline.token_batch(jcfg, jax_get_shape("train_4k", True),
                                  jpipeline.DataConfig(seed=0), 0)
    return jcfg, tcfg, params, batch


def _model(tcfg, params):
    model = ttfm.init(None, tcfg, device="cpu")
    model.load_state_dict(bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), device="cpu"))
    return model


@functools.lru_cache(maxsize=None)
def _reference():
    """The reference's hidden states with the prefix, loss_fn's value and
    gradients, and distill_loss_fn's value, in f32 (one compile)."""
    jcfg, _, params, batch = _setup()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def run(p):
        x, _ = jtfm.forward(p, jcfg, jb["tokens"],
                            prefix_embeds=jb["patch_embeds"],
                            compute_dtype=jnp.float32)
        loss, grads = jax.value_and_grad(
            lambda q: jtfm.loss_fn(q, jcfg, jb, jnp.float32))(p)
        return x, loss, grads, jtfm.distill_loss_fn(p, jcfg, jb,
                                                    jnp.float32)

    return jax.tree_util.tree_map(np.asarray, jax.jit(run)(params))


def test_token_batch_is_bitwise_the_reference():
    jcfg, tcfg = jax_get_arch(ARCH).smoke(), get_arch(ARCH).smoke()
    assert registry.get_model(tcfg) is ttfm
    assert registry.get_model(get_arch(ARCH)) is ttfm
    for name in ("train_4k", "prefill_32k"):
        for step in (0, 3):
            dc = dict(seed=5, num_hosts=2, host_id=1)
            want = jpipeline.token_batch(jcfg, jax_get_shape(name, True),
                                         jpipeline.DataConfig(**dc), step)
            got = pipeline.token_batch(tcfg, get_shape(name, smoke=True),
                                       pipeline.DataConfig(**dc), step)
            assert sorted(got) == sorted(want) == [
                "patch_embeds", "targets", "tokens"]
            for key in want:
                assert got[key].dtype == want[key].dtype
                assert np.array_equal(got[key], want[key]), key
            seq = get_shape(name, smoke=True).seq_len
            assert got["tokens"].shape[1] == seq - tcfg.num_patches
            assert got["patch_embeds"].shape[1:] == (tcfg.num_patches,
                                                     tcfg.d_model)


def test_forward_loss_distill_and_grads_match_reference():
    _, tcfg, params, batch = _setup()
    jx, jloss, jgrads, jdistill = _reference()
    model = _model(tcfg, params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        tx, _ = ttfm.forward(model, tcfg, tb["tokens"].long(),
                             prefix_embeds=tb["patch_embeds"],
                             compute_dtype=torch.float32)
        tdistill = ttfm.distill_loss_fn(model, tcfg, tb, torch.float32)
    p, s = tcfg.num_patches, batch["tokens"].shape[1]
    assert tx.shape == jx.shape == (2, p + s, tcfg.d_model)
    _close(tx, jx, "hidden")
    _close(tdistill, jdistill, "distill loss")
    loss = ttfm.loss_fn(model, tcfg, tb, torch.float32)
    loss.backward()
    assert float(jloss) > 1.0
    _close(loss, jloss, "loss")
    want = bridge.params_from_numpy(jgrads, device="cpu")
    assert sorted(want) == sorted(n for n, _ in model.named_parameters())
    for name, prm in model.named_parameters():
        _close(prm.grad, want[name].numpy(), name)


def test_the_prefix_shares_the_rope_positions_and_the_loss_skips_it():
    """Prepending the patches equals running the concatenated embeddings
    as one sequence (positions run on through the prefix), and the loss
    is the cross-entropy of the token rows alone."""
    _, tcfg, params, batch = _setup()
    model = _model(tcfg, params)
    tok = torch.from_numpy(batch["tokens"][:1, :32]).long()
    pe = torch.from_numpy(batch["patch_embeds"][:1])
    with torch.no_grad():
        x, _ = ttfm.forward(model, tcfg, tok, prefix_embeds=pe,
                            compute_dtype=torch.float32)
        emb = torch.cat([pe, model.embed[tok]], dim=1)
        y, _ = ttfm.forward(model, tcfg, None, prefix_embeds=emb,
                            compute_dtype=torch.float32)
    assert torch.equal(x, y)


def test_train_cli_two_steps_on_cpu(monkeypatch):
    jcfg, tcfg, params, _ = _setup()
    _, jloss, _, _ = _reference()
    model = _model(tcfg, params)
    monkeypatch.setattr(ttfm, "init", lambda gen, cfg, dtype=None,
                        device=None: model)
    losses = train.main(["--arch", ARCH, "--smoke", "--steps", "2",
                         "--log-every", "1", "--device", "cpu"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    np.testing.assert_allclose(losses[0], float(jloss),
                               atol=LOSS_TOL * max(1.0, float(jloss)), rtol=0)
