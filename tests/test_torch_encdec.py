"""The port's Whisper-style encoder-decoder (`repro_torch.models.encdec`)
against the reference's.

Both sides start from the same weights (the JAX init with every leaf
perturbed by seeded numpy noise, so that the zero-initialized leaves are
live, carried over with `repro_torch.bridge`) and see the same numpy
inputs (`token_batch`: 128 stub audio frames and 16 text tokens), on the
smoke whisper-small (2 + 2 layers). The reference runs its gather
backend (the JAX package's plain path), once for both of the port's
backends. f32 within 5e-5 x max(1, max |ref|), bf16 within 5e-2.

- `encode` (non-causal SLA over the frames) and `decode` (causal full
  self-attention, full cross-attention) hidden states, on the port's
  gather and kernel backends (the kernel backend runs the kernels'
  plain twins on the CPU).
- `loss_fn` and its gradient of every parameter in f32, on both
  backends, under per-layer remat: one plan per encoder layer a step
  (the recompute reuses it); the bf16 loss within 5e-2.
- `prefill`'s encoder states and every decoder layer's cross K/V, then
  `decode_step` twice: logits and the self cache.
- Learned routing at its identity init gives bitwise the threshold loss
  (`tests/test_routing.py::test_other_families_init_parity`), with the
  routing head on encoder blocks only.
- The bridge round trip of the `enc` and `dec` stacks and of the cache
  (`dec_len` defaulting to max(enc_len // 8, 64)).
- The train CLI against `repro.launch.train` from the same weights:
  losses within 5e-2; `--distill` refused by both.
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
from repro.launch import train as jtrain
from repro.models import encdec as jed
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.core import plan as plan_lib
from repro_torch.distributed import ctx
from repro_torch.launch import steps, train
from repro_torch.models import encdec as ted
from repro_torch.models import registry

TOL = 5e-5
BF16_TOL = 5e-2
ARCH = "whisper-small"


def _cfgs(**sla_kw):
    jcfg, tcfg = jax_get_arch(ARCH).smoke(), get_arch(ARCH).smoke()
    if sla_kw:
        jcfg = dataclasses.replace(jcfg, sla=jcfg.sla.replace(**sla_kw))
        tcfg = dataclasses.replace(tcfg, sla=tcfg.sla.replace(**sla_kw))
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _tree(routing_mode="threshold", seed=1):
    jcfg, _ = _cfgs(routing_mode=routing_mode)
    rs = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rs.standard_normal(a.shape))
        .astype(np.float32), jed.init(jax.random.PRNGKey(0), jcfg))


def _model(tcfg, tree):
    model = ted.init(None, tcfg, device="cpu")
    model.load_state_dict(bridge.params_from_numpy(tree, device="cpu"))
    return model


def _jparams(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@functools.lru_cache(maxsize=None)
def _batch(step=0):
    jcfg, _ = _cfgs()
    shape = jax_get_shape("train_4k", smoke=True)
    return jpipeline.token_batch(jcfg, shape, jpipeline.DataConfig(seed=3),
                                 step)


def _torch_batch():
    return {k: torch.from_numpy(v) for k, v in _batch().items()}


def _close(got, want, name, tol=TOL):
    want = np.asarray(want, dtype=np.float32)
    got = np.asarray(got, dtype=np.float32)
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=name)


def _np(t):
    return t.detach().float().numpy()


def _count_plans(monkeypatch):
    calls = []
    orig = plan_lib.plan_attention
    monkeypatch.setattr(plan_lib, "plan_attention",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    return calls


@functools.lru_cache(maxsize=None)
def _jax_hidden():
    jcfg, _ = _cfgs()
    batch = _batch()

    def run(p, audio, toks):
        enc = jed.encode(p, jcfg, audio, jnp.float32, "gather")
        return enc, jed.decode(p, jcfg, toks, enc, jnp.float32, "gather")

    enc, dec = jax.jit(run)(_jparams(_tree()),
                            jnp.asarray(batch["audio_embeds"]),
                            jnp.asarray(batch["tokens"]))
    return np.asarray(enc), np.asarray(dec)


@pytest.mark.parametrize("backend", ["gather", "kernel"])
def test_encode_and_decode_match_jax(backend, monkeypatch):
    jcfg, tcfg = _cfgs()
    assert registry.get_model(tcfg) is ted
    jenc, jdec = _jax_hidden()
    model = _model(tcfg, _tree())
    batch = _torch_batch()
    calls = _count_plans(monkeypatch)
    with torch.no_grad():
        enc = ted.encode(model, tcfg, batch["audio_embeds"], torch.float32,
                         backend)
        dec = ted.decode(model, tcfg, batch["tokens"].long(), enc,
                         torch.float32, backend)
    assert len(calls) == tcfg.encoder_layers
    _close(_np(enc), jenc, "encoder states")
    _close(_np(dec), jdec, "decoder states")


@functools.lru_cache(maxsize=None)
def _jax_loss(dtype_name, grads):
    jcfg, _ = _cfgs()
    dtype = jnp.float32 if dtype_name == "f32" else jnp.bfloat16

    def loss(p):
        return jed.loss_fn(p, jcfg, _batch(), dtype, "gather")

    fn = jax.value_and_grad(loss) if grads else lambda p: (loss(p), None)
    jl, jg = jax.jit(fn)(_jparams(_tree()))
    return float(jl), jax.tree_util.tree_map(np.asarray, jg)


@pytest.mark.parametrize("backend", ["gather", "kernel"])
def test_loss_and_grads_match_jax(backend, monkeypatch):
    """Under per-layer remat: each encoder layer plans once and its
    recompute reuses the plan."""
    _, tcfg = _cfgs()
    jl, jg = _jax_loss("f32", True)
    model = _model(tcfg, _tree())
    calls = _count_plans(monkeypatch)
    with ctx.activation_sharding(remat=True):
        tl = ted.loss_fn(model, tcfg, _torch_batch(), torch.float32,
                         backend)
        tl.backward()
    assert len(calls) == tcfg.encoder_layers
    assert jl > 1.0
    _close(tl.detach().numpy(), jl, "loss")
    want = bridge.params_from_numpy(jg, device="cpu")
    assert sorted(want) == sorted(n for n, _ in model.named_parameters())
    # the decoder's sla_proj is never read (its attention is full): no
    # gradient here, an exact zero in the reference
    unread = sorted(n for n, p in model.named_parameters() if p.grad is None)
    assert unread == [f"dec.{i}.sla_proj" for i in range(tcfg.decoder_layers)]
    for name, p in model.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        _close(got.numpy(), want[name].numpy(), name)


@pytest.mark.parametrize("backend", ["gather", "kernel"])
def test_bf16_loss_matches_jax(backend):
    _, tcfg = _cfgs()
    jl, _ = _jax_loss("bf16", False)
    model = _model(tcfg, _tree())
    with torch.no_grad():
        tl = ted.loss_fn(steps.cast_params_bf16(model), tcfg,
                         _torch_batch(), torch.bfloat16, backend)
    assert abs(float(tl) - jl) <= BF16_TOL * max(1.0, abs(jl))


def test_prefill_cross_kv_and_decode_steps_match_jax():
    jcfg, tcfg = _cfgs()
    audio = _batch()["audio_embeds"]
    jp = _jparams(_tree())
    jenc, jc = jax.jit(lambda p, a: jed.prefill(
        p, jcfg, {"audio_embeds": a}, jnp.float32, "gather"))(
        jp, jnp.asarray(audio))
    model = _model(tcfg, _tree())
    with torch.no_grad():
        tenc, tc = ted.prefill(model, tcfg,
                               {"audio_embeds": torch.from_numpy(audio)},
                               torch.float32, "kernel")
    _close(_np(tenc), jenc, "encoder states")
    assert tc["pos"] == 0 and sorted(tc) == sorted(jc)
    for key in ("self_k", "self_v", "cross_k", "cross_v"):
        assert tuple(tc[key].shape) == jc[key].shape, key
        _close(_np(tc[key]), jc[key], key)
    jstep = jax.jit(lambda p, t, c: jed.decode_step(p, jcfg, t, c,
                                                    jnp.float32))
    for token in ([1, 2], [7, 300]):
        jl, jc = jstep(jp, jnp.asarray(token, jnp.int32), jc)
        with torch.no_grad():
            tl, tc = ted.decode_step(model, tcfg, torch.tensor(token), tc,
                                     torch.float32)
        _close(tl.numpy(), jl, f"logits {token}")
        for key in ("self_k", "self_v"):
            _close(_np(tc[key]), jc[key], f"{key} {token}")
        assert tc["pos"] == int(jc["pos"])


def test_learned_routing_init_parity():
    """At identity init the learned router reproduces threshold routing
    (bitwise the same loss); only encoder blocks carry the head."""
    _, cfg_t = _cfgs()
    _, cfg_l = _cfgs(routing_mode="learned")
    losses = []
    for cfg in (cfg_t, cfg_l):
        model = ted.init(torch.Generator().manual_seed(0), cfg,
                         device="cpu")
        with torch.no_grad():
            losses.append(float(ted.loss_fn(model, cfg, _torch_batch(),
                                            backend="gather")))
    assert all(hasattr(b, "routing") for b in model.enc)
    assert not any(hasattr(b, "routing") for b in model.dec)
    assert losses[0] == losses[1]


def test_bridge_round_trips_enc_dec_and_cache():
    jcfg, tcfg = _cfgs(routing_mode="learned")
    tree = _tree("learned")
    state = bridge.params_from_numpy(tree, device="cpu")
    assert "enc.1.routing.wq" in state and "dec.1.xo" in state
    assert not any(k.startswith("layers.") for k in state)
    model = _model(tcfg, tree)
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(state)
    np.testing.assert_array_equal(_np(got["dec.1.xk"]),
                                  tree["dec"]["xk"][1])
    np.testing.assert_array_equal(_np(got["enc.0.routing.wk"]),
                                  tree["enc"]["routing"]["wk"][0])
    for dec_len in (None, 24):
        empty = jax.tree_util.tree_map(
            np.asarray, jed.make_cache(jcfg, 2, 200, dec_len))
        tc = bridge.cache_from_numpy(empty, device="cpu")
        mine = ted.make_cache(tcfg, 2, 200, dec_len, device="cpu")
        assert tc["pos"] == mine["pos"] == 0
        assert mine["self_k"].shape[3] == (dec_len or 64)
        for key in ("self_k", "self_v", "cross_k", "cross_v"):
            assert tc[key].dtype == mine[key].dtype, key
            assert tuple(tc[key].shape) == tuple(mine[key].shape), key


def test_train_cli_matches_jax(monkeypatch):
    jcfg, tcfg = _cfgs()
    tree = _tree(seed=4)
    model = _model(tcfg, tree)
    monkeypatch.setattr(jed, "init", lambda rng, cfg, dtype=None:
                        _jparams(tree))
    monkeypatch.setattr(ted, "init", lambda gen, cfg, dtype=None,
                        device=None: model)
    argv = ["--arch", ARCH, "--smoke", "--steps", "2", "--log-every", "1"]
    want = jtrain.main(argv)
    got = train.main(argv + ["--device", "cpu"])
    assert len(got) == len(want) == 2
    assert all(np.isfinite(got)) and min(want) > 1.0
    np.testing.assert_allclose(got, want, atol=BF16_TOL, rtol=0)
    with pytest.raises(ValueError, match="distill_loss_fn"):
        jtrain.main(argv + ["--distill"])
    with pytest.raises(ValueError, match="distill_loss_fn"):
        train.main(argv + ["--distill", "--device", "cpu"])
