"""The port's Mamba2 block and zamba2 hybrid (`repro_torch.models.mamba2`,
`repro_torch.models.hybrid`) against the reference's.

Both sides start from the same weights (the JAX init with every leaf
perturbed by seeded numpy noise, so that the zero-initialized leaves are
live, carried over with `repro_torch.bridge`) and see the same numpy
inputs, on the smoke zamba2-1.2b (4 Mamba2 layers in segments of 2, the
shared SLA block applied twice). The reference runs its gather backend
(the JAX package's plain path), once for both of the port's backends.

- `mamba_apply`: a 24-token prefill from no state, then one token with a
  conv tail and a state, f32 within 5e-5 x max(1, max |ref|).
- `forward` hidden states and `prefill`'s last hidden state and cache
  (SSM states, conv tails, the shared block's K/V), f32, on the port's
  gather and kernel backends (the kernel backend runs the kernels'
  plain twins on the CPU); one plan per shared-block application.
- `decode_step` twice from the reference's prefill cache with the K/V
  grown by 8 as `tests/test_models.py` grows it: logits and every cache
  leaf within 5e-5 x max(1, max |ref|).
- `loss_fn` and its gradient of every parameter in f32 on both
  backends within 5e-5 x max(1, max |g|); the bf16 loss within 5e-2.
- Learned routing at its identity init gives bitwise the threshold loss
  (`tests/test_routing.py::test_other_families_init_parity`).
- The bridge round trip of the unstacked `shared_attn` tree (its
  `routing` inside) and of the cache; `segments` at full depth.
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
from repro.models import hybrid as jhyb
from repro.models import mamba2 as jmamba
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.core import plan as plan_lib
from repro_torch.launch import steps, train
from repro_torch.models import hybrid as thyb
from repro_torch.models import mamba2 as tmamba
from repro_torch.models import registry

TOL = 5e-5
BF16_TOL = 5e-2
ARCH = "zamba2-1.2b"


def _cfgs(**sla_kw):
    jcfg, tcfg = jax_get_arch(ARCH).smoke(), get_arch(ARCH).smoke()
    if sla_kw:
        jcfg = dataclasses.replace(jcfg, sla=jcfg.sla.replace(**sla_kw))
        tcfg = dataclasses.replace(tcfg, sla=tcfg.sla.replace(**sla_kw))
    return jcfg, tcfg


def _perturb(tree, seed):
    rs = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rs.standard_normal(a.shape))
        .astype(np.float32), tree)


@functools.lru_cache(maxsize=None)
def _tree(routing_mode="threshold", seed=1):
    jcfg, _ = _cfgs(routing_mode=routing_mode)
    return _perturb(jhyb.init(jax.random.PRNGKey(0), jcfg), seed)


def _model(tcfg, tree):
    model = thyb.init(None, tcfg, device="cpu")
    model.load_state_dict(bridge.params_from_numpy(tree, device="cpu"))
    return model


def _jparams(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _batch(jcfg, step=0):
    shape = jax_get_shape("train_4k", smoke=True)
    return jpipeline.token_batch(jcfg, shape, jpipeline.DataConfig(seed=3),
                                 step)


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


def test_segments_split_the_stack_as_the_reference():
    full = get_arch(ARCH)
    assert thyb.segments(full) == jhyb._segments(jax_get_arch(ARCH)) \
        == [6, 6, 6, 6, 6, 6, 2]
    assert thyb.segments(full.smoke()) == [2, 2]
    assert registry.get_model(full) is thyb


def test_mamba_apply_prefill_and_step_match_jax():
    """A 24-token chunked prefill from no state, then one step from a
    conv tail and state (the single-step path), f32."""
    jcfg, tcfg = _cfgs()
    tree = _perturb(jmamba.mamba_init(jax.random.PRNGKey(2), jcfg), 5)
    layer = tmamba.MambaLayer(tcfg, device="cpu")
    layer.load_state_dict(bridge.params_from_numpy(tree, device="cpu"))
    rs = np.random.default_rng(6)
    x = rs.standard_normal((2, 24, tcfg.d_model)).astype(np.float32)
    x1 = rs.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
    jp = _jparams(tree)
    japply = jax.jit(lambda p, x, t, s: jmamba.mamba_apply(
        p, x, jcfg, conv_tail=t, state=s))
    jo, (js, jt) = japply(jp, jnp.asarray(x), None, None)
    with torch.no_grad():
        to, (ts, tt) = tmamba.mamba_apply(layer, torch.from_numpy(x), tcfg)
    _close(_np(to), jo, "prefill out")
    _close(_np(ts), js, "prefill state")
    _close(_np(tt), jt, "prefill tail")
    jo1, (js1, jt1) = japply(jp, jnp.asarray(x1), jt, js)
    with torch.no_grad():
        to1, (ts1, tt1) = tmamba.mamba_apply(
            layer, torch.from_numpy(x1), tcfg, conv_tail=tt, state=ts)
    _close(_np(to1), jo1, "step out")
    _close(_np(ts1), js1, "step state")
    _close(_np(tt1), jt1, "step tail")


@functools.lru_cache(maxsize=None)
def _jax_forward_cache():
    jcfg, _ = _cfgs()
    x, _, cache = jax.jit(lambda p, t: jhyb.forward(
        p, jcfg, t, jnp.float32, "gather", return_cache=True))(
        _jparams(_tree()), jnp.asarray(_batch(jcfg)["tokens"]))
    return np.asarray(x), jax.tree_util.tree_map(np.asarray, cache)


@pytest.mark.parametrize("backend", ["gather", "kernel"])
def test_forward_and_prefill_match_jax(backend, monkeypatch):
    jcfg, tcfg = _cfgs()
    jx, jcache = _jax_forward_cache()
    model = _model(tcfg, _tree())
    toks = torch.from_numpy(_batch(jcfg)["tokens"]).long()
    calls = _count_plans(monkeypatch)
    with torch.no_grad():
        x, aux = thyb.forward(model, tcfg, toks, torch.float32, backend)
        last, cache = thyb.prefill(model, tcfg, toks, torch.float32,
                                   backend)
    assert len(calls) == 2 * len(thyb.segments(tcfg))
    assert float(aux) == 0.0
    _close(_np(x), jx, "forward")
    _close(_np(last), jx[:, -1], "prefill last hidden")
    assert cache["pos"] == toks.shape[1]
    assert sorted(cache) == sorted(list(jcache) + ["pos"])
    for key, want in jcache.items():
        assert tuple(cache[key].shape) == want.shape, key
        _close(_np(cache[key]), want, key)


def _grow(cache):
    """The reference test's growth: the K/V caches 8 longer, zero-padded."""
    return {k: (np.concatenate([v, np.zeros(v.shape[:3] + (8,)
                                            + v.shape[4:], v.dtype)], 3)
                if k in ("attn_k", "attn_v") else v)
            for k, v in cache.items()}


def test_decode_steps_match_jax():
    jcfg, tcfg = _cfgs()
    _, jcache = _jax_forward_cache()
    seq = _batch(jcfg)["tokens"].shape[1]
    jc = {k: jnp.asarray(v) for k, v in _grow(jcache).items()}
    jc["pos"] = jnp.int32(seq)
    tc = bridge.cache_from_numpy(dict(_grow(jcache), pos=np.int32(seq)),
                                 device="cpu")
    assert tc["pos"] == seq
    model = _model(tcfg, _tree())
    jstep = jax.jit(lambda p, t, c: jhyb.decode_step(p, jcfg, t, c,
                                                     jnp.float32))
    jp = _jparams(_tree())
    for token in ([1, 2], [7, 300]):
        jl, jc = jstep(jp, jnp.asarray(token, jnp.int32), jc)
        with torch.no_grad():
            tl, tc = thyb.decode_step(model, tcfg, torch.tensor(token), tc,
                                      torch.float32)
        _close(tl.numpy(), jl, f"logits {token}")
        for key in ("ssm", "conv", "attn_k", "attn_v"):
            _close(_np(tc[key]), jc[key], f"{key} {token}")
        assert tc["pos"] == int(jc["pos"])


@functools.lru_cache(maxsize=None)
def _jax_loss(dtype_name, grads):
    jcfg, _ = _cfgs()
    dtype = jnp.float32 if dtype_name == "f32" else jnp.bfloat16

    def loss(p):
        return jhyb.loss_fn(p, jcfg, _batch(jcfg), dtype, "gather")

    fn = jax.value_and_grad(loss) if grads else lambda p: (loss(p), None)
    jl, jg = jax.jit(fn)(_jparams(_tree()))
    return float(jl), jax.tree_util.tree_map(np.asarray, jg)


@pytest.mark.parametrize("backend", ["gather", "kernel"])
def test_loss_and_grads_match_jax(backend):
    jcfg, tcfg = _cfgs()
    jl, jg = _jax_loss("f32", True)
    model = _model(tcfg, _tree())
    batch = {k: torch.from_numpy(v) for k, v in _batch(jcfg).items()}
    tl = thyb.loss_fn(model, tcfg, batch, torch.float32, backend)
    tl.backward()
    assert jl > 1.0
    _close(tl.detach().numpy(), jl, "loss")
    want = bridge.params_from_numpy(jg, device="cpu")
    assert sorted(want) == sorted(n for n, _ in model.named_parameters())
    for name, p in model.named_parameters():
        _close(p.grad.numpy(), want[name].numpy(), name)


@pytest.mark.parametrize("backend", ["gather", "kernel"])
def test_bf16_loss_matches_jax(backend):
    """bf16 compute on a bf16 copy of the weights, as the train step
    runs."""
    jcfg, tcfg = _cfgs()
    jl, _ = _jax_loss("bf16", False)
    model = _model(tcfg, _tree())
    batch = {k: torch.from_numpy(v) for k, v in _batch(jcfg).items()}
    with torch.no_grad():
        tl = thyb.loss_fn(steps.cast_params_bf16(model), tcfg, batch,
                          torch.bfloat16, backend)
    assert abs(float(tl) - jl) <= BF16_TOL * max(1.0, abs(jl))


def test_learned_routing_init_parity():
    """At identity init the learned router reproduces threshold routing:
    the same seeded init gives bitwise the same loss."""
    _, cfg_t = _cfgs()
    _, cfg_l = _cfgs(routing_mode="learned")
    jcfg, _ = _cfgs()
    batch = {k: torch.from_numpy(v) for k, v in _batch(jcfg).items()}
    losses = []
    for cfg in (cfg_t, cfg_l):
        model = thyb.init(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
        with torch.no_grad():
            losses.append(float(thyb.loss_fn(model, cfg, batch,
                                             backend="gather")))
    assert hasattr(model.shared_attn, "routing")
    assert losses[0] == losses[1]


def test_bridge_round_trips_shared_attn_and_cache():
    jcfg, tcfg = _cfgs(routing_mode="learned")
    tree = _tree("learned")
    state = bridge.params_from_numpy(tree, device="cpu")
    assert "shared_attn.routing.wq" in state and "shared_attn.wq" in state
    assert "layers.3.in_proj" in state
    model = _model(tcfg, tree)
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(state)
    np.testing.assert_array_equal(
        _np(got["shared_attn.routing.wk"]), tree["shared_attn"]["routing"]
        ["wk"])
    np.testing.assert_array_equal(_np(got["layers.2.conv"]),
                                  tree["layers"]["conv"][2])
    empty = jax.tree_util.tree_map(
        np.asarray, jhyb.make_cache(jcfg, 2, 40))
    tc = bridge.cache_from_numpy(empty, device="cpu")
    mine = thyb.make_cache(tcfg, 2, 40, device="cpu")
    assert tc["pos"] == mine["pos"] == 0
    for key in ("ssm", "conv", "attn_k", "attn_v"):
        assert tc[key].dtype == mine[key].dtype, key
        assert tuple(tc[key].shape) == tuple(mine[key].shape), key


def test_train_cli_matches_jax(monkeypatch):
    """Both CLIs from the same weights (each package's `init` patched to
    hand them over), 2 steps: the losses within 5e-2. `--distill` is
    refused by both (the family has no distillation loss)."""
    jcfg, tcfg = _cfgs()
    tree = _tree(seed=4)
    model = _model(tcfg, tree)
    monkeypatch.setattr(jhyb, "init", lambda rng, cfg, dtype=None:
                        _jparams(tree))
    monkeypatch.setattr(thyb, "init", lambda gen, cfg, dtype=None,
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
