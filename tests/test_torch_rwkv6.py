"""The port's RWKV6 (`repro_torch.models.rwkv6`) against the reference's,
and the serving refusals of the recurrent family.

Both sides start from the same weights (the JAX init with every leaf
perturbed by seeded numpy noise, carried over with `repro_torch.bridge`)
and see the same numpy inputs, on two configs: the smoke rwkv6-7b as the
reference makes it ("smoke": 2 layers, d_model 128, and the full config's
64 heads, so d_model // ssm_heads = 2-wide heads) and the same with 4
heads of 32 ("h4").

Tolerances. On "h4", f32 within 5e-5 x max(1, max |ref|) for hidden
states, logits, caches, the loss and every parameter gradient. The
smoke config's 2-wide per-head group norm is ill-conditioned in f32: on
these inputs some heads' two outputs agree to within rounding (variance
down to 3e-12 against the norm's eps 1e-5), so WKV outputs that agree to
2e-7 relative (f32 summation order) differ by up to 1.1e-4 x max |ref|
after the norm, in the hidden states and logits, and by up to 15% in the
gradient of `layers.0.ln1`. There the WKV states and the loss are held
to 5e-5, the hidden states, logits and the other cache leaves to 5e-4
(4.5x the measured 1.1e-4), and gradients only on "h4".

- `forward` hidden states and `prefill`'s last hidden state and cache
  (per-layer WKV states, the time-mix and channel-mix last inputs); the
  per-head group norm's population variance and the decay's f32 clip
  are inside.
- `decode_step` twice from the reference's prefill cache: logits and
  every cache leaf; and the reference test's decode-against-forward
  consistency on the port (decoding token 17 after a 16-token prefill
  gives the forward's last logits).
- `loss_fn` (both configs) and its gradient of every parameter ("h4") in
  f32; the bf16 loss within 5e-2.
- The bridge round trip of the cache; the train CLI against
  `repro.launch.train` within 5e-2 and `--distill` refused by both.
- Serving refusals at parity with the reference: the continuous
  `Scheduler` and the decode-SLA `ServingEngine` reject the family
  (`check_serving_family`), and the static engine's `_grow_cache` raises
  on the unknown cache leaf `state`.
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
from repro.models import rwkv6 as jrwkv
from repro.serving.api import Scheduler as JScheduler
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.launch import steps, train
from repro_torch.models import registry
from repro_torch.models import rwkv6 as trwkv
from repro_torch.serving.api import Scheduler
from repro_torch.serving.engine import Request, ServingEngine

TOL = 5e-5
SMOKE_TOL = 5e-4  # 2-wide group norm: see the module docstring
BF16_TOL = 5e-2
ARCH = "rwkv6-7b"
CFGS = ("h4", "smoke")
# per config: (hidden states, logits, x1/x2 caches; WKV states and loss)
TOLS = {"h4": (TOL, TOL), "smoke": (SMOKE_TOL, TOL)}


def _cfgs(name="smoke"):
    jcfg, tcfg = jax_get_arch(ARCH).smoke(), get_arch(ARCH).smoke()
    if name == "h4":
        jcfg = dataclasses.replace(jcfg, ssm_heads=4)
        tcfg = dataclasses.replace(tcfg, ssm_heads=4)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _tree(name="smoke", seed=1):
    jcfg, _ = _cfgs(name)
    rs = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rs.standard_normal(a.shape))
        .astype(np.float32), jrwkv.init(jax.random.PRNGKey(0), jcfg))


def _model(tcfg, tree):
    model = trwkv.init(None, tcfg, device="cpu")
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


@functools.lru_cache(maxsize=None)
def _jax_forward_cache(name):
    jcfg, _ = _cfgs(name)
    x, _, (st, x1, x2) = jax.jit(lambda p, t: jrwkv.forward(
        p, jcfg, t, jnp.float32, return_cache=True))(
        _jparams(_tree(name)), jnp.asarray(_batch(jcfg)["tokens"]))
    return np.asarray(x), {"state": np.asarray(st), "x1": np.asarray(x1),
                           "x2": np.asarray(x2)}


@pytest.mark.parametrize("name", CFGS)
def test_forward_and_prefill_match_jax(name):
    jcfg, tcfg = _cfgs(name)
    tol, state_tol = TOLS[name]
    assert registry.get_model(tcfg) is trwkv
    jx, jcache = _jax_forward_cache(name)
    model = _model(tcfg, _tree(name))
    toks = torch.from_numpy(_batch(jcfg)["tokens"]).long()
    with torch.no_grad():
        x, aux = trwkv.forward(model, tcfg, toks, torch.float32)
        last, cache = trwkv.prefill(model, tcfg, toks, torch.float32)
    assert float(aux) == 0.0
    _close(_np(x), jx, "forward", tol)
    _close(_np(last), jx[:, -1], "prefill last hidden", tol)
    assert cache["pos"] == toks.shape[1]
    for key, want in jcache.items():
        assert tuple(cache[key].shape) == want.shape, key
        _close(_np(cache[key]), want, key,
               state_tol if key == "state" else tol)


@pytest.mark.parametrize("name", CFGS)
def test_decode_steps_match_jax(name):
    jcfg, tcfg = _cfgs(name)
    tol, state_tol = TOLS[name]
    _, jcache = _jax_forward_cache(name)
    seq = _batch(jcfg)["tokens"].shape[1]
    jc = {k: jnp.asarray(v) for k, v in jcache.items()}
    jc["pos"] = jnp.int32(seq)
    tc = bridge.cache_from_numpy(dict(jcache, pos=np.int32(seq)),
                                 device="cpu")
    model = _model(tcfg, _tree(name))
    jstep = jax.jit(lambda p, t, c: jrwkv.decode_step(p, jcfg, t, c,
                                                      jnp.float32))
    jp = _jparams(_tree(name))
    for token in ([1, 2], [7, 300]):
        jl, jc = jstep(jp, jnp.asarray(token, jnp.int32), jc)
        with torch.no_grad():
            tl, tc = trwkv.decode_step(model, tcfg, torch.tensor(token),
                                       tc, torch.float32)
        _close(tl.numpy(), jl, f"logits {token}", tol)
        for key in ("state", "x1", "x2"):
            _close(_np(tc[key]), jc[key], f"{key} {token}",
                   state_tol if key == "state" else tol)
        assert tc["pos"] == int(jc["pos"])


def test_decode_consistent_with_forward():
    """`tests/test_models.py::test_rwkv_decode_consistent_with_forward`
    on the port: prefill 16 tokens, decode the 17th, and the logits are
    the full forward's last (2e-2, the reference test's limit)."""
    _, tcfg = _cfgs()
    model = _model(tcfg, _tree())
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, tcfg.vocab_size, (1, 17)))
    with torch.no_grad():
        x, _ = trwkv.forward(model, tcfg, toks, torch.float32)
        want = x[0, -1].float() @ model.embed.float().t()
        _, cache = trwkv.prefill(model, tcfg, toks[:, :-1], torch.float32)
        got, _ = trwkv.decode_step(model, tcfg, toks[:, -1], cache,
                                   torch.float32)
    np.testing.assert_allclose(got[0].numpy(), want.numpy(), atol=2e-2,
                               rtol=2e-2)


def _drift(run, toks, prompt):
    """max |decode_step logits - forward logits| over the tokens after
    `prompt`, and max |forward logits|, for one package's `run`."""
    fwd, dec = run(toks, prompt)
    return float(np.abs(dec - fwd).max()), float(np.abs(fwd).max())


def test_bf16_decode_drift_is_the_reference_drift():
    """In bf16 the chunked forward rounds its (C, C) matrices to bf16 and
    the decode step does not (the reference's design), so decode logits
    drift from the forward's by far more than f32 rounding, and more the
    deeper and wider the model (`chip_smoke.py` phase 25 measures it at
    full rwkv6-7b width and holds only the f32 run, as the reference's
    test). Here the port's bf16 drift is at most twice the reference's
    on the same weights and tokens, and its f32 drift below 1e-4 of max
    |logits| (the reference's own f32 drift is `tests/test_models.py`'s
    to hold)."""
    jcfg, tcfg = _cfgs("h4")
    tree = _tree("h4")
    jp = _jparams(tree)
    model = _model(tcfg, tree)
    prompt, new = 60, 4
    toks = np.random.default_rng(9).integers(
        0, tcfg.vocab_size, (2, prompt + new)).astype(np.int32)
    emb = tree["embed"].astype(np.float32)

    def jax_run(dtype):
        def run(toks, prompt):
            x, _ = jax.jit(lambda p, t: jrwkv.forward(p, jcfg, t, dtype))(
                jp, jnp.asarray(toks))
            fwd = np.asarray(x[:, prompt:], np.float32) @ emb.T
            _, c = jax.jit(lambda p, t: jrwkv.prefill(p, jcfg, t, dtype))(
                jp, jnp.asarray(toks[:, :prompt]))
            step = jax.jit(lambda p, t, c: jrwkv.decode_step(p, jcfg, t, c,
                                                             dtype))
            dec = []
            for i in range(toks.shape[1] - prompt):
                logits, c = step(jp, jnp.asarray(toks[:, prompt + i]), c)
                dec.append(np.asarray(logits))
            return fwd, np.stack(dec, 1)
        return run

    def port_run(dtype):
        @torch.no_grad()
        def run(toks, prompt):
            tt = torch.from_numpy(toks).long()
            x, _ = trwkv.forward(model, tcfg, tt, dtype)
            fwd = (x[:, prompt:].float() @ model.embed.float().t()).numpy()
            _, c = trwkv.prefill(model, tcfg, tt[:, :prompt], dtype)
            dec = []
            for i in range(tt.shape[1] - prompt):
                logits, c = trwkv.decode_step(model, tcfg, tt[:, prompt + i],
                                              c, dtype)
                dec.append(logits.numpy())
            return fwd, np.stack(dec, 1)
        return run

    jd, scale = _drift(jax_run(jnp.bfloat16), toks, prompt)
    td, _ = _drift(port_run(torch.bfloat16), toks, prompt)
    assert 1e-3 * scale < td <= 2 * jd, (td, jd, scale)
    drift, scale = _drift(port_run(torch.float32), toks, prompt)
    assert drift <= 1e-4 * scale, drift


@functools.lru_cache(maxsize=None)
def _jax_loss(name, dtype_name, grads):
    jcfg, _ = _cfgs(name)
    dtype = jnp.float32 if dtype_name == "f32" else jnp.bfloat16

    def loss(p):
        return jrwkv.loss_fn(p, jcfg, _batch(jcfg), dtype)

    fn = jax.value_and_grad(loss) if grads else lambda p: (loss(p), None)
    jl, jg = jax.jit(fn)(_jparams(_tree(name)))
    return float(jl), jax.tree_util.tree_map(np.asarray, jg)


def test_loss_and_grads_match_jax():
    """Every parameter's gradient, on "h4" (see the module docstring)."""
    jcfg, tcfg = _cfgs("h4")
    jl, jg = _jax_loss("h4", "f32", True)
    model = _model(tcfg, _tree("h4"))
    batch = {k: torch.from_numpy(v) for k, v in _batch(jcfg).items()}
    tl = trwkv.loss_fn(model, tcfg, batch, torch.float32)
    tl.backward()
    assert jl > 1.0
    _close(tl.detach().numpy(), jl, "loss")
    want = bridge.params_from_numpy(jg, device="cpu")
    assert sorted(want) == sorted(n for n, _ in model.named_parameters())
    for name, p in model.named_parameters():
        _close(p.grad.numpy(), want[name].numpy(), name)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_smoke_loss_matches_jax(dtype):
    """The reference's smoke config: the f32 loss within 5e-5, the bf16
    loss (on a bf16 copy of the weights, as the train step) within
    5e-2."""
    jcfg, tcfg = _cfgs()
    jl, _ = _jax_loss("smoke", dtype, False)
    model = _model(tcfg, _tree())
    batch = {k: torch.from_numpy(v) for k, v in _batch(jcfg).items()}
    with torch.no_grad():
        if dtype == "f32":
            tl = trwkv.loss_fn(model, tcfg, batch, torch.float32)
        else:
            tl = trwkv.loss_fn(steps.cast_params_bf16(model), tcfg, batch,
                               torch.bfloat16)
    tol = TOL if dtype == "f32" else BF16_TOL
    assert abs(float(tl) - jl) <= tol * max(1.0, abs(jl))


def test_bridge_round_trips_the_cache():
    jcfg, tcfg = _cfgs()
    empty = jax.tree_util.tree_map(np.asarray, jrwkv.make_cache(jcfg, 2, 40))
    tc = bridge.cache_from_numpy(empty, device="cpu")
    mine = trwkv.make_cache(tcfg, 2, 40, device="cpu")
    assert sorted(tc) == sorted(mine)
    assert tc["pos"] == mine["pos"] == 0
    for key in ("state", "x1", "x2"):
        assert tc[key].dtype == mine[key].dtype, key
        assert tuple(tc[key].shape) == tuple(mine[key].shape), key


def test_train_cli_matches_jax(monkeypatch):
    jcfg, tcfg = _cfgs()
    tree = _tree(seed=4)
    model = _model(tcfg, tree)
    monkeypatch.setattr(jrwkv, "init", lambda rng, cfg, dtype=None:
                        _jparams(tree))
    monkeypatch.setattr(trwkv, "init", lambda gen, cfg, dtype=None,
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


def test_serving_refuses_the_family_as_the_reference():
    """`tests/test_serving.py::test_scheduler_rejects_incapable_family`,
    `tests/test_decode_sla.py::test_engine_decode_sla_requires_capable_
    family`, and the static engine's name-keyed `_grow_cache` on the
    family's prefill cache: each refusal on both sides."""
    jcfg, tcfg = _cfgs()
    for sched, cfg in ((JScheduler, jcfg), (Scheduler, tcfg)):
        with pytest.raises(ValueError, match="continuous|slot"):
            sched(cfg, params=None)
    for engine, cfg in ((JServingEngine, jcfg), (ServingEngine, tcfg)):
        with pytest.raises(ValueError, match="decode_sla"):
            engine(cfg, params=None, decode_sla=True)
    prompt = np.arange(1, 9, dtype=np.int32)
    jeng = JServingEngine(jcfg, _jparams(_tree()), batch_size=1,
                          max_len=16)
    with pytest.raises(ValueError, match="unknown cache leaf 'state'"):
        jeng.run([JRequest(rid=0, prompt=prompt, max_new_tokens=2)])
    teng = ServingEngine(tcfg, _model(tcfg, _tree()), batch_size=1,
                         max_len=16)
    with pytest.raises(ValueError, match="unknown cache leaf 'state'"):
        teng.run([Request(rid=0, prompt=prompt, max_new_tokens=2)])
