"""The LM transformer's serving path, port against JAX.

`repro_torch.models.transformer` is held to `repro.models.transformer` on
the smoke qwen3-1.7b (2 layers, d 128, 4 query / 2 KV heads of 32, 16 x 16
blocks) with JAX-initialized weights carried over by
`bridge.params_from_numpy` (`sla_proj` drawn again, so the linear branch
reaches the logits), at f32:

  * `prefill`: last hidden state, the KV caches and the seeded decode
    state (h/z partials and totals, pooled k, the decode plan);
  * 24 greedy `decode_step`s — dense, and decode-time SLA on the gather,
    kernel (the CUDA kernel's plain twin) and reference backends —
    crossing two block boundaries (one drift decision without and one
    with a `plan_extend`): logits within 1e-4 x max(1, max |logits|),
    greedy tokens equal, the live LUT / counts / marginal counts, the
    plan rows and the extends / replans / reuses counters bitwise equal;
  * prefill plan reuse with drift refresh.

The decode kernel itself runs only on a GPU: tests/test_torch_gpu.py.
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
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.core import plan as tplan
from repro_torch.models import transformer as ttfm

PLEN, MAX_LEN, STEPS = 48, 96, 24
LOGIT_TOL = 1e-4


def _cfgs(**sla):
    j, t = jax_get_arch("qwen3-1.7b").smoke(), get_arch("qwen3-1.7b").smoke()
    return (dataclasses.replace(j, sla=j.sla.replace(**sla)),
            dataclasses.replace(t, sla=t.sla.replace(**sla)))


@functools.lru_cache(maxsize=None)
def _params(routing_mode="threshold"):
    jcfg, tcfg = _cfgs(routing_mode=routing_mode)
    params = jtfm.init(jax.random.PRNGKey(0), jcfg)
    rs = np.random.default_rng(7)
    params["layers"]["sla_proj"] = jnp.asarray(0.1 * rs.standard_normal(
        params["layers"]["sla_proj"].shape, dtype=np.float32))
    model = ttfm.init(None, tcfg, device="cpu")
    model.load_state_dict(bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), device="cpu"))
    return params, model


def _tokens(seed=3, b=2):
    return np.random.default_rng(seed).integers(
        0, 512, size=(b, PLEN)).astype(np.int32)


def _close(got, want, tol, what):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    limit = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= limit, (what, err, limit)


def test_bridge_carries_every_lm_leaf():
    params, model = _params("learned")
    state = model.state_dict()
    for name, leaf in params["layers"].items():
        sub = leaf.items() if isinstance(leaf, dict) else [(None, leaf)]
        for key, arr in sub:
            for li in range(arr.shape[0]):
                full = f"layers.{li}.{name}" + ("" if key is None
                                                else f".{key}")
                assert np.array_equal(state[full].numpy(),
                                      np.asarray(arr[li])), full
    assert {f"layers.0.{n}" for n in ("qnorm", "knorm", "sla_proj",
                                      "routing.wq")} <= set(state)


def test_prefill_and_seeded_decode_state_match_jax():
    jcfg, tcfg = _cfgs()
    params, model = _params()
    toks = _tokens()
    jlast, jcache = jtfm.prefill(params, jcfg, jnp.asarray(toks),
                                 compute_dtype=jnp.float32,
                                 decode_max_len=MAX_LEN)
    with torch.no_grad():
        tlast, tcache = ttfm.prefill(model, tcfg, torch.from_numpy(toks),
                                     compute_dtype=torch.float32,
                                     decode_max_len=MAX_LEN)
    _close(tlast, jlast, 5e-5, "last hidden")
    for name in ("k", "v"):
        assert tcache[name].shape == jcache[name].shape
        _close(tcache[name], jcache[name], 5e-5, name)
    assert tcache["pos"] == int(jcache["pos"]) == PLEN
    js, ts = jcache["sla"], tcache["sla"]
    for name in ("hblk", "zblk", "htot", "ztot", "kpool", "qpool",
                 "retention"):
        _close(ts[name], js[name], 5e-5, name)
    for name in tplan.PLAN_LEAVES:
        assert np.array_equal(getattr(ts["plan"], name).numpy(),
                              np.asarray(getattr(js["plan"], name))), name
    assert ts["rows"] == int(js["rows"])
    for name in ("live_lut", "live_cnt", "live_marg", "extends", "replans",
                 "reuses"):
        assert np.array_equal(ts[name].numpy(), np.asarray(js[name])), name


def _jax_greedy(jcfg, params, toks, sla, backend):
    if sla:
        last, cache = jtfm.prefill(params, jcfg, jnp.asarray(toks),
                                   compute_dtype=jnp.float32,
                                   decode_max_len=MAX_LEN)
    else:
        last, cache = jtfm.prefill(params, jcfg, jnp.asarray(toks),
                                   compute_dtype=jnp.float32)
        pad = [(0, 0)] * 3 + [(0, MAX_LEN - PLEN), (0, 0)]
        cache = {"pos": cache["pos"], "k": jnp.pad(cache["k"], pad),
                 "v": jnp.pad(cache["v"], pad)}
    step = jax.jit(functools.partial(jtfm.decode_step,
                                     compute_dtype=jnp.float32,
                                     backend=backend), static_argnums=(1,))
    tok = jnp.argmax(jnp.einsum("bd,vd->bv", last, params["embed"]), -1) \
        .astype(jnp.int32)
    toks_out, logits_out = [], []
    for _ in range(STEPS):
        toks_out.append(np.asarray(tok))
        logits, cache = step(params, jcfg, tok, cache)
        logits_out.append(np.asarray(logits))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
    return np.stack(toks_out), np.stack(logits_out), cache


def _torch_greedy(tcfg, model, toks, sla, backend):
    with torch.no_grad():
        if sla:
            last, cache = ttfm.prefill(model, tcfg, torch.from_numpy(toks),
                                       compute_dtype=torch.float32,
                                       decode_max_len=MAX_LEN)
        else:
            last, cache = ttfm.prefill(model, tcfg, torch.from_numpy(toks),
                                       compute_dtype=torch.float32)
            pad = (0, 0, 0, MAX_LEN - PLEN)
            cache["k"] = torch.nn.functional.pad(cache["k"], pad)
            cache["v"] = torch.nn.functional.pad(cache["v"], pad)
        tok = (last @ model.embed.t()).argmax(-1)
        toks_out, logits_out = [], []
        for _ in range(STEPS):
            toks_out.append(tok.numpy())
            logits, cache = ttfm.decode_step(
                model, tcfg, tok, cache, compute_dtype=torch.float32,
                backend=backend)
            logits_out.append(logits)
            tok = logits.argmax(-1)
    return np.stack(toks_out), torch.stack(logits_out), cache


DECODE = [("dense", "gather"), ("sla", "gather"), ("sla", "kernel"),
          ("sla", "reference")]


@pytest.mark.parametrize("mode,backend", DECODE,
                         ids=[f"{m}-{b}" for m, b in DECODE])
def test_decode_steps_match_jax(mode, backend):
    jcfg, tcfg = _cfgs()
    params, model = _params()
    toks = _tokens()
    sla = mode == "sla"
    jt, jl, jcache = _jax_greedy(jcfg, params, toks, sla, backend)
    tt, tl, tcache = _torch_greedy(tcfg, model, toks, sla, backend)
    for i in range(STEPS):
        _close(tl[i], jl[i], LOGIT_TOL, f"logits of step {i}")
    assert np.array_equal(tt, jt)
    assert tcache["pos"] == int(jcache["pos"]) == PLEN + STEPS
    if not sla:
        return
    js, ts = jcache["sla"], tcache["sla"]
    for name in ("live_lut", "live_cnt", "live_marg", "extends", "replans",
                 "reuses"):
        assert np.array_equal(ts[name].numpy(), np.asarray(js[name])), name
    assert ts["rows"] == int(js["rows"]) == PLEN // 16 + 1
    assert int(ts["extends"].sum()) == tcfg.num_layers
    assert int((ts["replans"] + ts["reuses"]).sum()) == 2 * tcfg.num_layers
    for name in ("mc", "lut", "counts", "col_counts", "marginal"):
        assert np.array_equal(getattr(ts["plan"], name).numpy(),
                              np.asarray(getattr(js["plan"], name))), name
    for name in ("hblk", "htot", "ztot", "kpool", "qpool"):
        _close(ts[name], js[name], 5e-5, name)


def test_prefill_plan_reuse_with_drift_matches_jax():
    jcfg, tcfg = _cfgs()
    params, model = _params()
    a, b = _tokens(3), _tokens(4)
    _, _, jplans = jtfm.prefill(params, jcfg, jnp.asarray(a),
                                compute_dtype=jnp.float32,
                                return_plans=True)
    jlast, _, jplans2, jinfo = jtfm.prefill(
        params, jcfg, jnp.asarray(b), compute_dtype=jnp.float32,
        plans=jplans, drift_threshold=(0.0, 1.0), return_plans=True)
    with torch.no_grad():
        _, _, tplans = ttfm.prefill(model, tcfg, torch.from_numpy(a),
                                    compute_dtype=torch.float32,
                                    return_plans=True)
        tlast, _, tplans2, tinfo = ttfm.prefill(
            model, tcfg, torch.from_numpy(b), compute_dtype=torch.float32,
            plans=tplans, drift_threshold=(0.0, 1.0), return_plans=True)
    _close(tlast, jlast, 5e-5, "last hidden")
    assert tinfo["replanned"].tolist() == np.asarray(
        jinfo["replanned"]).tolist() == [True, False]
    _close(tinfo["retention"], jinfo["retention"], 5e-5, "retention")
    for name in tplan.PLAN_LEAVES:
        assert np.array_equal(getattr(tplans2, name).numpy(),
                              np.asarray(getattr(jplans2, name))), name


def test_unported_lm_paths_name_their_item():
    """The MoE FFN and the VLM prefix are ported
    (tests/test_torch_moe.py, tests/test_torch_vlm.py). Chunked decode and
    chunked prefill are ported (tests/test_torch_decode_chunk.py,
    tests/test_torch_chunked_prefill.py) and refuse what the reference
    refuses: `decode_chunk` a per-slot (B,) position, `prefill_chunk` a
    config with a column capacity (its rows could not be sliced from the
    full classification). The per-slot caches are ported too
    (tests/test_torch_paged.py): an empty per-slot cache decodes with
    (B,) positions, and a paged cache with a scalar position is refused
    as in the reference."""
    _, tcfg = _cfgs()
    _, model = _params()
    cache = ttfm.make_cache(tcfg, 2, 96, dtype=torch.float32,
                            per_slot=True, device="cpu")
    with pytest.raises(ValueError, match="scalar"):
        ttfm.decode_chunk(model, tcfg, torch.zeros((2, 3), dtype=torch.long),
                          cache)
    carry = ttfm.make_prefill_carry(tcfg, 32, device="cpu")
    assert tcfg.sla.col_capacity_factor is not None
    with pytest.raises(ValueError, match="col_capacity_factor"):
        ttfm.prefill_chunk(model, tcfg, torch.zeros((1, 16),
                                                    dtype=torch.long),
                           carry, 0)
    with torch.no_grad():
        logits, cache = ttfm.decode_step(
            model, tcfg, torch.zeros(2, dtype=torch.long), cache,
            compute_dtype=torch.float32)
    assert logits.shape == (2, tcfg.vocab_size)
    assert cache["pos"].tolist() == cache["pos_host"].tolist() == [1, 1]
    paged = ttfm.make_paged_cache(tcfg, 2, 96, 8, dtype=torch.float32,
                                  decode_sla=True, device="cpu")
    paged["pos"] = 3
    with pytest.raises(ValueError, match="per-slot"):
        ttfm.decode_step(model, tcfg, torch.zeros(2, dtype=torch.long),
                         paged)
