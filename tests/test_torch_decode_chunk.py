"""Verify-style multi-token decode (`decode_chunk`), port against JAX.

`repro_torch.models.transformer.decode_chunk` against
`repro.models.transformer.decode_chunk` on the reference test's setup
(`tests/test_decode_sla.py::_chunk_setup`: smoke qwen3-1.7b, 2 layers,
kh 0.5, drift threshold 0.1, `sla_proj` drawn again, f32, a 32-token
prompt prefilled to a 128-token decode grid, then 0 or 5 decode steps),
the reference's cache carried across by `bridge.cache_from_numpy`:
decode-time SLA on the gather and kernel backends (the decode kernel's
plain twin on the CPU) and dense decode, 24 fed tokens that cross a block
boundary. Logits and float cache leaves within 5e-5 x max(1, max |ref|),
integer leaves equal (the count of differing entries reported), and the
port's chunk against its own 24 `decode_step`s within the same limit
with the cache state equal bitwise. Then `chunk=` splitting against the
whole call, the refusal of a vector `pos`, and
`backends.decode_execute_chunk` on every backend against the reference's
on one per-token state.
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
from repro.core import backends as jbackends
from repro.core.config import SLAConfig as JaxSLAConfig
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.core import backends as tbackends
from repro_torch.core import plan as tplan
from repro_torch.core.config import SLAConfig
from repro_torch.models import transformer as ttfm

TOL = 5e-5
MAX_LEN = 128


def _close(got, want, what, tol=TOL):
    got = np.asarray(torch.as_tensor(got).float().numpy(), np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    lim = tol * max(1.0, float(np.abs(want).max()))
    assert err <= lim, f"{what}: max abs error {err:g} > {lim:g}"


def _cfgs():
    out = []
    for get in (jax_get_arch, get_arch):
        cfg = get("qwen3-1.7b").smoke()
        out.append(dataclasses.replace(
            cfg, num_layers=2, sla=cfg.sla.replace(
                kh_frac=0.5, kl_frac=0.0, decode_mode="sla",
                decode_budget=None, plan_drift_threshold=0.1)))
    return out


@functools.lru_cache(maxsize=None)
def _weights():
    jcfg, tcfg = _cfgs()
    params = jtfm.init(jax.random.PRNGKey(0), jcfg)
    params["layers"]["sla_proj"] = jax.random.normal(
        jax.random.PRNGKey(7), params["layers"]["sla_proj"].shape) * 0.3
    model = ttfm.init(None, tcfg, device="cpu")
    model.load_state_dict(bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), device="cpu"))
    return params, model, ttfm.compute_params(model, torch.float32)


def _setup(sla, warm, backend, batch=2, seed=3):
    """The reference's `_chunk_setup`: prefill (+ `warm` greedy decode
    steps) in JAX; returns the JAX cache and its port copy."""
    params, _, _ = _weights()
    jcfg, _ = _cfgs()
    toks = jax.random.randint(jax.random.PRNGKey(seed), (batch, 32), 0,
                              jcfg.vocab_size)
    if sla:
        last, cache = jtfm.prefill(params, jcfg, toks,
                                   compute_dtype=jnp.float32,
                                   decode_max_len=MAX_LEN)
    else:
        last, cache = jtfm.prefill(params, jcfg, toks,
                                   compute_dtype=jnp.float32)
        pad = [(0, 0)] * 3 + [(0, MAX_LEN - 32), (0, 0)]
        cache = {"pos": cache["pos"], "k": jnp.pad(cache["k"], pad),
                 "v": jnp.pad(cache["v"], pad)}
    table = params.get("unembed", params["embed"])
    tok = jnp.argmax(jnp.einsum("bd,vd->bv", last.astype(jnp.float32),
                                table.astype(jnp.float32)), -1) \
        .astype(jnp.int32)
    for _ in range(warm):
        logits, cache = jtfm.decode_step(params, jcfg, tok, cache,
                                         compute_dtype=jnp.float32,
                                         backend=backend)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
    return cache, _port(cache)


def _port(jcache):
    return bridge.cache_from_numpy(
        jax.tree_util.tree_map(np.asarray, jcache), device="cpu")


def _compare_caches(t, j, what):
    """Port cache `t` against reference cache `j` (numpy leaves)."""
    assert int(t["pos"]) == int(j["pos"]), what
    for key in ("k", "v"):
        _close(t[key], j[key], f"{what} {key}")
    if "sla" not in j:
        return
    st, jst = t["sla"], j["sla"]
    assert int(st["rows"]) == int(jst["rows"]), what
    for key in ("hblk", "zblk", "htot", "ztot", "kpool", "qpool",
                "retention"):
        _close(st[key], jst[key], f"{what} {key}")
    for key in ("live_lut", "live_cnt", "live_marg", "extends", "replans",
                "reuses"):
        n = int((st[key].numpy() != jst[key]).sum())
        assert n == 0, f"{what} {key}: {n} entries differ"
    for name in tplan.PLAN_LEAVES:
        n = int((getattr(st["plan"], name).numpy()
                 != np.asarray(getattr(jst["plan"], name))).sum())
        assert n == 0, f"{what} plan {name}: {n} blocks differ"


CASES = [pytest.param(True, "gather", id="sla-gather"),
         pytest.param(True, "kernel", id="sla-kernel"),
         pytest.param(False, "gather", id="dense")]


@pytest.mark.parametrize("warm", [0, 5], ids=["fresh", "mid"])
@pytest.mark.parametrize("sla,backend", CASES)
def test_decode_chunk_matches_reference(sla, backend, warm):
    params, _, cparams = _weights()
    jcfg, tcfg = _cfgs()
    jcache, tcache = _setup(sla, warm, backend)
    fed = np.array(jax.random.randint(jax.random.PRNGKey(9), (2, 24), 0,
                                      jcfg.vocab_size), np.int32)
    # the reference runs the gather backend: its kernel path is Pallas in
    # interpret mode, held to gather by the reference's own suite
    jl, jc = jtfm.decode_chunk(params, jcfg, jnp.asarray(fed), jcache,
                               compute_dtype=jnp.float32,
                               backend="gather")
    steps = _port(jcache)
    tl, tc = ttfm.decode_chunk(cparams, tcfg, torch.from_numpy(fed).long(),
                               tcache, compute_dtype=torch.float32,
                               backend=backend)
    assert tl.shape == (2, 24, tcfg.vocab_size)
    _close(tl, np.asarray(jl), "logits")
    _compare_caches(tc, jax.tree_util.tree_map(np.asarray, jc), "chunk")
    if sla:
        assert int(tc["sla"]["extends"].sum()) == 2  # one row x 2 layers
    # against the port's own 24 steps
    sl = []
    with torch.no_grad():
        for c in range(24):
            logits, steps = ttfm.decode_step(
                cparams, tcfg, torch.from_numpy(fed[:, c]).long(), steps,
                compute_dtype=torch.float32, backend=backend)
            sl.append(logits)
    _close(tl, torch.stack(sl, dim=1).numpy(), "chunk vs steps logits")
    for key in ("k", "v"):
        assert torch.equal(tc[key], steps[key]), key
    if sla:
        for key, val in steps["sla"].items():
            got = tc["sla"][key]
            if key == "plan":
                for name in tplan.PLAN_LEAVES:
                    assert torch.equal(getattr(got, name),
                                       getattr(val, name)), name
            elif torch.is_tensor(val):
                assert torch.equal(got, val), key
            else:
                assert got == val, key


def test_decode_chunk_split_matches_whole():
    """`chunk=` sub-chunking changes launch shapes, not tokens: the greedy
    chain is identical and the logits agree within 5e-5, as in the
    reference."""
    _, _, cparams = _weights()
    _, tcfg = _cfgs()
    _, a = _setup(True, 0, "gather", batch=1, seed=4)
    _, b = _setup(True, 0, "gather", batch=1, seed=4)
    feed = torch.from_numpy(np.asarray(jax.random.randint(
        jax.random.PRNGKey(6), (1, 21), 0, tcfg.vocab_size))).long()
    lw, cw = ttfm.decode_chunk(cparams, tcfg, feed, a,
                               compute_dtype=torch.float32)
    ls, cs = ttfm.decode_chunk(cparams, tcfg, feed, b,
                               compute_dtype=torch.float32, chunk=7)
    assert torch.equal(lw.argmax(-1), ls.argmax(-1))
    _close(ls, lw.numpy(), "split vs whole")
    assert cw["pos"] == cs["pos"] == 53
    assert torch.equal(cw["k"], cs["k"])


def test_decode_chunk_rejects_vector_pos():
    _, _, cparams = _weights()
    _, tcfg = _cfgs()
    _, cache = _setup(True, 0, "gather")
    cache = dict(cache, pos=torch.full((2,), cache["pos"],
                                       dtype=torch.int32))
    with pytest.raises(ValueError, match="scalar"):
        ttfm.decode_chunk(cparams, tcfg, torch.zeros((2, 4), dtype=torch.long),
                          cache)
    _, cache = _setup(True, 0, "gather")
    with pytest.raises(ValueError, match="overrun"):
        ttfm.decode_chunk(cparams, tcfg,
                          torch.zeros((2, MAX_LEN), dtype=torch.long), cache)


def _chunk_state(seed, b=2, hkv=2, g=2, c=5, d=32, bkv=16, tn=8, k_sel=4,
                 pos=70):
    """A per-token decode state (numpy): each token its own LUT row (the
    diagonal block listed), totals and diagonal partials."""
    rs = np.random.default_rng(seed)
    h = hkv * g
    f = lambda *s: rs.standard_normal(s).astype(np.float32)  # noqa: E731
    st = dict(k=f(b, hkv, tn * bkv, d), v=f(b, hkv, tn * bkv, d),
              hblk=0.1 * f(b, hkv, tn, d, d),
              zblk=np.abs(f(b, hkv, tn, d)), hdiag=0.1 * f(b, hkv, c, d, d),
              zdiag=np.abs(f(b, hkv, c, d)), htot=f(b, hkv, c, d, d),
              ztot=np.abs(f(b, hkv, c, d)) + 5.0)
    lut = np.zeros((b, h, c, k_sel), np.int32)
    for idx in np.ndindex(b, h, c):
        row = (pos + idx[2]) // bkv
        lut[idx] = np.sort(np.concatenate([rs.choice(row, k_sel - 1,
                                                     replace=False), [row]]))
    st.update(lut=lut, cnt=rs.integers(1, k_sel + 1, (b, h, c))
              .astype(np.int32), marg=rs.integers(0, 3, (b, h, c))
              .astype(np.int32))
    q = f(b, h, c, d)
    proj = 0.3 * f(h, d, d)
    return st, q, proj


@pytest.mark.parametrize("backend", ["gather", "kernel", "reference"])
def test_decode_execute_chunk_matches_reference(backend):
    st, q, proj = _chunk_state(5)
    kw = dict(block_q=16, block_kv=16, kh_frac=0.5, kl_frac=0.0,
              causal=True)
    want = jbackends.decode_execute_chunk(
        {key: jnp.asarray(v) for key, v in st.items()},
        {"proj": jnp.asarray(proj)}, jnp.asarray(q), 70,
        JaxSLAConfig(**kw), backend=backend)
    got = tbackends.decode_execute_chunk(
        {key: torch.from_numpy(v) for key, v in st.items()},
        {"proj": torch.from_numpy(proj)}, torch.from_numpy(q), 70,
        SLAConfig(**kw), backend=backend)
    assert got.shape == q.shape and got.dtype == torch.float32
    _close(got, np.asarray(want), f"decode_execute_chunk[{backend}]")
    one = tbackends.decode_execute_chunk(
        {key: torch.from_numpy(v) for key, v in st.items()},
        {"proj": torch.from_numpy(proj)}, torch.from_numpy(q),
        torch.tensor(70), SLAConfig(**kw), backend=backend)
    assert torch.equal(one, got)  # a tensor position is the same call
