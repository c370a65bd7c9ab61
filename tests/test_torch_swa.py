"""Sliding-window attention and the configs that use it, port against JAX.

`repro_torch.models.common._swa_attention` (the banded, block-granular
window of gemma3's local layers) is held to `repro.models.common` on the
same numpy inputs: causal and not, windows that are and are not whole
blocks, and lengths at which the block halves. Then the smoke gemma3-1b
(4 layers: sliding-window layers 0 and 2 with a 32-token window, SLA
layers 1 and 3) and the smoke h2o-danube-3-4b (SLA layers with a 64-token
window inside the SLA mask), JAX-initialized weights carried over by
`bridge.params_from_numpy` (`sla_proj` drawn again), at f32:

  * the forward and the loss, within 5e-5 x max(1, max |ref|);
  * greedy decode on the static cache (dense, and decode-time SLA on the
    mixed stack with its state leaves), on the per-slot and paged caches
    and through `decode_chunk`: the sliding-window layers' token-level
    window mask, the SLA layers of danube without one (the reference's
    behaviour); logits within 1e-4 x max(1, max |logits|), tokens equal;
  * the static `ServingEngine` in bf16 with decode-time SLA: greedy tokens
    equal to the reference engine's;
  * the refusals (chunked prefill of a mixed stack or a window, decode-
    time SLA with a window) with the reference's messages.
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
from repro.core.config import SLAConfig as JSLAConfig
from repro.models import common as jcommon
from repro.models import transformer as jtfm
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.core import plan as tplan
from repro_torch.core.config import SLAConfig
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as ttfm
from repro_torch.serving.engine import Request, ServingEngine

F32_TOL, BF16_TOL, LOGIT_TOL = 5e-5, 5e-2, 1e-4
PLEN, MAX_LEN, STEPS = 48, 96, 20
GEMMA, DANUBE = "gemma3-1b", "h2o-danube-3-4b"


def _close(got, want, tol, what=""):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    limit = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= limit, (what, err, limit)


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


# (N, window, causal): the 128-token block halves to 64 at N 320, where
# 64 is a whole block and 100 is not
SWA_CASES = [(320, 64, True), (320, 100, True), (320, 64, False),
             (320, 100, False)]


@pytest.mark.parametrize("n,window,causal", SWA_CASES)
def test_swa_attention_matches_reference(n, window, causal):
    rs = np.random.default_rng(n + window)
    q, k, v = (rs.standard_normal((2, 3, n, 16)).astype(np.float32)
               for _ in range(3))
    want = jcommon._swa_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), window, causal)
    got = tcommon._swa_attention(*_t(q, k, v), window, causal)
    assert got.dtype == torch.float32
    _close(got, want, F32_TOL)


def test_swa_through_attention_repeats_kv_heads():
    """`attention(kind="swa")` repeats a GQA group's kv heads first."""
    rs = np.random.default_rng(5)
    q = rs.standard_normal((2, 4, 192, 16)).astype(np.float32)
    k, v = (rs.standard_normal((2, 1, 192, 16)).astype(np.float32)
            for _ in range(2))
    want = jcommon.attention(None, *map(jnp.asarray, (q, k, v)), "swa",
                             JSLAConfig(), window=70, causal=True)
    got = tcommon.attention(None, *_t(q, k, v), "swa", SLAConfig(),
                            window=70, causal=True)
    _close(got, want, F32_TOL)


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg, tcfg = jax_get_arch(arch).smoke(), get_arch(arch).smoke()
    params = jtfm.init(jax.random.PRNGKey(0), jcfg)
    rs = np.random.default_rng(7)
    params["layers"]["sla_proj"] = jnp.asarray(0.1 * rs.standard_normal(
        params["layers"]["sla_proj"].shape, dtype=np.float32))
    model = ttfm.init(None, tcfg, device="cpu")
    model.load_state_dict(bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), device="cpu"))
    return jcfg, tcfg, params, model


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_smoke_configs_keep_their_windows():
    gemma = get_arch(GEMMA).smoke()
    assert ttfm.layer_kinds_list(gemma) == [ttfm.KIND_SWA, ttfm.KIND_SLA] * 2
    assert (gemma.local_window, gemma.head_dim) == (32, 32)
    danube = get_arch(DANUBE).smoke()
    assert set(ttfm.layer_kinds_list(danube)) == {ttfm.KIND_SLA}
    assert danube.sliding_window == 64


# gemma3's band takes 128-token blocks: at 384 tokens it spans 2 of 3
@pytest.mark.parametrize("arch,seq", [(GEMMA, 384), (DANUBE, 128)])
def test_smoke_forward_and_loss_match_reference(arch, seq):
    jcfg, tcfg, params, model = _setup(arch)
    rs = np.random.default_rng(11)
    toks = rs.integers(0, 512, size=(2, seq + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    jx, _ = jax.jit(functools.partial(
        jtfm.forward, cfg=jcfg, compute_dtype=jnp.float32))(
            params, tokens=jnp.asarray(batch["tokens"]))
    # the reference's loss_fn on this forward: its cross-entropy (the aux
    # loss is 0 without experts)
    jloss = jcommon.chunked_softmax_xent(jx, params["embed"],
                                         jnp.asarray(batch["targets"]))
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    with torch.no_grad():
        tx, _ = ttfm.forward(model, tcfg, tb["tokens"],
                             compute_dtype=torch.float32)
        tloss = ttfm.loss_fn(model, tcfg, tb, compute_dtype=torch.float32)
    _close(tx, jx, F32_TOL, "hidden")
    _close(tloss, jloss, F32_TOL, "loss")


def _prompts(b=2, seed=3):
    return np.random.default_rng(seed).integers(
        0, 512, size=(b, PLEN)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_prefill(arch, sla, n=PLEN, seed=3, b=2):
    """The reference's jitted prefill of b seeded prompts of n tokens (its
    arrays are immutable, so tests share them)."""
    jcfg, _, params, _ = _setup(arch)
    toks = np.random.default_rng(seed).integers(
        0, 512, size=(b, n)).astype(np.int32)
    kw = {"decode_max_len": MAX_LEN} if sla else {}
    fn = jax.jit(functools.partial(jtfm.prefill, cfg=jcfg,
                                   compute_dtype=jnp.float32, **kw))
    return toks, fn(params, tokens=jnp.asarray(toks))


def _static_greedy_jax(arch, sla):
    jcfg, _, params, _ = _setup(arch)
    last, cache = _jax_prefill(arch, sla)[1]
    if not sla:
        pad = [(0, 0)] * 3 + [(0, MAX_LEN - PLEN), (0, 0)]
        cache = dict(cache, k=jnp.pad(cache["k"], pad),
                     v=jnp.pad(cache["v"], pad))
    step = jax.jit(functools.partial(
        jtfm.decode_step, cfg=jcfg, compute_dtype=jnp.float32,
        backend="gather"))
    tok = jnp.argmax(jnp.einsum("bd,vd->bv", last, params["embed"]), -1) \
        .astype(jnp.int32)
    toks_out, logits_out = [], []
    for _ in range(STEPS):
        toks_out.append(np.asarray(tok))
        logits, cache = step(params, token=tok, cache=cache)
        logits_out.append(np.asarray(logits))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
    return np.stack(toks_out), np.stack(logits_out), cache


def _static_greedy_torch(arch, sla, backend):
    _, tcfg, _, model = _setup(arch)
    toks = torch.from_numpy(_prompts()).long()
    with torch.no_grad():
        kw = {"decode_max_len": MAX_LEN} if sla else {}
        last, cache = ttfm.prefill(model, tcfg, toks,
                                   compute_dtype=torch.float32, **kw)
        if not sla:
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
            logits_out.append(logits.numpy())
            tok = logits.argmax(-1)
    return np.stack(toks_out), np.stack(logits_out), cache


STATIC = [(GEMMA, "dense", "gather"), (GEMMA, "sla", "kernel"),
          (DANUBE, "dense", "gather")]


@pytest.mark.parametrize("arch,mode,backend", STATIC,
                         ids=[f"{a}-{m}" for a, m, _ in STATIC])
def test_static_decode_matches_reference(arch, mode, backend):
    """20 greedy steps from a 48-token prompt: the window (32 tokens in
    gemma3's local layers) masks the prompt's head from step 1 on; the
    SLA layers decode dense (danube: without a window, as the reference)
    or with decode-time SLA (gemma3's, through the kernel's plain twin)
    while the local layers decode dense in the same step."""
    sla = mode == "sla"
    jt, jl, jcache = _static_greedy_jax(arch, sla)
    tt, tl, tcache = _static_greedy_torch(arch, sla, backend)
    for i in range(STEPS):
        _close(tl[i], jl[i], LOGIT_TOL, f"logits of step {i}")
    assert np.array_equal(tt, jt)
    assert tcache["pos"] == int(jcache["pos"]) == PLEN + STEPS
    for name in ("k", "v"):
        _close(tcache[name], jcache[name], F32_TOL, name)
    if not sla:
        return
    js, ts = jcache["sla"], tcache["sla"]
    for name in ("live_lut", "live_cnt", "live_marg", "extends", "replans",
                 "reuses"):
        assert np.array_equal(ts[name].numpy(), np.asarray(js[name])), name
    assert ts["rows"] == int(js["rows"])
    for name in tplan.PLAN_LEAVES:
        assert np.array_equal(getattr(ts["plan"], name).numpy(),
                              np.asarray(getattr(js["plan"], name))), name
    for name in ("hblk", "zblk", "htot", "ztot", "kpool", "qpool",
                 "retention"):
        _close(ts[name], js[name], F32_TOL, name)


# continuous batching: slot 0 holds a 48-token prompt, slot 1 a 32-token
# one, so their windows and block boundaries differ step by step
SLOT_PROMPTS = (48, 32)
PAGES = ([1, 2, 3], [6, 7])               # their prompt pages
DECODE_PAGES = ([4, 5], [8, 9])          # the pages their decode writes
POOL = 12


def _singles():
    return [_jax_prefill(GEMMA, True, n=n, seed=13 + n, b=1)[1][1]
            for n in SLOT_PROMPTS]


def _grow(single):
    pad = MAX_LEN - single["k"].shape[-2]
    if pad <= 0:
        return single
    w = [(0, 0)] * 3 + [(0, pad), (0, 0)]
    return dict(single, k=jnp.pad(single["k"], w), v=jnp.pad(single["v"], w))


def test_per_slot_and_paged_decode_match_reference():
    """20 decode-time SLA steps of two slots at their own positions, on
    the reference's per-slot cache and on the port's per-slot and paged
    caches: the local layers decode dense, the paged ones through the
    page-gathered view, with each slot's own window; logits within 1e-4 x
    max(1, max |logits|), the port's paged logits bitwise its per-slot
    ones, the live rows and counters bitwise."""
    jcfg, tcfg, params, model = _setup(GEMMA)
    singles = _singles()
    jc = jax.jit(functools.partial(
        jtfm.make_cache, jcfg, 2, MAX_LEN, dtype=jnp.float32,
        decode_sla=True, per_slot=True))()
    tm = ttfm.make_cache(tcfg, 2, MAX_LEN, dtype=torch.float32,
                         decode_sla=True, per_slot=True, device="cpu")
    tp = ttfm.make_paged_cache(tcfg, 2, MAX_LEN, POOL, dtype=torch.float32,
                               decode_sla=True, device="cpu")
    pt = np.zeros((2, MAX_LEN // tcfg.sla.block_kv), np.int32)
    for slot, single in enumerate(singles):
        jc = jtfm.insert_slot(jc, _grow(single), slot)
        ttfm.insert_slot(tm, bridge.cache_from_numpy(
            _np(_grow(single)), device="cpu"), slot, tcfg)
        ttfm.insert_slot_paged(tp, bridge.cache_from_numpy(
            _np(single), device="cpu"), slot, PAGES[slot], tcfg)
        row = PAGES[slot] + DECODE_PAGES[slot]
        pt[slot, :len(row)] = row
    tp["pt"] = torch.from_numpy(pt)
    kw = {"backend": "gather"}
    step = jax.jit(functools.partial(jtfm.decode_step, cfg=jcfg,
                                     compute_dtype=jnp.float32, **kw))
    tokens = np.random.default_rng(17).integers(
        0, 512, size=(STEPS, 2)).astype(np.int32)
    for i in range(STEPS):
        jl, jc = step(params, token=jnp.asarray(tokens[i]), cache=jc)
        tok = torch.from_numpy(tokens[i]).long()
        with torch.no_grad():
            lm, _ = ttfm.decode_step(model, tcfg, tok, tm,
                                     compute_dtype=torch.float32, **kw)
            lp, _ = ttfm.decode_step(model, tcfg, tok, tp,
                                     compute_dtype=torch.float32, **kw)
        _close(lm, jl, LOGIT_TOL, f"per-slot step {i}")
        assert torch.equal(lp, lm), i
    want = [n + STEPS for n in SLOT_PROMPTS]
    assert tm["pos"].tolist() == tp["pos"].tolist() == want
    js, ts = jc["sla"], tm["sla"]
    for name in ("live_lut", "live_cnt", "live_marg", "extends", "replans",
                 "reuses", "rows"):
        assert np.array_equal(ts[name].numpy(), np.asarray(js[name])), name


def test_decode_chunk_matches_reference():
    """Two `decode_chunk`s of 4 given tokens from the static 48-token
    decode-time SLA state: the local layers' chunk attends its window
    (`_dense_decode_chunk_attn`), the SLA layers' through the decode
    twin; logits and K/V within the f32 limits."""
    jcfg, tcfg, params, model = _setup(GEMMA)
    toks, (_, jcache) = _jax_prefill(GEMMA, True)
    with torch.no_grad():
        _, tcache = ttfm.prefill(model, tcfg, torch.from_numpy(toks).long(),
                                 compute_dtype=torch.float32,
                                 decode_max_len=MAX_LEN)
    chunk = jax.jit(functools.partial(jtfm.decode_chunk, cfg=jcfg,
                                      compute_dtype=jnp.float32,
                                      backend="gather"))
    draft = np.random.default_rng(19).integers(0, 512, size=(2, 8)) \
        .astype(np.int32)
    for lo in (0, 4):
        jl, jcache = chunk(params, tokens=jnp.asarray(draft[:, lo:lo + 4]),
                           cache=jcache)
        with torch.no_grad():
            tl, tcache = ttfm.decode_chunk(
                model, tcfg, torch.from_numpy(draft[:, lo:lo + 4]).long(),
                tcache, compute_dtype=torch.float32, backend="gather")
        _close(tl, jl, LOGIT_TOL, f"chunk at {lo}")
    assert tcache["pos"] == int(jcache["pos"]) == PLEN + 8
    for name in ("k", "v"):
        _close(tcache[name], jcache[name], F32_TOL, name)
    for name in ("live_lut", "live_cnt", "extends"):
        assert np.array_equal(tcache["sla"][name].numpy(),
                              np.asarray(jcache["sla"][name])), name


def test_static_engine_greedy_tokens_match_reference():
    """The static engines on gemma3 in bf16 with decode-time SLA: the
    counters equal and every request's greedy tokens equal (the prompts'
    first-token top-2 margins exceed twice the packages' bf16 logit
    difference)."""
    jcfg, tcfg, params, model = _setup(GEMMA)
    prompts = [np.random.default_rng(30 + i).integers(
        0, 512, size=PLEN).astype(np.int32) for i in range(2)]
    kw = dict(batch_size=2, max_len=MAX_LEN, backend="gather",
              decode_sla=True)
    jeng, teng = JEngine(jcfg, params, **kw), ServingEngine(tcfg, model, **kw)
    jdone = jeng.run([JRequest(rid=i, prompt=p, max_new_tokens=12)
                      for i, p in enumerate(prompts)])
    tdone = teng.run([Request(rid=i, prompt=p, max_new_tokens=12)
                      for i, p in enumerate(prompts)])
    for name in ("prefill_tokens", "decode_tokens", "decode_plan_builds",
                 "decode_plan_extends", "decode_plan_replans",
                 "decode_plan_reuses"):
        assert getattr(teng.stats, name) == getattr(jeng.stats, name), name
    for t, j in zip(tdone, jdone):
        assert t.tokens_out == j.tokens_out, t.rid
        assert len(t.tokens_out) == 12


def _same_error(jfn, tfn, exc=ValueError):
    with pytest.raises(exc) as want:
        jfn()
    with pytest.raises(exc) as got:
        tfn()
    assert str(got.value) == str(want.value)
    return str(got.value)


def test_refusals_match_reference():
    """Chunked prefill refuses gemma3's mixed stack and danube's window
    (with the column capacity lifted); decode-time SLA refuses the
    window, so danube decodes dense; gemma3's local window lives outside
    the SLA config and its decode grid is accepted."""
    jg, tg = _setup(GEMMA)[:2]
    msg = _same_error(lambda: jtfm.check_chunked_prefill(jg),
                      lambda: ttfm.check_chunked_prefill(tg))
    assert "all-SLA" in msg
    jd, td = (dataclasses.replace(c, sla=c.sla.replace(
        col_capacity_factor=None)) for c in _setup(DANUBE)[:2])
    msg = _same_error(lambda: jtfm.check_chunked_prefill(jd),
                      lambda: ttfm.check_chunked_prefill(td))
    assert "window" in msg
    msg = _same_error(lambda: jtfm._check_decode_grid(jd, PLEN, MAX_LEN),
                      lambda: ttfm._check_decode_grid(td, PLEN, MAX_LEN))
    assert "dense decode" in msg
    _, _, _, model = _setup(DANUBE)
    with pytest.raises(ValueError, match="window"):
        ttfm.prefill(model, td, torch.zeros((1, PLEN), dtype=torch.long),
                     compute_dtype=torch.float32, decode_max_len=MAX_LEN)
    jtfm._check_decode_grid(jg, PLEN, MAX_LEN)
    ttfm._check_decode_grid(tg, PLEN, MAX_LEN)
