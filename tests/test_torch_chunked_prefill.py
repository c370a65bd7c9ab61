"""Chunked admission prefill, port against JAX.

`repro_torch` against `repro` on the same numpy inputs, the JAX weights
carried across by `bridge.py`, kernels as their plain twins (the Pallas
kernels in interpret mode on the JAX side):

  * `masks.score_map_pooled` (threshold and learned routing) and
    `ops.sla_attention_rows` on a span of query rows at base > 0, f32
    within 5e-5 and bf16 within 5e-2 of max(1, max |ref|);
  * the sequence `make_prefill_carry` -> `prefill_chunk` x 4 ->
    `finalize_chunked_prefill` over backends gather / kernel and
    decode-time SLA off / on, on the reference's chunk-eligible smoke
    config (`tests/test_serving.py::_chunk_arch`, col_capacity_factor
    None), in f32: every chunk's last hidden and every float leaf within
    5e-5, integer leaves (decode rows, plan) compared block by block with
    the count of differing blocks reported;
  * the chunked `Scheduler` against the reference's chunked `Scheduler`
    on the traces of `tests/test_serving.py`'s chunked suite (mixed
    lengths with slot turnover, the interleave trace, the prefix resume)
    in f32: greedy tokens, the stream events and every `ServeStats`
    counter equal, the mid-decode cache leaves of a slot within 5e-5;
  * the interleave count, the prefix-resume counts (5 chunks, 80 tokens)
    and the refusals, and the serve CLI's `--prefill-chunk`.

The reference's own chunked-vs-blocking bitwise test fails on this CPU
(one bf16 ulp in one `k` element, from XLA's shape-dependent GEMMs;
ROADMAP.md queue 3), so the port is held to the reference's chunked
results, and to its own blocking ones only on tokens.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.configs import get_arch as jax_get_arch
from repro.core import masks as jmasks
from repro.core import plan as jplan
from repro.core.config import SLAConfig as JaxSLAConfig
from repro.core.phi import phi as jphi
from repro.kernels import ops as jops
from repro.models import transformer as jtfm
from repro.serving import api as japi
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.core import masks as tmasks
from repro_torch.core import plan as tplan
from repro_torch.core.config import SLAConfig
from repro_torch.core.phi import phi as tphi
from repro_torch.kernels import ops as tops
from repro_torch.models import transformer as ttfm
from repro_torch.serving import api as tapi
from repro_torch.serving.engine import Request, ServingEngine

TOL = {"f32": 5e-5, "bf16": 5e-2}
TIMES = ("prefill_s", "decode_s", "max_decode_gap_s")


def _close(got, want, tol, what):
    got = np.asarray(torch.as_tensor(got).float().numpy(), np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    lim = tol * max(1.0, float(np.abs(want).max()) if want.size else 0.0)
    assert err <= lim, f"{what}: max abs error {err:g} > {lim:g}"


def _blocks_differ(got, want) -> int:
    return int((np.asarray(torch.as_tensor(got).numpy())
                != np.asarray(want)).sum())


def _cfgs(decode=False):
    """The reference's chunk-eligible smoke config (`_chunk_arch`), in
    both packages: per-row critical sets only."""
    out = []
    for get in (jax_get_arch, get_arch):
        cfg = get("qwen3-1.7b").smoke()
        sla = cfg.sla.replace(kh_frac=0.25, kl_frac=0.0,
                              col_capacity_factor=None)
        if decode:
            sla = sla.replace(decode_mode="sla")
        out.append(dataclasses.replace(cfg, sla=sla))
    return out


@functools.lru_cache(maxsize=None)
def _weights():
    """The reference test's weights (`test_serving.py::_params`), and the
    port's model holding them."""
    jcfg, tcfg = _cfgs(True)
    params = jtfm.init(jax.random.PRNGKey(0), jcfg)
    params["layers"]["sla_proj"] = jax.random.normal(
        jax.random.PRNGKey(7), params["layers"]["sla_proj"].shape) * 0.3
    model = ttfm.init(None, tcfg, device="cpu")
    model.load_state_dict(bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), device="cpu"))
    return params, model


def _prompts(vocab, lens, seed):
    rs = np.random.default_rng(seed)
    return [rs.integers(0, vocab, size=n).astype(np.int32) for n in lens]


# --------------------------------------------------------------------------
# masks.score_map_pooled, ops.sla_attention_rows
# --------------------------------------------------------------------------
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
@pytest.mark.parametrize("routing", ["threshold", "learned"])
def test_score_map_pooled_matches_jax(routing, causal):
    rs = np.random.default_rng(11)
    b, h, n, d, blk = 1, 4, 128, 32, 16
    q, k = (rs.standard_normal((b, h, n, d), dtype=np.float32)
            for _ in range(2))
    kw = dict(block_q=blk, block_kv=blk, kh_frac=0.25, kl_frac=0.0,
              causal=causal, routing_mode=routing)
    jcfg, tcfg = JaxSLAConfig(**kw), SLAConfig(**kw)
    jr = tr = None
    if routing == "learned":
        w = (np.eye(d, dtype=np.float32)[None]
             + 0.1 * rs.standard_normal((h, d, d), dtype=np.float32))
        jr = {"wq": jnp.asarray(w), "wk": jnp.asarray(w[::-1].copy())}
        tr = {name: torch.tensor(np.asarray(x)) for name, x in jr.items()}
    qp, kp = (np.array(jmasks.pool_blocks(jnp.asarray(x), blk))
              for x in (q, k))
    want = np.asarray(jmasks.score_map_pooled(
        jr, jnp.asarray(qp), jnp.asarray(kp), jcfg))
    got = tmasks.score_map_pooled(tr, torch.from_numpy(qp),
                                  torch.from_numpy(kp), tcfg)
    _close(got, want, TOL["f32"], "score_map_pooled")
    # and the port's pooled map is its full-map scorer on the same q, k
    full = tmasks.score_map(tr, torch.from_numpy(q), torch.from_numpy(k),
                            tcfg)
    _close(got, full.numpy(), 1e-6, "pooled vs full score map")
    with pytest.raises(ValueError, match="learned"):
        tmasks.score_map_pooled(None, torch.from_numpy(qp),
                                torch.from_numpy(kp),
                                tcfg.replace(routing_mode="learned"))


def _rows_case(seed, dtype, base, span, h=4, n=128, d=32, blk=16):
    """A span of `span` query blocks from block `base` against the full
    KV, with the rows of a causal plan of the whole map (the same mc on
    both sides, as execution parity wants)."""
    rs = np.random.default_rng(seed)
    q, k, v = (rs.standard_normal((1, h, n, d), dtype=np.float32)
               for _ in range(3))
    if dtype == "bf16":
        q, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
                   for x in (q, k, v))
    kw = dict(block_q=blk, block_kv=blk, kh_frac=0.25, kl_frac=0.25,
              causal=True, col_capacity_factor=None)
    jcfg = JaxSLAConfig(**kw)
    mc = np.asarray(jmasks.classify_blocks(
        jmasks.predict_pc(jnp.asarray(q), jnp.asarray(k), jcfg), jcfg))
    rows = slice(base, base + span)
    qs = q[:, :, base * blk:(base + span) * blk]
    lut, counts = jplan.build_lut(jnp.asarray(mc[:, :, rows]),
                                  jcfg.num_critical(n // blk))
    return dict(q=qs, k=k, v=v, mc=mc[:, :, rows], lut=np.array(lut),
                counts=np.array(counts)), kw


@pytest.mark.parametrize("base,span", [(2, 3), (5, 3), (0, 8)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_sla_attention_rows_matches_jax(dtype, base, span):
    c, kw = _rows_case(3, dtype, base, span)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    marginal = (c["mc"] == 0).astype(np.float32)
    jq, jk, jv = (jnp.asarray(c[x], jdt) for x in ("q", "k", "v"))
    jcfg = JaxSLAConfig(**kw)
    want = jops.sla_attention_rows(
        jq, jk, jv, jphi(jq, jcfg.phi), jphi(jk, jcfg.phi),
        jnp.asarray(marginal), jnp.asarray(c["lut"]),
        jnp.asarray(c["counts"]), jcfg, interpret=True, row_offset=base)
    tq, tk, tv = (torch.from_numpy(c[x]).to(tdt) for x in ("q", "k", "v"))
    tcfg = SLAConfig(**kw)
    got = tops.sla_attention_rows(
        tq, tk, tv, tphi(tq, tcfg.phi), tphi(tk, tcfg.phi),
        torch.from_numpy(marginal), torch.from_numpy(c["lut"]),
        torch.from_numpy(c["counts"]), tcfg, row_offset=base)
    for g, w, name in zip(got, want, ("o_s", "o_l")):
        assert g.shape == tq.shape
        _close(g, np.asarray(w, np.float32), TOL[dtype], name)


# --------------------------------------------------------------------------
# transformer.prefill_chunk -> finalize_chunked_prefill
# --------------------------------------------------------------------------
def _jax_chunks(params, jcfg, toks, backend, decode, ct, max_len):
    carry = jtfm.make_prefill_carry(jcfg, toks.shape[1],
                                    compute_dtype=jnp.float32,
                                    decode_sla=decode)
    hiddens = []
    dmx = max_len if decode else None
    for lo in range(0, toks.shape[1], ct):
        carry, last = jtfm.prefill_chunk(
            params, jcfg, jnp.asarray(toks[:, lo:lo + ct]), carry, lo,
            compute_dtype=jnp.float32, backend=backend, decode_max_len=dmx)
        hiddens.append(np.asarray(last))
    cache = jtfm.finalize_chunked_prefill(jcfg, carry, decode_max_len=dmx)
    return (jax.tree_util.tree_map(np.asarray, carry), hiddens,
            jax.tree_util.tree_map(np.asarray, cache))


@pytest.mark.parametrize("decode", [False, True], ids=["dense", "sla"])
@pytest.mark.parametrize("backend", ["gather", "kernel"])
def test_prefill_chunks_and_finalize_match_reference(backend, decode):
    params, model = _weights()
    jcfg, tcfg = _cfgs(decode)
    max_len, ct = 96, 16
    toks = _prompts(jcfg.vocab_size, (64,), seed=4)[0][None]
    jcarry, jhid, jcache = _jax_chunks(params, jcfg, toks, backend, decode,
                                       ct, max_len)
    cparams = ttfm.compute_params(model, torch.float32)
    carry = ttfm.make_prefill_carry(tcfg, 64, compute_dtype=torch.float32,
                                    decode_sla=decode, device="cpu")
    dmx = max_len if decode else None
    for i, lo in enumerate(range(0, 64, ct)):
        carry, last = ttfm.prefill_chunk(
            cparams, tcfg, torch.from_numpy(toks[:, lo:lo + ct]).long(),
            carry, lo, compute_dtype=torch.float32, backend=backend,
            decode_max_len=dmx)
        _close(last, jhid[i], TOL["f32"], f"chunk {i} last hidden")
    assert set(carry) == set(jcarry)
    for key in ("k", "v", "qpm", "kpm"):
        _close(carry[key], jcarry[key], TOL["f32"], f"carry {key}")
    if decode:
        assert _blocks_differ(carry["dmc"], jcarry["dmc"]) == 0, \
            f"{_blocks_differ(carry['dmc'], jcarry['dmc'])} decode-row " \
            "blocks differ"
    cache = ttfm.finalize_chunked_prefill(tcfg, carry, decode_max_len=dmx)
    assert cache["pos"] == int(jcache["pos"]) == 64
    for key in ("k", "v"):
        _close(cache[key], jcache[key], TOL["f32"], f"cache {key}")
    if decode:
        st, jst = cache["sla"], jcache["sla"]
        assert st["rows"] == int(jst["rows"])
        for key in ("hblk", "zblk", "htot", "ztot", "kpool", "qpool",
                    "retention"):
            _close(st[key], jst[key], TOL["f32"], f"sla {key}")
        for key in ("live_lut", "live_cnt", "live_marg", "extends",
                    "replans", "reuses"):
            assert np.array_equal(st[key].numpy(), jst[key]), key
        for name in tplan.PLAN_LEAVES:
            n = _blocks_differ(getattr(st["plan"], name),
                               getattr(jst["plan"], name))
            assert n == 0, f"plan {name}: {n} blocks differ"
    # the port's chunks equal its own blocking prefill
    last, blocking = ttfm.prefill(cparams, tcfg, torch.from_numpy(toks)
                                  .long(), compute_dtype=torch.float32,
                                  backend=backend, decode_max_len=dmx)
    _close(last, jhid[-1], TOL["f32"], "blocking last hidden")
    for key in ("k", "v"):
        _close(cache[key], blocking[key].numpy(), TOL["f32"],
               f"chunked vs blocking {key}")


def test_prefill_chunk_refuses_what_it_cannot_serve():
    _, model = _weights()
    jcfg, tcfg = _cfgs(True)
    cparams = ttfm.compute_params(model, torch.float32)
    carry = ttfm.make_prefill_carry(tcfg, 64, compute_dtype=torch.float32,
                                    decode_sla=True, device="cpu")
    toks = torch.zeros((1, 16), dtype=torch.long)
    with pytest.raises(ValueError, match="decode_max_len"):
        ttfm.prefill_chunk(cparams, tcfg, toks, carry, 0)
    with pytest.raises(ValueError, match="multiple of block_q"):
        ttfm.prefill_chunk(cparams, tcfg, toks[:, :8], carry, 0,
                           decode_max_len=96)
    with pytest.raises(ValueError, match="batch-1"):
        ttfm.prefill_chunk(cparams, tcfg, toks.expand(2, 16), carry, 0,
                           decode_max_len=96)
    with pytest.raises(ValueError, match="block-aligned"):
        ttfm.make_prefill_carry(tcfg, 40, device="cpu")
    capped = dataclasses.replace(tcfg, sla=tcfg.sla.replace(
        col_capacity_factor=2.0))
    for cfg, match in ((capped, "col_capacity_factor"),
                       (tcfg, "backends")):
        with pytest.raises(ValueError, match=match):
            ttfm.check_chunked_prefill(cfg, "reference" if cfg is tcfg
                                       else "gather")
        with pytest.raises(ValueError, match=match):
            jtfm.check_chunked_prefill(
                dataclasses.replace(jcfg, sla=jcfg.sla.replace(
                    col_capacity_factor=cfg.sla.col_capacity_factor)),
                "reference" if cfg is tcfg else "gather")


def test_carry_snapshot_round_trips_the_written_rows():
    """A snapshot keeps the rows written so far; restored into a zero
    carry it is the carry itself, which is what the reference's
    snapshot (the whole immutable carry) holds."""
    _, model = _weights()
    _, tcfg = _cfgs(True)
    cparams = ttfm.compute_params(model, torch.float32)
    carry = ttfm.make_prefill_carry(tcfg, 64, compute_dtype=torch.float32,
                                    decode_sla=True, device="cpu")
    toks = torch.from_numpy(_prompts(tcfg.vocab_size, (32,), 1)[0][None])
    carry, _ = ttfm.prefill_chunk(cparams, tcfg, toks.long(), carry, 0,
                                  compute_dtype=torch.float32,
                                  decode_max_len=96)
    rows = ttfm.carry_rows(carry, 32, tcfg.sla.block_q)
    assert rows["k"].shape[-2] == 32 and rows["dmc"].shape[-2] == 2
    back = ttfm.carry_restore(ttfm.make_prefill_carry(
        tcfg, 64, compute_dtype=torch.float32, decode_sla=True,
        device="cpu"), rows)
    for key in carry:
        assert torch.equal(back[key], carry[key]), key
    rows["k"].add_(1.0)  # a copy: the carry is untouched
    assert torch.equal(back["k"], carry["k"])


# --------------------------------------------------------------------------
# the chunked Scheduler against the reference's
# --------------------------------------------------------------------------
def _step_until_tokens(sched, n, limit=200):
    events, toks = [], 0
    for _ in range(limit):
        if toks >= n:
            break
        new = sched.step()
        events.extend(new)
        toks += sum(1 for e in new if e.kind == "token")
    assert toks >= n, f"only {toks} tokens after {limit} ticks"
    return events


def _make(pkg, cfg, params, backend, decode, chunk, slots=2):
    api = japi if pkg == "jax" else tapi
    dt = jnp.float32 if pkg == "jax" else torch.float32
    return api.Scheduler(cfg, params, num_slots=slots, max_len=96,
                         prefill_bucket=64, decode_sla=decode,
                         backend=backend, paged=True,
                         prefill_chunk_blocks=chunk, compute_dtype=dt)


def _stats_equal(t, j):
    t, j = dataclasses.asdict(t), dataclasses.asdict(j)
    assert set(t) == set(j)
    for name, want in j.items():
        if name == "decode_last_retention":
            assert abs(t[name] - want) <= 1e-4
        elif name not in TIMES:
            assert t[name] == want, name


@pytest.mark.parametrize("decode", [False, True], ids=["dense", "sla"])
@pytest.mark.parametrize("backend", ["gather", "kernel"])
def test_chunked_scheduler_matches_reference(backend, decode):
    """The reference's mixed-length trace with slot turnover (prompts 64,
    24, 48; budgets 6, 8, 5; 2 slots; chunks of one block): the port's
    chunked run against the reference's chunked run, and the port's
    chunked tokens against its blocking ones. Then one request stopped
    after 4 tokens: its slot's cache leaves, port against reference."""
    params, model = _weights()
    jcfg, tcfg = _cfgs(decode)
    prompts = _prompts(jcfg.vocab_size, (64, 24, 48), seed=4)
    budgets = (6, 8, 5)
    runs = {}
    for pkg, cfg, p, chunk in (("jax", jcfg, params, 1),
                               ("torch", tcfg, model, 1),
                               ("torch", tcfg, model, None)):
        api = japi if pkg == "jax" else tapi
        s = _make(pkg, cfg, p, backend, decode, chunk)
        events = []
        for prompt, n in zip(prompts, budgets):
            s.submit(prompt, api.SamplingParams(max_new_tokens=n))
        while s.has_work:
            events += s.step()
        runs[pkg, chunk] = ([r.tokens_out for r in s._requests],
                            [(e.rid, e.kind, e.token, e.index)
                             for e in events], s.stats)
    (jt, je, js), (tt, te, ts) = runs["jax", 1], runs["torch", 1]
    assert tt == jt and [len(t) for t in tt] == list(budgets)
    assert te == je
    _stats_equal(ts, js)
    # 4 chunks each, less one: the 48-token prompt resumes past the
    # first chunk of left padding it shares with the 24-token one
    assert ts.chunked_admissions == 3 and ts.prefill_chunks == 11
    assert runs["torch", None][0] == tt  # chunked == blocking tokens

    # mid-decode leaves of one request, stopped after 4 emitted tokens
    live = {}
    for pkg, cfg, p in (("jax", jcfg, params), ("torch", tcfg, model)):
        api = japi if pkg == "jax" else tapi
        s = _make(pkg, cfg, p, backend, decode, 1)
        s.submit(prompts[0], api.SamplingParams(max_new_tokens=8))
        _step_until_tokens(s, 4)
        mdl = jtfm if pkg == "jax" else ttfm
        live[pkg] = mdl.paged_dense_view(cfg, s._live)
    j, t = jax.tree_util.tree_map(np.asarray, live["jax"]), live["torch"]
    assert int(t["pos"][0]) == int(j["pos"][0])
    for key in ("k", "v"):
        _close(t[key][:, 0], j[key][:, 0], TOL["f32"], key)
    if decode:
        for key in ("hblk", "zblk", "kpool", "htot", "ztot", "qpool"):
            _close(t["sla"][key][:, 0], j["sla"][key][:, 0], TOL["f32"],
                   key)
        for key in ("live_lut", "live_cnt", "live_marg"):
            n = _blocks_differ(t["sla"][key][:, 0], j["sla"][key][:, 0])
            assert n == 0, f"{key}: {n} entries differ"
        assert int(t["sla"]["rows"][0]) == int(j["sla"]["rows"][0])
        n = _blocks_differ(t["sla"]["plan"].mc[:, 0],
                           j["sla"]["plan"].mc[:, 0])
        assert n == 0, f"plan mc: {n} blocks differ"


def _interleave(pkg, cfg, params):
    api = japi if pkg == "jax" else tapi
    prompts = _prompts(cfg.vocab_size, (16, 64), seed=2)
    sched = _make(pkg, cfg, params, "gather", False, 1)
    r0 = sched.submit(prompts[0], api.SamplingParams(max_new_tokens=12))
    events = _step_until_tokens(sched, 1)  # r0 is mid-decode
    r1 = sched.submit(prompts[1], api.SamplingParams(max_new_tokens=4))
    while sched.has_work:
        events.extend(sched.step())
    return r0, r1, events, sched


def test_chunked_admission_interleaves_decode():
    """Decode tokens keep flowing between a chunked admission's start and
    its first token, event for event as in the reference."""
    params, model = _weights()
    jcfg, tcfg = _cfgs()
    r0, r1, events, sched = _interleave("torch", tcfg, model)
    start1 = next(i for i, e in enumerate(events)
                  if e.rid == r1 and e.kind == "start")
    tok1 = next(i for i, e in enumerate(events)
                if e.rid == r1 and e.kind == "token")
    between = [e for e in events[start1:tok1]
               if e.rid == r0 and e.kind == "token"]
    assert len(between) >= 3, len(between)
    st = sched.stats
    assert st.chunked_admissions == 2  # the 16-token prompt chunks too
    assert st.prefill_chunks == 8      # 4 chunks each, no resume
    assert st.prefill_tokens == 128    # dispatched tokens, not buckets
    _, _, jevents, jsched = _interleave("jax", jcfg, params)
    assert [(e.rid, e.kind, e.token, e.index) for e in events] == \
        [(e.rid, e.kind, e.token, e.index) for e in jevents]
    _stats_equal(st, jsched.stats)


def _resume(pkg, cfg, params):
    api = japi if pkg == "jax" else tapi
    rs = np.random.default_rng(5)
    shared = rs.integers(0, cfg.vocab_size, size=48).astype(np.int32)
    pa, pb = [np.concatenate([
        shared, rs.integers(0, cfg.vocab_size, size=16).astype(np.int32)])
        for _ in range(2)]
    sched = _make(pkg, cfg, params, "gather", False, 1, slots=1)
    sched.submit(pa, api.SamplingParams(max_new_tokens=3))
    sched.drain()
    first = (sched.stats.prefill_chunks, sched.stats.prefill_tokens)
    rid_b = sched.submit(pb, api.SamplingParams(max_new_tokens=3))
    toks_b = [list(r.tokens_out) for r in sched.drain() if r.rid == rid_b]
    return first, toks_b, sched, pb


def test_chunked_prefix_resume_skips_chunks():
    """A prompt sharing the first's chunk-aligned 48-token prefix resumes
    from the carry snapshot at the last shared boundary: one dispatch of
    16 tokens, its 3 shared pages claimed from the intern index, and the
    tokens of blocking admission and of the reference."""
    params, model = _weights()
    jcfg, tcfg = _cfgs()
    first, toks_b, sched, pb = _resume("torch", tcfg, model)
    assert first == (4, 64)
    assert sched.stats.prefill_chunks == 5
    assert sched.stats.prefill_tokens == 80
    assert sched.stats.prefix_hits >= 3
    assert len(sched._pf._carry_snaps) == 3  # boundaries 16, 32, 48
    blocking = _make("torch", tcfg, model, "gather", False, None, slots=1)
    blocking.submit(pb, tapi.SamplingParams(max_new_tokens=3))
    assert [list(r.tokens_out) for r in blocking.drain()] == toks_b
    jfirst, jtoks_b, jsched, _ = _resume("jax", jcfg, params)
    assert (first, toks_b) == (jfirst, jtoks_b)
    _stats_equal(sched.stats, jsched.stats)


def test_carry_snapshots_are_copies_capped_at_16():
    """Each job's zero carry is its own and every snapshot is a copy: a
    job writing its carry in place corrupts neither (the reference's
    carries are immutable). The LRU holds at most 16 snapshots."""
    _, model = _weights()
    _, tcfg = _cfgs()
    pf = tapi.PrefillEngine(tcfg, model, ttfm, backend="gather",
                            compute_dtype=torch.float32, decode_sla=False,
                            max_len=96, drift_threshold=None)
    a = pf.carry_proto(64)
    a["k"].fill_(1.0)
    assert not pf.carry_proto(64)["k"].any()
    for i in range(20):
        pf.carry_put((64, bytes([i])), a, 16)
    assert len(pf._carry_snaps) == 16
    assert pf.carry_get((64, bytes([0]))) is None
    got = pf.carry_get((64, bytes([19])))
    assert got["k"][..., :16, :].eq(1).all()
    assert not got["k"][..., 16:, :].any()  # zeros past the rows
    a["k"].fill_(2.0)
    assert pf.carry_get((64, bytes([19])))["k"][..., :16, :].eq(1).all()
    assert pf.carry_bytes() == 16 * sum(
        t[..., :16 if key in ("k", "v") else 1, :].numel()
        * t.element_size() for key, t in a.items())


def test_chunked_requires_paged_and_eligible_config():
    """The reference's refusals: chunking needs paged=True and a chunk of
    at least one block; a column-capped config, which the reference
    refuses, is lifted by the paged Scheduler with its warning; the
    static engine refuses chunking and the continuous one passes it
    through."""
    _, model = _weights()
    _, cfg = _cfgs()
    with pytest.raises(ValueError, match="paged"):
        tapi.Scheduler(cfg, params=None, prefill_chunk_blocks=1)
    with pytest.raises(ValueError, match=">= 1"):
        tapi.Scheduler(cfg, params=None, paged=True, prefill_chunk_blocks=0)
    capped = dataclasses.replace(
        cfg, sla=cfg.sla.replace(col_capacity_factor=2.0))
    with pytest.warns(UserWarning, match="col_capacity_factor"):
        sched = tapi.Scheduler(capped, model, paged=True, max_len=96,
                               prefill_chunk_blocks=1)
    assert sched.cfg.sla.col_capacity_factor is None
    assert sched._chunk_tokens == cfg.sla.block_q
    with pytest.raises(ValueError, match="continuous-batching"):
        ServingEngine(cfg, model, prefill_chunk_blocks=2)
    eng = ServingEngine(cfg, model, batch_size=2, max_len=96,
                        scheduler="continuous", paged=True,
                        prefill_chunk_blocks=2)
    done = eng.run([Request(rid=i, prompt=p, max_new_tokens=3)
                    for i, p in enumerate(_prompts(cfg.vocab_size,
                                                   (32, 20), 3))])
    assert [len(r.tokens_out) for r in done] == [3, 3]
    assert eng.stats.chunked_admissions == 2
    assert eng.stats.prefill_chunks == 2  # 32-token bucket, 32-token chunks


def test_serve_cli_prefill_chunk_matches_reference_cli(tmp_path, capsys):
    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve as torch_serve
    argv = ["--arch", "qwen3-1.7b", "--smoke", "--requests", "3",
            "--batch", "2", "--prompt-len", "32", "--max-new", "5",
            "--scheduler", "continuous", "--paged", "--decode-sla",
            "--prefill-chunk", "1", "--backend", "gather"]
    done = torch_serve.main(argv + ["--device", "cpu", "--stats-json",
                                    str(tmp_path / "t.json")])
    out = capsys.readouterr().out
    jax_serve.main(argv + ["--stats-json", str(tmp_path / "j.json")])
    jout = capsys.readouterr().out
    t = json.loads((tmp_path / "t.json").read_text())
    j = json.loads((tmp_path / "j.json").read_text())
    for name in ("chunked_admissions", "prefill_chunks", "prefill_tokens",
                 "admissions", "decode_tokens", "prefix_hits",
                 "prefix_full_hits"):
        assert t["stats"][name] == j["stats"][name], name
    assert t["stats"]["chunked_admissions"] == 3
    assert [len(r.tokens_out) for r in done] == [5] * 3
    for line in ("lifting sla.col_capacity_factor", "chunked admission:"):
        assert (line in out) and (line in jout), line
