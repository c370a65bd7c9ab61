"""Per-slot and paged decode caches of the transformer, port against JAX.

On the smoke qwen3-1.7b (2 layers, 16 x 16 blocks, `sla_proj` drawn
again) with JAX-initialized weights: `make_cache(per_slot=True)`,
`insert_slot`, `make_paged_cache`, `insert_slot_paged`,
`insert_slot_state_paged`, `slot_state_from_prefill`, `copy_page` and
`paged_dense_view` against the reference on the same inputs (the
reference's own prefill caches, carried over by `bridge.cache_from_numpy`),
every leaf bitwise. Then 24 `decode_step`s in f32 with per-slot positions:
slot 0 admitted first, slot 2 five steps later (so the two cross their
block boundaries at different steps) and slot 1 a runaway inactive slot
that runs past max_len; monolithic and paged, decode-SLA on and off.
Logits within 1e-4 x max(1, max |logits|) of the reference, the live row,
plan, rows and per-slot counters bitwise, and the port's paged cache
bitwise equal to its monolithic one on the active slots (as
`tests/test_paged.py::_compare_active_slots` checks for the reference).
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

MAX_LEN, SLOTS, POOL, STEPS = 96, 3, 24, 24
LOGIT_TOL = 1e-4
PROMPTS = (32, 48)           # slot 0, slot 2
PAGES = ([3, 4], [7, 8, 9])  # their prompt pages; slot 1's scratch is 2
# decode pages each slot writes into (the tail keeps the zero page)
DECODE_PAGES = ([5, 6, 10, 11], [12, 13, 14])


def _cfgs(decode):
    out = []
    for get in (jax_get_arch, get_arch):
        cfg = get("qwen3-1.7b").smoke()
        sla = cfg.sla.replace(kh_frac=0.25, kl_frac=0.0)
        if decode:
            sla = sla.replace(decode_mode="sla")
        out.append(dataclasses.replace(cfg, sla=sla))
    return out


@functools.lru_cache(maxsize=None)
def _setup(decode):
    jcfg, tcfg = _cfgs(decode)
    params = jtfm.init(jax.random.PRNGKey(0), jcfg)
    rs = np.random.default_rng(7)
    params["layers"]["sla_proj"] = jnp.asarray(0.3 * rs.standard_normal(
        params["layers"]["sla_proj"].shape, dtype=np.float32))
    model = ttfm.init(None, tcfg, device="cpu")
    model.load_state_dict(bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), device="cpu"))
    singles = []
    for i, n in enumerate(PROMPTS):
        toks = rs.integers(0, jcfg.vocab_size, size=(1, n)).astype(np.int32)
        kw = {"decode_max_len": MAX_LEN} if decode else {}
        _, single = jtfm.prefill(params, jcfg, jnp.asarray(toks),
                                 compute_dtype=jnp.float32, **kw)
        singles.append(single)
    return jcfg, tcfg, params, model, singles


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(single):
    return bridge.cache_from_numpy(_np(single), device="cpu")


def _leaves(cache, prefix=""):
    """Flat {name: numpy array} of a cache of either package."""
    out = {}
    for key, val in cache.items():
        name = prefix + key
        if isinstance(val, dict):
            out.update(_leaves(val, name + "."))
        elif key == "plan":
            for leaf in tplan.PLAN_LEAVES:
                out[f"{name}.{leaf}"] = np.asarray(getattr(val, leaf))
        elif key != "pos_host":
            out[name] = (val.float().numpy() if torch.is_tensor(val)
                         and val.dtype == torch.bfloat16 else np.asarray(val))
    return out


def _assert_same(tcache, jcache, keys=None):
    t, j = _leaves(tcache), _leaves(_np(jcache))
    assert set(t) == set(j), set(t) ^ set(j)
    for name in (keys or j):
        assert np.array_equal(t[name], np.asarray(j[name], t[name].dtype)), \
            name


def _grow(single):
    """A dense prefill cache padded to MAX_LEN (as the scheduler does)."""
    pad = MAX_LEN - single["k"].shape[-2]
    if pad <= 0:
        return single
    w = [(0, 0)] * 3 + [(0, pad), (0, 0)]
    return dict(single, k=jnp.pad(single["k"], w), v=jnp.pad(single["v"], w))


def _pt(active):
    pt = np.full((SLOTS, MAX_LEN // 16), 0, np.int32)
    pt[1] = 2  # the inactive slot writes into its scratch page
    for slot, i in ((0, 0), (2, 1)):
        row = PAGES[i] + DECODE_PAGES[i] if i in active else [20 + slot]
        pt[slot, :len(row)] = row
    return pt


@pytest.mark.parametrize("decode", [True, False], ids=["sla", "dense"])
def test_cache_constructors_match_reference(decode):
    jcfg, tcfg, _, _, singles = _setup(decode)
    jm = jtfm.make_cache(jcfg, SLOTS, MAX_LEN, dtype=jnp.float32,
                         decode_sla=decode, per_slot=True)
    tm = ttfm.make_cache(tcfg, SLOTS, MAX_LEN, dtype=torch.float32,
                         decode_sla=decode, per_slot=True, device="cpu")
    _assert_same(tm, jm)
    assert tm["pos_host"].tolist() == [0] * SLOTS
    jm = jtfm.insert_slot(jm, _grow(singles[1]), 2)
    ttfm.insert_slot(tm, _port(_grow(singles[1])), 2, tcfg)
    _assert_same(tm, jm)
    assert tm["pos_host"].tolist() == [0, 0, PROMPTS[1]]

    jp = jtfm.make_paged_cache(jcfg, SLOTS, MAX_LEN, POOL,
                               dtype=jnp.float32, decode_sla=decode)
    tp = ttfm.make_paged_cache(tcfg, SLOTS, MAX_LEN, POOL,
                               dtype=torch.float32, decode_sla=decode,
                               device="cpu")
    _assert_same(tp, jp)
    jp = jtfm.insert_slot_paged(jp, singles[0], 0, jnp.asarray(PAGES[0]))
    ttfm.insert_slot_paged(tp, _port(singles[0]), 0, PAGES[0], tcfg)
    _assert_same(tp, jp)
    jstate = jtfm.slot_state_from_prefill(singles[1])
    tstate = ttfm.slot_state_from_prefill(_port(singles[1]))
    assert set(_leaves(tstate)) == set(_leaves(_np(jstate)))
    jp = jtfm.insert_slot_state_paged(jp, jstate, 2)
    ttfm.insert_slot_state_paged(tp, tstate, 2, tcfg)
    _assert_same(tp, jp)
    jp = jtfm.copy_page(jp, 9, 3)
    ttfm.copy_page(tp, 9, 3)
    _assert_same(tp, jp)
    jp["pt"] = jnp.asarray(_pt({0}))
    tp["pt"] = torch.from_numpy(_pt({0}))
    _assert_same(ttfm.paged_dense_view(tcfg, tp),
                 jtfm.paged_dense_view(jcfg, jp))
    # copies, not views: a live leaf never shares storage with its source
    src = _port(singles[0])
    ttfm.insert_slot_paged(tp, src, 0, PAGES[0], tcfg)
    src["k"].zero_()
    if decode:
        src["sla"]["htot"].zero_()
    _assert_same(tp, jp)


def _start(decode, paged):
    """Both packages' caches with slot 0 admitted and slot 1 a runaway."""
    jcfg, _, _, _, singles = _setup(decode)
    if paged:
        jc = jtfm.make_paged_cache(jcfg, SLOTS, MAX_LEN, POOL,
                                   dtype=jnp.float32, decode_sla=decode)
        jc = jtfm.insert_slot_paged(jc, singles[0], 0, jnp.asarray(PAGES[0]))
        jc["pt"] = jnp.asarray(_pt({0}))
    else:
        jc = jtfm.make_cache(jcfg, SLOTS, MAX_LEN, dtype=jnp.float32,
                             decode_sla=decode, per_slot=True)
        jc = jtfm.insert_slot(jc, _grow(singles[0]), 0)
    jc["pos"] = jc["pos"].at[1].set(MAX_LEN - 6)  # runs past max_len
    return jc, bridge.cache_from_numpy(_np(jc), device="cpu")


def _run(decode, paged):
    """24 decode steps in both packages from the same state; returns the
    per-step logits and the final caches."""
    jcfg, tcfg, params, model, singles = _setup(decode)
    rs = np.random.default_rng(11)
    tokens = rs.integers(0, jcfg.vocab_size, size=(STEPS, SLOTS)).astype(
        np.int32)
    kw = dict(compute_dtype=jnp.float32)
    if decode:
        kw["backend"] = "gather"
    step = jax.jit(functools.partial(jtfm.decode_step, cfg=jcfg, **kw))
    jc, tc = _start(decode, paged)
    out = []
    for i in range(STEPS):
        if i == 5:  # slot 2 arrives: staggered block boundaries
            if paged:
                jc = jtfm.insert_slot_paged(jc, singles[1], 2,
                                            jnp.asarray(PAGES[1]))
                jc["pt"] = jnp.asarray(_pt({0, 1}))
                ttfm.insert_slot_paged(tc, _port(singles[1]), 2, PAGES[1],
                                      tcfg)
                tc["pt"].copy_(torch.from_numpy(_pt({0, 1})))
            else:
                jc = jtfm.insert_slot(jc, _grow(singles[1]), 2)
                ttfm.insert_slot(tc, _port(_grow(singles[1])), 2, tcfg)
        jl, jc = step(params, token=jnp.asarray(tokens[i]), cache=jc)
        with torch.no_grad():
            tl, tc = ttfm.decode_step(
                model, tcfg, torch.from_numpy(tokens[i]).long(), tc,
                compute_dtype=torch.float32,
                **({"backend": "gather"} if decode else {}))
        out.append((np.asarray(jl), tl.numpy()))
    return out, jc, tc


@pytest.mark.parametrize("paged", [False, True], ids=["mono", "paged"])
@pytest.mark.parametrize("decode", [True, False], ids=["sla", "dense"])
def test_per_slot_decode_steps_match_reference(decode, paged):
    out, jc, tc = _run(decode, paged)
    for i, (jl, tl) in enumerate(out):
        limit = LOGIT_TOL * max(1.0, float(np.abs(jl).max()))
        assert float(np.abs(tl - jl).max()) <= limit, i
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist() == \
        tc["pos_host"].tolist() == [PROMPTS[0] + STEPS, MAX_LEN - 6 + STEPS,
                                    PROMPTS[1] + STEPS - 5]
    if not decode:
        return
    js, ts = jc["sla"], tc["sla"]
    for name in ("live_lut", "live_cnt", "live_marg", "extends", "replans",
                 "reuses", "rows"):
        assert np.array_equal(ts[name].numpy(), np.asarray(js[name])), name
    for name in ("mc", "lut", "counts", "col_counts", "marginal"):
        assert np.array_equal(getattr(ts["plan"], name).numpy(),
                              np.asarray(getattr(js["plan"], name))), name
    # each active slot crossed its own boundaries: slot 0 at 48, slot 2 at
    # 48 (admission) and 64
    assert ts["extends"][:, 0].tolist() == [1, 1]
    assert ts["extends"][:, 2].tolist() == [1, 1]
    assert (ts["replans"] + ts["reuses"])[:, 0].tolist() == [2, 2]
    assert (ts["replans"] + ts["reuses"])[:, 2].tolist() == [2, 2]


@pytest.mark.parametrize("decode", [True, False], ids=["sla", "dense"])
def test_paged_decode_bitwise_equals_monolithic(decode):
    """The port's paged decode against its monolithic decode: logits of
    the active slots and every cache leaf of theirs bitwise equal."""
    mono, _, tm = _run(decode, paged=False)
    paged, _, tp = _run(decode, paged=True)
    for (_, lm), (_, lp) in zip(mono, paged):
        assert np.array_equal(lm[[0, 2]], lp[[0, 2]])
    view = ttfm.paged_dense_view(_setup(decode)[1], tp)
    for slot, n in ((0, PROMPTS[0] + STEPS), (2, PROMPTS[1] + STEPS - 5)):
        for key in ("k", "v"):
            assert torch.equal(tm[key][:, slot, :, :n],
                               view[key][:, slot, :, :n]), key
        if not decode:
            continue
        for key in ("hblk", "zblk", "kpool", "htot", "ztot", "qpool",
                    "live_lut", "live_cnt", "live_marg"):
            assert torch.equal(tm["sla"][key][:, slot],
                               view["sla"][key][:, slot]), key
        assert torch.equal(tm["sla"]["plan"].mc[:, slot],
                           view["sla"]["plan"].mc[:, slot])
    # the zero page was never written
    assert not tp["kp"][:, 0].any()


@pytest.mark.parametrize("paged", [False, True], ids=["mono", "paged"])
def test_restore_slots_undoes_a_step_at_an_appending_boundary(paged):
    """`snapshot_slots` / `restore_slots` (the scheduler's masked ticks)
    around one decode step in which the frozen slot 0 sits at a block
    boundary that appends a plan row: every leaf of slot 0 (through
    `paged_dense_view` for the paged cache) is bitwise as before."""
    _, tcfg, _, model, _ = _setup(True)
    _, tc = _start(True, paged)
    token = torch.arange(SLOTS)

    def step():
        with torch.no_grad():
            ttfm.decode_step(model, tcfg, token, tc,
                             compute_dtype=torch.float32, backend="gather")

    def slot0():
        view = ttfm.paged_dense_view(tcfg, tc) if paged else tc
        return {name: (a[0] if a.ndim == 1 else a[:, 0]).copy()
                for name, a in _leaves(view).items()}

    for _ in range(48 - PROMPTS[0]):
        step()
    st = tc["sla"]
    assert int(tc["pos_host"][0]) == 48 and int(st["rows"][0]) == 2
    before = slot0()
    snap = ttfm.snapshot_slots(tc, [0], tcfg)
    step()
    assert not np.array_equal(slot0()["sla.plan.col_counts"],
                              before["sla.plan.col_counts"])
    ttfm.restore_slots(tc, snap)
    after = slot0()
    assert set(after) == set(before)
    for name, want in before.items():
        assert np.array_equal(after[name], want), name
