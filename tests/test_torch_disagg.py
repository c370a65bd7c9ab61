"""Disaggregated prefill/decode serving, port against JAX.

`repro_torch.serving.disagg.DisaggScheduler` against
`repro.serving.disagg.DisaggScheduler` on the reference tests' scenarios
(`tests/test_disagg.py`): the smoke qwen3-1.7b with the reference's
weights (`sla_proj` drawn again) carried across by `bridge.py`, f32
compute in both packages, the port's kernels as their plain twins (the
Pallas kernels in interpret mode on the JAX side), and in every scenario
the reference test's virtual clock (0.5 s a call), so that the
watchdog's flags do not depend on this host's wall time. Each reference
run is made once per module. For every scenario the greedy tokens, every
`DisaggStats` counter but `prefill_s`, `pool_stats()` and each request's
event sequence (rid, kind, token, index) must equal the reference's:

  * healthy and kill-mid-stream requeue over gather / kernel x decode-SLA
    off / on (the port's tokens also equal its own single Scheduler's);
  * a killed prefill worker (re-prefill from scratch, chunked), a
    straggler drain, a double fault (loud, no limbo), every prefill
    worker dead, a fault naming a missing worker, flakes within and
    beyond the retry budget, and the event stream across a requeue.

Then the port alone: `Scheduler.admit_external` against self-admission
(paged and unpaged, every cache leaf bitwise, then the tokens), its
refusals, one bundle replayed into two fresh schedulers (slots and token
streams bitwise, the bundle unchanged), the paged column-capacity lift,
a dead worker's freed cache, and a real step's error, which is raised
without a retry (ROADMAP.md queue 3). The paged, chunked trace replay is
`tests/test_torch_disagg_trace.py`.
"""
import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.configs import get_arch as jax_get_arch
from repro.distributed import fault_tolerance as jft
from repro.models import transformer as jtfm
from repro.serving import api as japi
from repro.serving import disagg as jdis
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.core import plan as tplan
from repro_torch.distributed import fault_tolerance as tft
from repro_torch.models import transformer as ttfm
from repro_torch.serving import api as tapi
from repro_torch.serving import disagg as tdis

LENS = (32, 20, 24, 16)
BUDGETS = (6, 9, 4, 7)
BUCKET = 32
PKG = {"jax": (japi, jdis, jft, jnp.float32),
       "torch": (tapi, tdis, tft, torch.float32)}


def _cfgs(decode=False, kh=1.0, kl=0.0, chunk=False):
    """The reference test's `_arch`, in both packages."""
    out = {}
    for pkg, get in (("jax", jax_get_arch), ("torch", get_arch)):
        cfg = get("qwen3-1.7b").smoke()
        sla = cfg.sla.replace(kh_frac=kh, kl_frac=kl)
        if decode:
            sla = sla.replace(decode_mode="sla")
        if chunk:
            sla = sla.replace(col_capacity_factor=None)
        out[pkg] = dataclasses.replace(cfg, sla=sla)
    return out


@functools.lru_cache(maxsize=None)
def _weights():
    """The reference test's `_params`, and the port's model holding them."""
    cfg = _cfgs()["jax"]
    params = jtfm.init(jax.random.PRNGKey(0), cfg)
    params["layers"]["sla_proj"] = jax.random.normal(
        jax.random.PRNGKey(7), params["layers"]["sla_proj"].shape) * 0.3
    model = ttfm.init(None, _cfgs()["torch"], device="cpu")
    model.load_state_dict(bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), device="cpu"))
    return {"jax": params, "torch": model}


def _prompts(vocab, lens=LENS, seed=0):
    rs = np.random.default_rng(seed)
    return [rs.integers(0, vocab, size=n).astype(np.int32) for n in lens]


class TickClock:
    """The reference test's virtual clock: every call advances 0.5 s."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.5
        return self.t


def _plan(pkg, events):
    ft = PKG[pkg][2]
    return ft.FaultPlan([ft.FaultEvent(**e) for e in events])


def _drive(dis, events, on_tick=None):
    """drain(), keeping each tick's events; an exception ends the run and
    is returned."""
    try:
        while dis.has_work:
            events.extend(dis.tick())
            if on_tick is not None:
                on_tick(dis)
    except (RuntimeError, ValueError) as e:
        return e
    return None


# the scenarios of tests/test_disagg.py: (cfg kwargs, prompt lens,
# budgets, DisaggScheduler kwargs, fault events)
KILL3 = [dict(tick=3, kind="kill", pool="decode", worker=0)]
SCENARIOS = {
    **{f"healthy-{b}-{'sla' if d else 'dense'}": (
        dict(decode=d), LENS, BUDGETS,
        dict(backend=b, decode_sla=d), [])
       for b in ("gather", "kernel") for d in (False, True)},
    **{f"kill-{b}-{'sla' if d else 'dense'}": (
        dict(decode=d), LENS, BUDGETS,
        dict(backend=b, decode_sla=d, decode_step_mode="token"), KILL3)
       for b in ("gather", "kernel") for d in (False, True)},
    "kill-prefill": (
        dict(chunk=True, kh=0.25), (32,), (6,),
        dict(prefill_workers=2, decode_workers=1, decode_sla=False,
             prefill_chunk_blocks=1),
        [dict(tick=2, kind="kill", pool="prefill", worker=0)]),
    "straggler": (
        dict(), LENS, BUDGETS,
        dict(decode_sla=False, decode_step_mode="token", watchdog=2),
        [dict(tick=2, kind="straggle", pool="decode", worker=0,
              factor=10.0)]),
    "flake": (
        dict(), LENS, BUDGETS,
        dict(decode_sla=False, decode_step_mode="token", max_retries=3),
        [dict(tick=2, kind="flake", pool="decode", worker=0,
              failures=2)]),
    "stream-requeue": (
        dict(), (32, 20), (6, 6),
        dict(decode_step_mode="token"), KILL3),
    "double-fault": (
        dict(), (32,), (16,),
        dict(decode_sla=False, decode_step_mode="token", max_requeues=1),
        KILL3 + [dict(tick=6, kind="kill", pool="decode", worker=1)]),
    "all-prefill-dead": (
        dict(), (20,), (4,), dict(decode_workers=1),
        [dict(tick=1, kind="kill", pool="prefill", worker=0)]),
    "missing-worker": (
        dict(), (16,), (2,), dict(),
        [dict(tick=1, kind="kill", pool="decode", worker=9)]),
    "flake-beyond-budget": (
        dict(), (16,), (2,), dict(max_retries=2),
        [dict(tick=1, kind="flake", pool="prefill", worker=0,
              failures=5)]),
}


@functools.lru_cache(maxsize=None)
def _run(pkg, name):
    """One scenario on one package, run once per module."""
    cfg_kw, lens, budgets, kw, faults = SCENARIOS[name]
    api, dis_mod, ft, dt = PKG[pkg]
    cfg = _cfgs(**cfg_kw)[pkg]
    kw = dict(kw)
    sleeps = []
    if "watchdog" in kw:
        kw["watchdog"] = ft.StragglerWatchdog(threshold=2.0,
                                              warmup=kw["watchdog"])
    kw.pop("clock", None)
    kw.setdefault("prefill_workers", 1)
    kw.setdefault("decode_workers", 2)
    dis = dis_mod.DisaggScheduler(
        cfg, _weights()[pkg], slots_per_worker=2, max_len=96,
        prefill_bucket=BUCKET, compute_dtype=dt,
        fault_plan=_plan(pkg, faults), clock=TickClock(),
        sleep=sleeps.append, **kw)
    for p, b in zip(_prompts(cfg.vocab_size, lens), budgets):
        dis.submit(p, api.SamplingParams(max_new_tokens=b))
    drained = []

    def watch(d):  # the straggler's admissions when it was flagged
        w0 = d._decode_pool[0]
        if w0.draining and not drained:
            drained.append(w0.admitted)

    events = []
    err = _drive(dis, events, watch)
    stats = dataclasses.asdict(dis.stats)
    stats.pop("prefill_s")
    return SimpleNamespace(
        dis=dis, err=None if err is None else (
            "RuntimeError" if isinstance(err, RuntimeError) else
            type(err).__name__, str(err)),
        tokens=[list(r.tokens_out) for r in dis._requests], stats=stats,
        pool=dis.pool_stats(), sleeps=sleeps, drained=drained,
        events=[(e.rid, e.kind, e.token, e.index) for e in events],
        states=[(r.state.value, r.slot, r.metrics.decode_tokens)
                for r in dis._requests],
        queue=[r.rid for r in dis._queue], owner=sorted(dis._owner),
        bundles=sorted(dis._bundles),
        occupancy=(dis.decode_occupancy(), dis.stats.prefill_occupancy()))


def _baseline(name):
    """The port's single Scheduler on a scenario's prompts."""
    cfg_kw, lens, budgets, kw, _ = SCENARIOS[name]
    cfg = _cfgs(**cfg_kw)["torch"]
    sched = tapi.Scheduler(cfg, _weights()["torch"], num_slots=2,
                           max_len=96, backend=kw.get("backend", "gather"),
                           decode_sla=kw.get("decode_sla"),
                           prefill_bucket=BUCKET,
                           compute_dtype=torch.float32)
    for p, b in zip(_prompts(cfg.vocab_size, lens), budgets):
        sched.submit(p, tapi.SamplingParams(max_new_tokens=b))
    return [list(r.tokens_out) for r in sched.drain()]


def _assert_matches(name):
    t, j = _run("torch", name), _run("jax", name)
    assert t.err == j.err
    assert t.tokens == j.tokens
    assert t.stats == j.stats
    assert t.pool == j.pool
    assert t.events == j.events
    assert t.sleeps == j.sleeps
    assert t.states == j.states and t.queue == j.queue
    assert t.owner == j.owner and t.bundles == j.bundles
    assert t.occupancy == j.occupancy
    return t


@pytest.mark.parametrize("name", [n for n in SCENARIOS
                                  if n.startswith(("healthy", "kill-g",
                                                   "kill-k"))])
def test_parity_healthy_and_kill_requeue_match_reference(name):
    """Healthy runs route by least load; the kill at tick 3 lands while
    decode:0's residents are mid-stream and they replay from their
    bundles. Both equal the reference and the port's single Scheduler."""
    t = _assert_matches(name)
    n = len(LENS)
    assert t.err is None
    assert t.stats["completed"] == t.stats["submitted"] == n
    assert t.stats["handoffs"] == n
    if name.startswith("kill"):
        assert t.stats["kills"] == 1 and t.stats["requeues"] >= 1
        assert not t.pool["decode"][0]["alive"]
        assert t.dis._decode_pool[0].sched._live is None  # freed
    else:
        assert t.stats["requeues"] == 0
    assert t.tokens == _baseline(name)


def test_kill_prefill_worker_reprefills_from_scratch():
    """The tick-2 kill lands between prefill:0's two chunks; the request
    requeues from scratch and prefill:1 resumes it from the shared
    engine's snapshot of the first chunk (one more chunk)."""
    t = _assert_matches("kill-prefill")
    assert t.stats["kills"] == 1 and t.stats["requeues"] == 1
    assert t.stats["prefill_chunks"] == 2 and t.stats["completed"] == 1
    assert not t.pool["prefill"][0]["alive"]
    assert t.tokens == _baseline("kill-prefill")


def test_straggler_drain_loses_nothing():
    """decode:0 straggles 10x from tick 2; flagged after the watchdog's
    warmup, it finishes its residents and takes nothing new."""
    t = _assert_matches("straggler")
    j = _run("jax", "straggler")
    assert t.drained == j.drained and len(t.drained) == 1
    assert t.stats["straggler_drains"] == 1
    assert t.pool["decode"][0]["admitted"] == t.drained[0]
    assert t.pool["decode"][0]["alive"]
    assert t.stats["completed"] == len(LENS)
    assert t.tokens == _baseline("straggler")


def test_flake_retries_with_recorded_backoff():
    t = _assert_matches("flake")
    assert t.sleeps == [1.0, 2.0]
    assert t.stats["retries"] == 2
    assert t.stats["kills"] == 0 and t.stats["requeues"] == 0
    assert t.tokens == _baseline("flake")


def test_stream_events_well_formed_across_requeue():
    t = _assert_matches("stream-requeue")
    assert t.stats["kills"] == 1 and t.stats["requeues"] >= 1
    for rid in (0, 1):
        kinds = [e[1] for e in t.events if e[0] == rid]
        assert kinds.count("start") == 1 and kinds.count("finish") == 1
        assert kinds[0] == "start" and kinds[-1] == "finish"
        idx = [e[3] for e in t.events if e[0] == rid and e[1] == "token"]
        assert idx[-6:] == list(range(6))  # dense from 0 after the replay


def test_double_fault_raises_and_leaves_no_limbo():
    t = _assert_matches("double-fault")
    assert t.err[0] == "RuntimeError" and "max_requeues" in t.err[1]
    assert t.states == [("queued", None, 0)] and t.tokens == [[]]
    assert t.queue == [0] and t.owner == [] and t.bundles == []
    assert t.stats["kills"] == 2 and t.stats["requeues"] == 1
    with pytest.raises(RuntimeError, match="decode"):
        t.dis.drain()  # every decode worker is dead


@pytest.mark.parametrize("name,match", [
    ("all-prefill-dead", "prefill worker"),
    ("missing-worker", "has 2 workers"),
    ("flake-beyond-budget", "injected transient fault")])
def test_loud_failures_match_reference(name, match):
    t = _assert_matches(name)
    assert t.err is not None and match in t.err[1]


def test_least_loaded_and_submit_refusals():
    a, b, c = (SimpleNamespace(wid=i, load=n) for i, n in enumerate(
        (2, 1, 1)))
    assert tdis.least_loaded([a, b, c]) is b
    assert tdis.least_loaded([a]) is a and tdis.least_loaded([]) is None
    cfg = _cfgs()["torch"]
    dis = tdis.DisaggScheduler(cfg, _weights()["torch"], max_len=48,
                               prefill_bucket=BUCKET)
    with pytest.raises(ValueError, match="max_len"):
        dis.submit(np.arange(32, dtype=np.int32),
                   tapi.SamplingParams(max_new_tokens=32))
    with pytest.raises(ValueError, match="empty prompt"):
        dis.submit(np.zeros((0,), np.int32))
    with pytest.raises(ValueError, match="step_mode"):
        tdis.DisaggScheduler(cfg, _weights()["torch"], max_len=48,
                             decode_step_mode="burst")
    with pytest.raises(ValueError, match="at least one worker"):
        tdis.DisaggScheduler(cfg, _weights()["torch"], decode_workers=0)


# --------------------------------------------------------------------------
# the port alone: admit_external, bundles, the capacity lift, step errors
# --------------------------------------------------------------------------
def _leaves(x, prefix=""):
    if torch.is_tensor(x):
        yield prefix, x
    elif isinstance(x, dict):
        for key, val in x.items():
            yield from _leaves(val, f"{prefix}.{key}")
    elif isinstance(x, tplan.SLAPlan):
        for key in tplan.PLAN_LEAVES:
            yield from _leaves(getattr(x, key), f"{prefix}.{key}")
    elif isinstance(x, (int, np.ndarray)):
        yield prefix, torch.as_tensor(np.asarray(x))


def _assert_bitwise(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for key in la:
        assert la[key].dtype == lb[key].dtype, key
        assert torch.equal(la[key], lb[key]), key


def _chunk_cfg(decode=True):
    return _cfgs(decode=decode, kh=0.25, chunk=True)["torch"]


def _sched(cfg, paged, max_len=96):
    return tapi.Scheduler(cfg, _weights()["torch"], num_slots=2,
                          max_len=max_len, backend="kernel",
                          decode_sla=True, prefill_bucket=BUCKET,
                          paged=paged, compute_dtype=torch.float32)


def _bundle(sched, prompt, chunk_tokens=0):
    """A prefill worker over an engine like `sched`'s: the bundle of one
    request at the shared bucket."""
    eng = tapi.PrefillEngine(
        sched.cfg, None, sched.mdl, backend=sched.backend,
        compute_dtype=sched.compute_dtype, decode_sla=sched.decode_sla,
        max_len=sched.max_len, drift_threshold=None,
        chunk_tokens=chunk_tokens, cparams=sched._cparams)
    worker = tdis.PrefillWorker(0, eng)
    r = tapi.ServedRequest(rid=0, prompt=prompt,
                           sampling=tapi.SamplingParams(max_new_tokens=5))
    toks = np.zeros((1, BUCKET), np.int32)
    toks[0, BUCKET - len(prompt):] = prompt
    worker.assign(r, toks, BUCKET)
    stats = tdis.DisaggStats()
    done = None
    while done is None:
        done = worker.tick(stats)
    return done


@pytest.mark.parametrize("paged", [False, True], ids=["mono", "paged"])
def test_admit_external_equals_self_admission(paged):
    """A bundle admitted through admit_external leaves every cache leaf
    (page table included) bitwise what the scheduler's own admission of
    the same prompt writes, and the same tokens follow."""
    cfg = _chunk_cfg()
    prompt = _prompts(cfg.vocab_size, (24,), seed=9)[0]
    own = _sched(cfg, paged)
    own.submit(prompt, tapi.SamplingParams(max_new_tokens=5))
    own._tick_admit([])
    ext = _sched(cfg, paged)
    r, bundle = _bundle(ext, prompt)
    evs = tdis.DecodeWorker(0, ext).admit(r, bundle, plan_built=True,
                                          prefilled=bundle.prefilled)
    assert [(e.kind, e.index) for e in evs] == [("token", 0)]
    _assert_bitwise(ext._live, own._live)
    mine = own._requests[0]
    assert r.tokens_out == mine.tokens_out
    assert dataclasses.asdict(ext.stats)["admissions"] == 1
    while own.has_work:
        own.step()
        ext.step()
    assert r.tokens_out == mine.tokens_out and len(r.tokens_out) == 5
    for name in ("prefill_tokens", "decode_tokens", "decode_plan_builds",
                 "decode_plan_extends", "page_allocs", "prefix_misses"):
        assert getattr(ext.stats, name) == getattr(own.stats, name), name


def test_admit_external_refusals():
    """An occupied slot is refused; a bucket that cannot hold the budget
    returns the request to QUEUED with no slot."""
    cfg = _chunk_cfg()
    sched = _sched(cfg, paged=True, max_len=48)
    prompt = _prompts(cfg.vocab_size, (24,), seed=9)[0]
    r, bundle = _bundle(sched, prompt)
    sched.admit_external(r, 0, bundle.cache, bundle.logits, bundle.toks,
                         BUCKET, prefilled=BUCKET)
    with pytest.raises(ValueError, match="occupied"):
        sched.admit_external(r, 0, bundle.cache, bundle.logits,
                             bundle.toks, BUCKET, prefilled=0)
    big = tapi.ServedRequest(rid=1, prompt=prompt,
                             sampling=tapi.SamplingParams(max_new_tokens=20))
    with pytest.raises(ValueError, match="handoff request 1"):
        sched.admit_external(big, 1, bundle.cache, bundle.logits,
                             bundle.toks, BUCKET, prefilled=0)
    assert big.state is tapi.RequestState.QUEUED and big.slot is None
    assert sched.free_slots() == [1]


@pytest.mark.parametrize("paged", [False, True], ids=["mono", "paged"])
def test_one_bundle_replays_twice_bitwise(paged):
    """A chunked bundle (its k/v from the finalized carry) admitted into
    one fresh scheduler and drained, then into a second: both slots right
    after admission and both token streams are bitwise equal, and the
    bundle is bitwise its clone from before the first admission."""
    cfg = _chunk_cfg()
    prompt = _prompts(cfg.vocab_size, (32,), seed=4)[0]
    first = _sched(cfg, paged, max_len=BUCKET + 16)
    r, bundle = _bundle(first, prompt, chunk_tokens=cfg.sla.block_q)
    clone = {k: v.clone() for k, v in _leaves(bundle.cache)}
    slots, streams = [], []
    for sched in (first, _sched(cfg, paged, max_len=BUCKET + 16)):
        req = tapi.ServedRequest(rid=0, prompt=prompt,
                                 sampling=tapi.SamplingParams(
                                     max_new_tokens=12))
        sched.admit_external(req, 0, bundle.cache, bundle.logits,
                             bundle.toks, BUCKET, prefilled=0)
        slots.append({k: v.clone() for k, v in _leaves(sched._live)})
        while sched.has_work:
            sched.step()
        streams.append(list(req.tokens_out))
    assert slots[0].keys() == slots[1].keys()
    for key in slots[0]:
        assert torch.equal(slots[0][key], slots[1][key]), key
    assert streams[0] == streams[1] and len(streams[0]) == 12
    after = dict(_leaves(bundle.cache))
    for key, val in clone.items():
        assert torch.equal(after[key], val), key


@pytest.mark.parametrize("paged", [False, True], ids=["mono", "paged"])
def test_paged_disagg_lifts_the_column_capacity(paged):
    """With paged=True the prefill pool and every decode worker run the
    lifted config (a warning says so), and the tokens equal the port's
    paged single Scheduler's, which lifts alike; unpaged keeps it."""
    cfg = _cfgs(decode=True, kh=0.25)["torch"]
    assert cfg.sla.col_capacity_factor is not None
    model = _weights()["torch"]
    kw = dict(max_len=96, prefill_bucket=BUCKET, backend="kernel",
              decode_sla=True, paged=paged, compute_dtype=torch.float32)
    if paged:
        with pytest.warns(UserWarning, match="col_capacity_factor"):
            dis = tdis.DisaggScheduler(cfg, model, **kw)
    else:
        dis = tdis.DisaggScheduler(cfg, model, **kw)
    want = None if paged else cfg.sla.col_capacity_factor
    assert dis.cfg.sla.col_capacity_factor == want
    assert dis._engine.cfg.sla.col_capacity_factor == want
    assert all(w.sched.cfg.sla.col_capacity_factor == want
               for w in dis._decode_pool)
    assert cfg.sla.col_capacity_factor is not None  # the caller's is kept
    prompts = _prompts(cfg.vocab_size)
    for p, b in zip(prompts, BUDGETS):
        dis.submit(p, tapi.SamplingParams(max_new_tokens=b))
    got = [list(r.tokens_out) for r in dis.drain()]
    if paged:
        with pytest.warns(UserWarning, match="col_capacity_factor"):
            sched = tapi.Scheduler(cfg, model, num_slots=2, **kw)
    else:
        sched = tapi.Scheduler(cfg, model, num_slots=2, **kw)
    for p, b in zip(prompts, BUDGETS):
        sched.submit(p, tapi.SamplingParams(max_new_tokens=b))
    assert got == [list(r.tokens_out) for r in sched.drain()]


def test_real_step_error_is_raised_without_retry():
    """A decode step that has written its state and then fails (here a
    RuntimeError after the real step ran) is not retried: the harness
    raises it at once with no retry counted, where the reference would
    run the step again on the written state. An injected flake on the
    same worker is still retried."""
    cfg = _cfgs()["torch"]
    plan = tft.FaultPlan([tft.FaultEvent(tick=1, kind="flake",
                                         pool="decode", worker=0)])
    dis = tdis.DisaggScheduler(cfg, _weights()["torch"], max_len=96,
                               prefill_bucket=BUCKET, fault_plan=plan,
                               decode_step_mode="token",
                               compute_dtype=torch.float32,
                               sleep=lambda s: None)
    sched = dis._decode_pool[0].sched
    one, calls = sched._one, []

    def failing(token):
        calls.append(int(sched._live["pos_host"][0]))
        logits = one(token)  # the step writes its K/V and position
        if len(calls) == 3:
            raise RuntimeError("CUDA error: unspecified launch failure")
        return logits

    sched._one = failing
    dis.submit(_prompts(cfg.vocab_size, (20,))[0],
               tapi.SamplingParams(max_new_tokens=8))
    with pytest.raises(RuntimeError, match="launch failure"):
        dis.drain()
    assert dis.stats.retries == 1  # the flake, not the step error
    assert len(calls) == 3 and calls == sorted(set(calls))


def test_serve_cli_disagg_matches_reference_cli(tmp_path, capsys):
    """`--disagg --paged --prefill-chunk 1 --decode-sla` through both
    CLIs: the same DisaggStats in --stats-json (mode "disagg"), the same
    printed pool lines, and every request served."""
    import json

    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve as torch_serve
    argv = ["--arch", "qwen3-1.7b", "--smoke", "--requests", "4",
            "--batch", "2", "--prompt-len", "32", "--max-new", "4",
            "--disagg", "--paged", "--prefill-chunk", "1", "--decode-sla",
            "--backend", "gather"]
    done = torch_serve.main(argv + ["--device", "cpu", "--stats-json",
                                    str(tmp_path / "t.json")])
    out = capsys.readouterr().out
    jax_serve.main(argv + ["--stats-json", str(tmp_path / "j.json")])
    jout = capsys.readouterr().out
    t = json.loads((tmp_path / "t.json").read_text())
    j = json.loads((tmp_path / "j.json").read_text())
    assert t["mode"] == j["mode"] == "disagg"
    t["stats"].pop("prefill_s")
    j["stats"].pop("prefill_s")
    assert t["stats"] == j["stats"]
    assert [r["state"] for r in t["requests"]] == ["finished"] * 4
    assert [len(r.tokens_out) for r in done] == [4] * 4

    def pool_lines(text):
        return [line.split(" in ")[0] if "requests in" in line else line
                for line in text.splitlines()
                if line.startswith(("faults:", "  decode:"))
                or "requests in" in line]
    assert pool_lines(out) == pool_lines(jout) and len(pool_lines(out)) == 4
