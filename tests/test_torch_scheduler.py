"""The continuous LM scheduler and its paged KV cache, port against JAX.

`repro_torch.serving.api.Scheduler` against `repro.serving.api.Scheduler`
on the smoke qwen3-1.7b with JAX-initialized weights (`sla_proj` drawn
again), in f32 compute, paged and unpaged, decode-time SLA on and off:
5 requests through 2 slots, two submitted first and three more after
three `step()`s (staggered), sharing a 16-token prefix, one an exact
repeat of the first (a full-prompt snapshot hit in paged mode) and one
sampling (temperature 0.8, seed 3); two more `step()`s, then `drain()`.
The port runs its kernel backend (the CUDA kernels' plain twins on the
CPU) against the reference's gather backend. Every token, every
ServeStats counter (the page counters included) and the sequence of
stream events must be equal, and the port's paged tokens equal its
unpaged ones. Then the serve CLI's continuous, paged and streaming modes
against the reference CLI's counters and --stats-json keys.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import transformer as jtfm
from repro.serving import api as japi
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.models import transformer as ttfm
from repro_torch.serving import api as tapi

BUDGETS = (6, 10, 4, 8, 5)
TEMPS = (0.0, 0.0, 0.8, 0.0, 0.0)
TIMES = ("prefill_s", "decode_s", "max_decode_gap_s")


def _cfgs(decode):
    out = []
    for get in (jax_get_arch, get_arch):
        cfg = get("qwen3-1.7b").smoke()
        # uncapped: the port's paged Scheduler lifts the column capacity
        # (a shared page must be a pure function of its prefix)
        sla = cfg.sla.replace(kh_frac=0.25, kl_frac=0.0,
                              col_capacity_factor=None)
        if decode:
            sla = sla.replace(decode_mode="sla")
        out.append(dataclasses.replace(cfg, sla=sla))
    return out


@functools.lru_cache(maxsize=None)
def _weights():
    jcfg, tcfg = _cfgs(True)
    params = jtfm.init(jax.random.PRNGKey(0), jcfg)
    params["layers"]["sla_proj"] = jax.random.normal(
        jax.random.PRNGKey(7), params["layers"]["sla_proj"].shape) * 0.3
    model = ttfm.init(None, tcfg, device="cpu")
    model.load_state_dict(bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), device="cpu"))
    rs = np.random.default_rng(0)
    shared = rs.integers(0, jcfg.vocab_size, size=16).astype(np.int32)
    prompts = [np.concatenate([shared, rs.integers(
        0, jcfg.vocab_size, size=n - 16).astype(np.int32)])
        for n in (32, 20, 32, 24)]
    prompts.append(prompts[0].copy())  # an exact repeat
    return params, model, prompts


def _drive(sched, sp_cls, prompts):
    """The trace: 2 submissions, 3 steps, 3 more, 2 steps, drain."""
    events = []

    def submit(idx):
        for i in idx:
            sched.submit(prompts[i], sp_cls(max_new_tokens=BUDGETS[i],
                                            temperature=TEMPS[i], seed=3))

    submit((0, 1))
    for _ in range(3):
        events += sched.step()
    submit((2, 3, 4))
    for _ in range(2):
        events += sched.step()
    done = sched.drain()
    return ([r.tokens_out for r in done],
            [(e.rid, e.kind, e.token, e.index) for e in events],
            dataclasses.asdict(sched.stats))


@functools.lru_cache(maxsize=None)
def _port_run(decode, paged):
    params, model, prompts = _weights()
    _, tcfg = _cfgs(decode)
    sched = tapi.Scheduler(tcfg, model, num_slots=2, max_len=96,
                           prefill_bucket=32, decode_sla=decode, paged=paged,
                           backend="kernel", compute_dtype=torch.float32)
    return _drive(sched, tapi.SamplingParams, prompts)


@pytest.mark.parametrize("paged", [False, True], ids=["mono", "paged"])
@pytest.mark.parametrize("decode", [True, False], ids=["sla", "dense"])
def test_scheduler_matches_reference(decode, paged):
    params, _, prompts = _weights()
    jcfg, _ = _cfgs(decode)
    jsched = japi.Scheduler(jcfg, params, num_slots=2, max_len=96,
                            prefill_bucket=32, decode_sla=decode,
                            paged=paged, compute_dtype=jnp.float32)
    jtoks, jevents, jstats = _drive(jsched, japi.SamplingParams, prompts)
    ttoks, tevents, tstats = _port_run(decode, paged)
    assert ttoks == jtoks
    assert [len(t) for t in ttoks] == list(BUDGETS)
    assert tevents == jevents
    assert set(tstats) == set(jstats)
    for name, want in jstats.items():
        if name == "decode_last_retention":
            assert abs(tstats[name] - want) <= 1e-4
        elif name not in TIMES:
            assert tstats[name] == want, name
    if paged:
        assert tstats["prefix_full_hits"] == 1
        assert tstats["prefix_hits"] > 0 and tstats["cow_copies"] > 0
        assert ttoks == _port_run(decode, False)[0]
    if decode:
        assert tstats["decode_plan_reuses"] + \
            tstats["decode_plan_replans"] > 0


def test_scheduler_refuses_what_it_cannot_serve():
    _, model, prompts = _weights()
    _, tcfg = _cfgs(True)
    with pytest.raises(ValueError, match="plan_reuse='adaptive'"):
        tapi.Scheduler(tcfg, model, paged=True, plan_reuse="adaptive")
    # chunked admission is ported (tests/test_torch_chunked_prefill.py):
    # it needs a paged cache and a chunk of at least one block
    with pytest.raises(ValueError, match="paged=True"):
        tapi.Scheduler(tcfg, model, prefill_chunk_blocks=1)
    with pytest.raises(ValueError, match=">= 1"):
        tapi.Scheduler(tcfg, model, paged=True, prefill_chunk_blocks=0)
    chunked = tapi.Scheduler(tcfg, model, num_slots=1, max_len=48,
                             paged=True, prefill_chunk_blocks=1)
    assert chunked._chunk_tokens == tcfg.sla.block_q
    sched = tapi.Scheduler(tcfg, model, num_slots=1, max_len=48,
                           decode_sla=True, paged=True)
    # the disaggregated handoff is ported (tests/test_torch_disagg.py): a
    # bucket that cannot hold the budget is refused before any copy, and
    # the request goes back to QUEUED with no slot
    late = tapi.ServedRequest(rid=7, prompt=prompts[0],
                              sampling=tapi.SamplingParams(
                                  max_new_tokens=40))
    with pytest.raises(ValueError, match="handoff request 7"):
        sched.admit_external(late, 0, None, None,
                             np.zeros((1, 32), np.int32), 32, prefilled=0)
    assert late.state is tapi.RequestState.QUEUED and late.slot is None
    with pytest.raises(ValueError, match="max_len"):
        sched.submit(prompts[0], tapi.SamplingParams(max_new_tokens=40))
    assert sched.free_slots() == [0] and not sched.has_work


@pytest.mark.parametrize("paged", [False, True], ids=["mono", "paged"])
def test_paged_scheduler_lifts_the_column_capacity(paged):
    """The column-capacity demotion ranks a column over every query row,
    so with it a shared prompt page could depend on the prompt's suffix:
    a paged Scheduler lifts it with a warning, an unpaged one keeps it."""
    _, model, _ = _weights()
    cfg = get_arch("qwen3-1.7b").smoke()
    assert cfg.sla.col_capacity_factor is not None
    if paged:
        with pytest.warns(UserWarning, match="col_capacity_factor"):
            sched = tapi.Scheduler(cfg, model, num_slots=1, max_len=48,
                                   paged=True)
        assert sched.cfg.sla.col_capacity_factor is None
    else:
        sched = tapi.Scheduler(cfg, model, num_slots=1, max_len=48,
                               paged=False)
        assert sched.cfg.sla == cfg.sla
    assert cfg.sla.col_capacity_factor is not None  # the caller's is kept


@pytest.mark.parametrize("flags,mode", [
    (["--paged", "--stream"], "continuous"),
    (["--paged"], "continuous"),
    ([], "continuous")], ids=["paged-stream", "paged", "unpaged"])
def test_serve_cli_continuous_matches_reference_cli(tmp_path, capsys, flags,
                                                    mode):
    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve as torch_serve
    argv = ["--arch", "qwen3-1.7b", "--smoke", "--requests", "3",
            "--batch", "2", "--prompt-len", "32", "--max-new", "5",
            "--scheduler", "continuous", "--decode-sla",
            "--backend", "kernel"] + flags
    done = torch_serve.main(argv + ["--device", "cpu", "--stats-json",
                                    str(tmp_path / "t.json")])
    out = capsys.readouterr().out
    jax_serve.main(argv + ["--backend", "gather", "--stats-json",
                           str(tmp_path / "j.json")])
    jout = capsys.readouterr().out
    t = json.loads((tmp_path / "t.json").read_text())
    j = json.loads((tmp_path / "j.json").read_text())
    assert t["mode"] == j["mode"] == mode
    assert set(t["stats"]) == set(j["stats"])
    assert [set(r) for r in t["requests"]] == [set(r) for r in j["requests"]]
    for name, want in j["stats"].items():
        if name not in TIMES + ("decode_last_retention",):
            assert t["stats"][name] == want, name
    assert [len(r.tokens_out) for r in done] == [5] * 3
    for line in ("paged KV:", "decode plans:", "scheduler:"):
        assert (line in out) == (line in jout), line
    if "--stream" in flags:
        assert out.count("token[") == jout.count("token[") == 15
