"""The disaggregated trace replay, port against JAX.

The reference's slow trace (`tests/test_disagg.py::
test_trace_replay_mixed_faults_paged_chunked_decode_sla`) on both
packages: paged decode workers, chunked prefill (one block a chunk),
decode-time SLA, staggered arrivals (four requests, three ticks, four
more), and a fault trace mixing a flake (decode:1, tick 2), a straggle
(decode:2, x10, tick 4) and a kill (decode:0, tick 6), with 2 prefill and
3 decode workers of 2 slots, the reference's weights carried across by
`bridge.py`, f32 compute and the reference test's virtual clock. The
config is chunk-eligible (column capacity None), so the port's paged
workers lift nothing. The reference runs once (gather backend); the port
runs its gather backend and its kernel backend (the kernels' plain
twins). Greedy tokens, every `DisaggStats` counter but `prefill_s`,
`pool_stats()`, occupancies and every stream event must equal the
reference's, and the tokens equal the port's own paged single Scheduler
run. A file of its own, so that `--dist loadfile` runs it beside
`tests/test_torch_disagg.py`.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.distributed import fault_tolerance as jft
from repro.models import transformer as jtfm
from repro.serving import api as japi
from repro.serving import disagg as jdis
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.distributed import fault_tolerance as tft
from repro_torch.models import transformer as ttfm
from repro_torch.serving import api as tapi
from repro_torch.serving import disagg as tdis

LENS = (32, 20, 24, 16, 28, 32, 18, 24)
BUDGETS = (6, 9, 4, 7, 5, 8, 6, 4)
FAULTS = (dict(tick=2, kind="flake", pool="decode", worker=1, failures=1),
          dict(tick=4, kind="straggle", pool="decode", worker=2,
               factor=10.0),
          dict(tick=6, kind="kill", pool="decode", worker=0))
PKG = {"jax": (japi, jdis, jft, jnp.float32),
       "torch": (tapi, tdis, tft, torch.float32)}


def _cfg(get):
    cfg = get("qwen3-1.7b").smoke()
    return dataclasses.replace(cfg, sla=cfg.sla.replace(
        kh_frac=0.25, kl_frac=0.0, decode_mode="sla",
        col_capacity_factor=None))


@functools.lru_cache(maxsize=None)
def _weights():
    cfg = _cfg(jax_get_arch)
    params = jtfm.init(jax.random.PRNGKey(0), cfg)
    params["layers"]["sla_proj"] = jax.random.normal(
        jax.random.PRNGKey(7), params["layers"]["sla_proj"].shape) * 0.3
    model = ttfm.init(None, _cfg(get_arch), device="cpu")
    model.load_state_dict(bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), device="cpu"))
    return {"jax": params, "torch": model}


def _prompts(vocab):
    rs = np.random.default_rng(3)
    return [rs.integers(0, vocab, size=n).astype(np.int32) for n in LENS]


class TickClock:
    """Every call advances 0.5 s (the reference test's clock)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.5
        return self.t


@functools.lru_cache(maxsize=None)
def _replay(pkg, backend):
    api, dis_mod, ft, dt = PKG[pkg]
    cfg = _cfg(jax_get_arch if pkg == "jax" else get_arch)
    plan = ft.FaultPlan([ft.FaultEvent(**e) for e in FAULTS])
    dis = dis_mod.DisaggScheduler(
        cfg, _weights()[pkg], prefill_workers=2, decode_workers=3,
        slots_per_worker=2, max_len=128, backend=backend, decode_sla=True,
        prefill_bucket=32, paged=True, prefill_chunk_blocks=1,
        decode_step_mode="token", fault_plan=plan,
        watchdog=ft.StragglerWatchdog(threshold=2.0, warmup=3),
        clock=TickClock(), sleep=lambda s: None, max_requeues=2,
        compute_dtype=dt)
    prompts = _prompts(cfg.vocab_size)
    events = []
    for p, b in zip(prompts[:4], BUDGETS[:4]):
        dis.submit(p, api.SamplingParams(max_new_tokens=b))
    for _ in range(3):
        events += dis.tick()
    for p, b in zip(prompts[4:], BUDGETS[4:]):
        dis.submit(p, api.SamplingParams(max_new_tokens=b))
    while dis.has_work:
        events += dis.tick()
    stats = dataclasses.asdict(dis.stats)
    stats.pop("prefill_s")
    return dict(tokens=[list(r.tokens_out) for r in dis._requests],
                stats=stats, pool=dis.pool_stats(),
                occupancy=(dis.decode_occupancy(),
                           dis.stats.prefill_occupancy()),
                events=[(e.rid, e.kind, e.token, e.index) for e in events])


@pytest.mark.parametrize("backend", ["gather", "kernel"])
def test_trace_replay_mixed_faults_matches_reference(backend):
    want = _replay("jax", "gather")
    got = _replay("torch", backend)
    assert got == want
    st = got["stats"]
    assert st["completed"] == st["submitted"] == len(LENS)
    assert st["kills"] == 1 and st["requeues"] >= 1
    assert st["retries"] >= 1 and st["straggler_drains"] == 1
    assert 0.0 < got["occupancy"][0] <= 1.0
    assert 0.0 < got["occupancy"][1] <= 1.0
    # and the port's own undisturbed paged single Scheduler
    sched = tapi.Scheduler(_cfg(get_arch), _weights()["torch"], num_slots=2,
                           max_len=128, backend=backend, decode_sla=True,
                           prefill_bucket=32, paged=True,
                           compute_dtype=torch.float32)
    for p, b in zip(_prompts(sched.cfg.vocab_size), BUDGETS):
        sched.submit(p, tapi.SamplingParams(max_new_tokens=b))
    assert [list(r.tokens_out) for r in sched.drain()] == got["tokens"]
