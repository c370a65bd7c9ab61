"""The static LM serving engine and the LM serve CLI, port against JAX.

`repro_torch.serving.engine.ServingEngine` is held to
`repro.serving.engine.ServingEngine` on the smoke qwen3-1.7b with
JAX-initialized weights (`sla_proj` drawn again) carried over by
`bridge.params_from_numpy`, in the engines' bf16 compute, with decode-time
SLA on and off and prefill plan reuse off and adaptive: every ServeStats
counter equal, the first-token logits within 5e-2 x max(1, max |logits|)
(bf16), and the greedy tokens equal on a seed whose first-token top-2
margins exceed twice the measured difference of the two packages' logits. Then the port's serve CLI runs the LM workload
on the CPU (`--workload lm --smoke --device cpu --decode-sla --backend
kernel`) with the reference CLI's counters, and the CLI's LM modes and
argument rules.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import transformer as jtfm
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.models import transformer as ttfm
from repro_torch.serving.engine import Request, ServingEngine

PLEN, MAX_NEW = 48, (20, 14, 20, 14)
BF16_TOL = 5e-2
COUNTERS = ("prefill_tokens", "decode_tokens", "plan_builds", "plan_replans",
            "plan_reuses", "decode_plan_builds", "decode_plan_extends",
            "decode_plan_replans", "decode_plan_reuses", "admissions",
            "slot_steps_active", "slot_steps_total")


def _setup():
    jcfg = jax_get_arch("qwen3-1.7b").smoke()
    tcfg = get_arch("qwen3-1.7b").smoke()
    params = jtfm.init(jax.random.PRNGKey(1), jcfg)
    rs = np.random.default_rng(8)
    params["layers"]["sla_proj"] = jnp.asarray(0.1 * rs.standard_normal(
        params["layers"]["sla_proj"].shape, dtype=np.float32))
    model = ttfm.init(None, tcfg, device="cpu")
    model.load_state_dict(bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), device="cpu"))
    prompts = [np.random.default_rng(20 + i).integers(
        0, jcfg.vocab_size, size=PLEN).astype(np.int32) for i in range(4)]
    return jcfg, tcfg, params, model, prompts


_SETUP = []


def _shared():
    if not _SETUP:
        _SETUP.append(_setup())
    return _SETUP[0]


ENGINES = [(True, "off", "kernel"), (True, "adaptive", "gather"),
           (False, "off", "gather"), (False, "adaptive", "gather")]


@pytest.mark.parametrize("decode_sla,plan_reuse,backend", ENGINES,
                         ids=[f"sla{int(a)}-{b}-{c}" for a, b, c in ENGINES])
def test_static_engine_matches_jax_engine(decode_sla, plan_reuse, backend):
    jcfg, tcfg, params, model, prompts = _shared()
    kw = dict(batch_size=2, max_len=PLEN + max(MAX_NEW) + 8,
              backend=backend, plan_reuse=plan_reuse, decode_sla=decode_sla)
    jeng, teng = JEngine(jcfg, params, **kw), ServingEngine(tcfg, model, **kw)
    jdone = jeng.run([JRequest(rid=i, prompt=p, max_new_tokens=m)
                      for i, (p, m) in enumerate(zip(prompts, MAX_NEW))])
    tdone = teng.run([Request(rid=i, prompt=p, max_new_tokens=m)
                      for i, (p, m) in enumerate(zip(prompts, MAX_NEW))])
    for name in COUNTERS:
        assert getattr(teng.stats, name) == getattr(jeng.stats, name), name
    if decode_sla:
        assert teng.stats.decode_plan_extends == 2 * tcfg.num_layers
        assert abs(teng.stats.decode_last_retention
                   - jeng.stats.decode_last_retention) <= 1e-4
    # first-token logits of the first group, in the engines' bf16 compute
    toks = np.stack(prompts[:2])
    jlast = jeng._prefill(params, jnp.asarray(toks))[0] \
        if plan_reuse == "off" else jeng._prefill_plan(
            params, jnp.asarray(toks))[0]
    jlogits = np.asarray(jnp.einsum("bd,vd->bv", jlast.astype(jnp.float32),
                                    params["embed"]))
    with torch.no_grad():
        tlast = teng._prefill(teng._cparams, torch.from_numpy(toks).long())[0]
        tlogits = (tlast.float() @ model.embed.t()).numpy()
    limit = BF16_TOL * max(1.0, float(np.abs(jlogits).max()))
    noise = float(np.abs(tlogits - jlogits).max())
    assert noise <= limit
    # greedy tokens can agree only where the top-2 margin beats the
    # measured bf16 difference of the two packages: this seed's does
    top2 = np.sort(jlogits, axis=-1)[:, -2:]
    assert float((top2[:, 1] - top2[:, 0]).min()) > 2 * noise
    for t, j in zip(tdone, jdone):
        assert t.tokens_out == j.tokens_out, t.rid
        assert len(t.tokens_out) == t.max_new_tokens
        assert t.metrics.latency_s is not None


def test_engine_rejects_unported_modes():
    """Chunked admission is ported (tests/test_torch_chunked_prefill.py)
    and refused as in the reference: the static engine has no decode to
    interleave chunks with, and the continuous one needs a paged cache.
    The continuous scheduler is ported (a paged cache without it is
    refused as in the reference), and the engine's continuous wrapper
    serves the static engine's tokens on a trace whose groups do not
    mix."""
    _, tcfg, _, model, prompts = _shared()
    with pytest.raises(ValueError, match="continuous-batching"):
        ServingEngine(tcfg, model, paged=True)
    with pytest.raises(ValueError, match="paged=True"):
        ServingEngine(tcfg, model, scheduler="continuous",
                      prefill_chunk_blocks=2)
    runs = {}
    for scheduler in ("static", "continuous"):
        eng = ServingEngine(tcfg, model, batch_size=2, max_len=64,
                            decode_sla=True, backend="kernel",
                            scheduler=scheduler,
                            paged=scheduler == "continuous")
        runs[scheduler] = eng.run([
            Request(rid=i, prompt=p[:32], max_new_tokens=4)
            for i, p in enumerate(prompts[:2])])
    assert [r.tokens_out for r in runs["continuous"]] == \
        [r.tokens_out for r in runs["static"]]
    with pytest.raises(ValueError, match="continuous-batching"):
        ServingEngine(dataclasses.replace(tcfg, sla=dataclasses.replace(
            tcfg.sla, prefill_chunk_blocks=2)), model)
    with pytest.raises(ValueError, match="plan_reuse"):
        ServingEngine(tcfg, model, plan_reuse="sometimes")
    eng = ServingEngine(tcfg, model, max_len=40, decode_sla=True)
    assert eng.max_len == 48  # rounded up to the block grid
    with pytest.raises(ValueError, match="max_len"):
        eng.run([Request(rid=0, prompt=np.zeros(40, np.int32),
                         max_new_tokens=9)])


def test_serve_cli_lm_workload_matches_reference_cli(tmp_path):
    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve as torch_serve
    argv = ["--workload", "lm", "--arch", "qwen3-1.7b", "--smoke",
            "--requests", "2", "--batch", "2", "--prompt-len", "32",
            "--max-new", "4", "--decode-sla", "--backend", "kernel"]
    done = torch_serve.main(argv + ["--device", "cpu", "--stats-json",
                                    str(tmp_path / "t.json")])
    jax_serve.main(argv + ["--stats-json", str(tmp_path / "j.json")])
    t = json.loads((tmp_path / "t.json").read_text())
    j = json.loads((tmp_path / "j.json").read_text())
    for name in ("prefill_tokens", "decode_tokens", "admissions",
                 "decode_plan_builds", "decode_plan_extends",
                 "slot_steps_active", "slot_steps_total"):
        assert t["stats"][name] == j["stats"][name], name
    assert t["stats"]["decode_plan_replans"] + \
        t["stats"]["decode_plan_reuses"] == 2  # one boundary x 2 layers
    assert [len(r.tokens_out) for r in done] == [4, 4]
    assert [r["state"] for r in t["requests"]] == ["finished"] * 2


@pytest.mark.parametrize("flags", [["--scheduler", "continuous"],
                                   ["--paged"], ["--prefill-chunk", "2"],
                                   ["--disagg"], ["--stream"]],
                         ids=lambda f: f[0])
def test_serve_cli_unported_lm_modes_name_item_14(flags):
    """Every LM mode of the reference CLI is ported (item 14 is done):
    --scheduler continuous and --disagg serve, and --paged / --stream /
    --prefill-chunk without what they need (the continuous scheduler or
    the disaggregated pools, a paged cache) are refused with the
    reference CLI's argument error, as are --disagg with --stream and
    --disagg with adaptive plan reuse (--prefill-chunk with --paged
    serves: tests/test_torch_chunked_prefill.py; --disagg against the
    reference CLI: tests/test_torch_disagg.py)."""
    from repro_torch.launch import serve as torch_serve
    argv = ["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
            "--requests", "2", "--batch", "2", "--prompt-len", "16",
            "--max-new", "3"] + flags
    if flags[0] == "--disagg":
        done = torch_serve.main(argv)
        assert [len(r.tokens_out) for r in done] == [3, 3]
        for extra in (["--stream"], ["--plan-reuse", "adaptive"]):
            with pytest.raises(SystemExit):
                torch_serve.main(argv + extra)
    elif flags[0] == "--scheduler":
        done = torch_serve.main(argv)
        assert [len(r.tokens_out) for r in done] == [3, 3]
    else:
        with pytest.raises(SystemExit):
            torch_serve.main(argv)


def test_engine_group_accounting_counts_each_request():
    """The engine's slot accounting and per-request metrics on a partial
    last group (3 requests, groups of 2)."""
    _, tcfg, _, model, prompts = _shared()
    eng = ServingEngine(tcfg, model, batch_size=2, max_len=64,
                        decode_sla=True, backend="kernel")
    done = eng.run([Request(rid=i, prompt=p[:32], max_new_tokens=3)
                    for i, p in enumerate(prompts[:3])])
    assert [len(r.tokens_out) for r in done] == [3, 3, 3]
    assert eng.stats.admissions == 3
    assert eng.stats.decode_tokens == 3 * 2
    assert eng.stats.slot_steps_total == 2 * 2 * 2
    assert eng.stats.decode_plan_builds == 2 * tcfg.num_layers
    assert all(r.metrics.ttft_s is not None for r in done)
    assert dataclasses.asdict(eng.stats)["prefill_tokens"] == 3 * 32
