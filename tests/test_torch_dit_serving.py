"""The port's streaming DiT service against the JAX one, and against its
own sequential sampler.

* Port `DiffusionScheduler` final latents match the JAX
  `DiffusionScheduler` on the same bridged weights and the same
  mixed-timestep trace (2 slots; t_start 1.0 / 0.75 / 0.5): atol = rtol =
  1e-4, with equal plan counters.
* Port batched == port sequential `dit.sample(..., t_start=)` per request
  within 1e-5: unlike XLA on the CPU, torch's GEMMs may block a batch-2
  product differently from a batch-1 one, so rows agree to f32 noise
  rather than bitwise.
* With the plan cache on, the reference's drift-parity test: cached-plan
  latents equal fresh-plan latents within the conformance f32 tolerance,
  and the port's counters equal the reference's.
* The serve CLI drives the same requests as the reference's, with and
  without `--plan-cache`.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.configs import get_arch as jax_get_arch
from repro.models import dit as jdit
from repro.serving.diffusion import DenoiseParams as JaxDenoiseParams
from repro.serving.diffusion import DiffusionScheduler as JaxScheduler
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.models import dit as tdit
from repro_torch.serving.api import RequestState, percentile
from repro_torch.serving.diffusion import DenoiseParams, DiffusionScheduler

TOL = dict(atol=1e-4, rtol=1e-4)
SEQ = 128  # 8 blocks of 16: enough structure for plans to drift
TRACE = ((4, 1.0), (3, 1.0), (5, 0.75), (2, 0.5))
COUNTERS = ("admissions", "denoise_steps", "plan_builds", "plan_replans",
            "plan_reuses", "slot_steps_active", "slot_steps_total")
CACHE_COUNTERS = ("plan_cache_hits", "plan_cache_misses",
                  "plan_cache_invalidations", "plan_cache_evictions")


def _models(arch):
    jcfg, tcfg = jax_get_arch(arch).smoke(), get_arch(arch).smoke()
    rs = np.random.default_rng(1)
    tree = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rs.standard_normal(a.shape))
        .astype(np.float32), jdit.init(jax.random.PRNGKey(0), jcfg))
    model = tdit.init(None, tcfg, device="cpu")
    model.load_state_dict(bridge.params_from_numpy(tree, device="cpu"))
    return jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree), model


@pytest.fixture(scope="module", params=["lightningdit_1b", "wan2_1_1_3b"])
def models(request):
    return _models(request.param)


def _requests(cfg):
    rs = np.random.default_rng(5)
    out = []
    for steps, t0 in TRACE:
        lat = rs.standard_normal((SEQ, cfg.patch_dim), dtype=np.float32)
        cond = (rs.standard_normal((cfg.cond_len, cfg.d_model),
                                   dtype=np.float32)
                if cfg.cross_attn else None)
        out.append((steps, t0, lat, cond))
    return out


def _run(sched, reqs, params_cls):
    for steps, t0, lat, cond in reqs:
        sched.submit(lat, params_cls(num_steps=steps, t_start=t0), cond=cond)
    mixed = 0
    while sched.has_work:
        sched.step()
        live = [t for t in sched.active_timesteps() if t is not None]
        mixed += len(set(live)) >= 2
    assert mixed >= 1  # the trace really mixed timesteps in one batch
    return sched


@pytest.mark.parametrize("backend,mode", [("kernel", "fixed"),
                                          ("kernel", "adaptive"),
                                          ("gather", "adaptive")])
def test_scheduler_matches_jax_scheduler(models, backend, mode):
    jcfg, tcfg, jparams, model = models
    reqs = _requests(tcfg)
    kw = dict(num_slots=2, seq_len=SEQ, backend=backend,
              refresh_mode=mode, refresh_interval=2, drift_threshold=0.25)
    js = _run(JaxScheduler(jcfg, jparams, compute_dtype=jnp.float32, **kw),
              reqs, JaxDenoiseParams)
    ts = _run(DiffusionScheduler(tcfg, model, compute_dtype=torch.float32,
                                 device="cpu", **kw), reqs, DenoiseParams)
    for a, b in zip(ts._requests, js._requests):
        assert a.state == RequestState.FINISHED
        assert a.result.shape == (SEQ, tcfg.patch_dim)
        np.testing.assert_allclose(a.result, b.result, **TOL,
                                   err_msg=f"rid {a.rid}")
    for name in COUNTERS:
        assert getattr(ts.stats, name) == getattr(js.stats, name), name
    assert 0 < ts.stats.plan_replans  # the trace really re-planned
    if mode == "adaptive":  # ... on data-dependent decisions
        assert 0 < ts.stats.plan_reuses


@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_batched_matches_sequential_sample(models, mode):
    _, tcfg, _, model = models
    reqs = _requests(tcfg)
    ts = _run(DiffusionScheduler(tcfg, model, num_slots=2, seq_len=SEQ,
                                 backend="kernel", refresh_mode=mode,
                                 refresh_interval=2, drift_threshold=0.25,
                                 device="cpu"), reqs, DenoiseParams)
    for r, (steps, t0, lat, cond) in zip(ts._requests, reqs):
        ref = tdit.sample(
            model, tcfg, torch.from_numpy(lat[None]), num_steps=steps,
            cond=None if cond is None else torch.from_numpy(cond[None]),
            compute_dtype=torch.float32, backend="kernel",
            refresh_mode=mode, refresh_interval=2, drift_threshold=0.25,
            t_start=t0)
        np.testing.assert_allclose(r.result, ref[0].numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=f"rid {r.rid}")
    assert ts.stats.admissions == len(TRACE)
    assert ts.stats.denoise_steps == sum(s for s, _ in TRACE)


def test_events_metrics_and_validation():
    _, tcfg, _, model = _models("lightningdit_1b")
    sched = DiffusionScheduler(tcfg, model, num_slots=1, seq_len=SEQ,
                               backend="kernel", device="cpu")
    lat = np.zeros((SEQ, tcfg.patch_dim), np.float32)
    sched.submit(lat, DenoiseParams(num_steps=3))
    sched.submit(lat, DenoiseParams(num_steps=2))
    r0, r1 = sched._requests
    assert r1.metrics.latency_s is None and r1.metrics.queue_s is None
    events = list(sched.stream())
    for r in (r0, r1):
        kinds = [e.kind for e in events if e.rid == r.rid]
        assert kinds == ["start"] + ["step"] * r.params.num_steps \
            + ["finish"]
        assert r.metrics.latency_s > 0 and r.metrics.decode_tokens == \
            r.params.num_steps
    assert r1.metrics.queue_s > 0
    with pytest.raises(ValueError, match="latent shape"):
        sched.submit(np.zeros((SEQ + 1, tcfg.patch_dim), np.float32))
    with pytest.raises(ValueError, match="cross-attention"):
        sched.submit(lat, cond=np.zeros((4, tcfg.d_model), np.float32))
    with pytest.raises(ValueError, match="t_start"):
        DenoiseParams(t_start=1.5).validate()
    with pytest.raises(ValueError, match="multiple"):
        DiffusionScheduler(tcfg, model, seq_len=SEQ + 1, device="cpu")
    with pytest.raises(ValueError, match="t_buckets"):
        DiffusionScheduler(tcfg, model, seq_len=SEQ, plan_cache=True,
                           t_buckets=0, device="cpu")
    with pytest.raises(ValueError, match="max_entries"):
        DiffusionScheduler(tcfg, model, seq_len=SEQ, plan_cache=True,
                           cache_entries=tcfg.num_layers - 1, device="cpu")
    with pytest.raises(ValueError, match="unknown SLA backend"):
        DiffusionScheduler(tcfg, model, seq_len=SEQ, backend="nope",
                           device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DiffusionScheduler(tcfg, model, seq_len=SEQ)
    assert percentile([3, 1, 2, 4], 0.5) == 2
    with pytest.raises(ValueError):
        percentile([], 0.5)


def _cli_pair(tmp_path, extra=()):
    """`--workload dit` on the port (kernel backend) and on the
    reference (gather): same flags, same seeded requests, the same
    counters. Returns the port's --stats-json payload."""
    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve as torch_serve
    argv = ["--workload", "dit", "--arch", "lightningdit_1b", "--smoke",
            "--requests", "3", "--batch", "2", "--num-steps", "3",
            "--t-start", "0.75", "--refresh-mode", "adaptive",
            "--drift-threshold", "0.3", *extra]
    done = torch_serve.main(argv + ["--device", "cpu", "--backend",
                                    "kernel", "--stats-json",
                                    str(tmp_path / "t.json")])
    jax_serve.main(argv + ["--backend", "gather", "--stats-json",
                           str(tmp_path / "j.json")])
    assert [r.state for r in done] == [RequestState.FINISHED] * 3
    t = json.loads((tmp_path / "t.json").read_text())
    j = json.loads((tmp_path / "j.json").read_text())
    for name in COUNTERS + CACHE_COUNTERS:
        assert t["stats"][name] == j["stats"][name], name
    assert [r["state"] for r in t["requests"]] == ["finished"] * 3
    return t


def test_serve_cli_matches_reference_cli(tmp_path):
    """`--workload dit` on the port and on the reference: the same
    scheduler counters."""
    from repro_torch.launch import serve as torch_serve
    t = _cli_pair(tmp_path)
    assert t["stats"]["plan_cache_misses"] == 0  # no cache without the flag
    # the LM workload (the default) refuses a DiT arch, as the reference
    with pytest.raises(SystemExit):
        torch_serve.main(["--arch", "lightningdit_1b", "--smoke",
                          "--device", "cpu"])
    # so does the continuous LM scheduler (as the reference CLI)
    with pytest.raises(SystemExit):
        torch_serve.main(["--arch", "lightningdit_1b", "--smoke",
                          "--device", "cpu", "--scheduler", "continuous"])


def test_serve_cli_plan_cache_matches_reference_cli(tmp_path, capsys):
    """`--plan-cache --t-buckets 8 --cache-entries 256` on both CLIs: the
    same plan-cache counters and the same summary line."""
    t = _cli_pair(tmp_path, ["--plan-cache", "--t-buckets", "8",
                             "--cache-entries", "256"])
    st = t["stats"]
    assert (st["plan_cache_hits"], st["plan_cache_misses"]) == (2, 1)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("plan cache:")]
    assert len(lines) == 2 and lines[0] == lines[1]


def test_plan_cache_drift_parity_and_counters():
    """The reference's `test_plan_cache_drift_parity_and_counters` on the
    port, with the reference's weights (`dit.init(PRNGKey(0))`, bridged)
    and latents: cached-plan outputs equal fresh-plan outputs within the
    conformance f32 tolerance, and the port's counters equal the JAX
    scheduler's with the cache off and on."""
    jcfg = jax_get_arch("lightningdit_1b").smoke()
    tcfg = get_arch("lightningdit_1b").smoke()
    jparams = jdit.init(jax.random.PRNGKey(0), jcfg)
    model = tdit.init(None, tcfg, device="cpu")
    model.load_state_dict(bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu"))
    seq = 32
    lats = [np.asarray(jax.random.normal(jax.random.PRNGKey(i + 1),
                                         (seq, tcfg.patch_dim), jnp.float32))
            for i in range(5)]
    kw = dict(num_slots=2, seq_len=seq, backend="gather",
              refresh_mode="adaptive", drift_threshold=0.3)

    def drain(sched, params_cls):
        for lat in lats:
            sched.submit(lat, params_cls(num_steps=3))
        sched.drain()
        return sched

    def port(cache):
        return drain(DiffusionScheduler(
            tcfg, model, compute_dtype=torch.float32, plan_cache=cache,
            device="cpu", **kw), DenoiseParams)

    def ref(cache):
        return drain(JaxScheduler(jcfg, jparams, compute_dtype=jnp.float32,
                                  plan_cache=cache, **kw), JaxDenoiseParams)

    off, on = port(False), port(True)
    for a, b in zip(off._requests, on._requests):
        np.testing.assert_allclose(a.result, b.result, atol=5e-5, rtol=5e-5)
    st = on.stats
    assert st.plan_cache_misses >= 1 and st.plan_cache_hits >= 1
    assert st.plan_cache_hits + st.plan_cache_misses == 5
    assert st.plan_builds < off.stats.plan_builds
    assert off.stats.plan_cache_hits == 0 and off.cache is None
    for mine, theirs in ((off, ref(False)), (on, ref(True))):
        for name in COUNTERS + CACHE_COUNTERS:
            assert getattr(mine.stats, name) == \
                getattr(theirs.stats, name), name
