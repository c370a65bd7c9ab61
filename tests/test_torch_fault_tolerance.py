"""Fault-tolerance primitives, port against JAX.

`repro_torch.distributed.fault_tolerance` against
`repro.distributed.fault_tolerance` on the same scripted inputs, each
result compared exactly: `FaultEvent`'s validation (the same errors and
messages), `FaultPlan`'s (tick, pool, worker, kind) order, consumption
and late catch-up, and `run_with_retries`' backoff schedule
min(2**attempt, 10), `on_retry` arguments, no sleep after the last
failure and the uncaught `ValueError`. Then the port's one difference by
design: `retry_on` narrows what is retried, so a real step's
`RuntimeError` is raised at once while an `InjectedFault` is retried.
"""
import pytest

from repro.distributed import fault_tolerance as jft
from repro_torch.distributed import fault_tolerance as tft

EVENTS = [dict(tick=5, kind="kill", pool="decode", worker=1),
          dict(tick=2, kind="straggle", pool="decode", worker=0, factor=4.0),
          dict(tick=5, kind="flake", pool="prefill", worker=0, failures=2),
          dict(tick=5, kind="straggle", pool="decode", worker=1),
          dict(tick=3, kind="kill", pool="prefill", worker=1)]


def _both(fn):
    """fn(module) for both packages; returns (torch result, jax result)."""
    return fn(tft), fn(jft)


def _key(e):
    return (e.tick, e.kind, e.pool, e.worker, e.factor, e.failures)


def test_fault_kinds_and_pools_match():
    assert tft.FAULT_KINDS == jft.FAULT_KINDS == ("kill", "straggle",
                                                   "flake")
    assert tft.FAULT_POOLS == jft.FAULT_POOLS == ("prefill", "decode")


@pytest.mark.parametrize("bad", [
    dict(tick=1, kind="explode", pool="decode", worker=0),
    dict(tick=1, kind="kill", pool="gpu", worker=0),
    dict(tick=-1, kind="kill", pool="decode", worker=0)],
    ids=["kind", "pool", "tick"])
def test_fault_event_validation_matches(bad):
    msgs = []
    for mod in (tft, jft):
        with pytest.raises(ValueError) as exc:
            mod.FaultEvent(**bad)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
    ok = {**bad, "tick": 1, "kind": "kill", "pool": "decode"}
    t, j = _both(lambda mod: _key(mod.FaultEvent(**ok)))
    assert t == j


def test_fault_plan_order_and_consumption_match():
    """Ticks 0..6 popped one by one: the same events in the same order
    (multi-fault tick 5 by pool, worker, kind), each once."""
    def run(mod):
        plan = mod.FaultPlan([mod.FaultEvent(**e) for e in EVENTS])
        out = []
        for tick in range(7):
            out.append([_key(e) for e in plan.due(tick)])
            out.append(plan.exhausted)
            out.append([_key(e) for e in plan.pending])
        out.append([_key(e) for e in plan.fired])
        return out
    t, j = _both(run)
    assert t == j
    assert t[-1][-3:] == [(5, "kill", "decode", 1, 1.0, 1),
                          (5, "straggle", "decode", 1, 1.0, 1),
                          (5, "flake", "prefill", 0, 1.0, 2)]


def test_fault_plan_late_due_catches_up_skipped_ticks():
    def run(mod):
        plan = mod.FaultPlan([mod.FaultEvent(**e) for e in EVENTS])
        return ([_key(e) for e in plan.due(4)],
                [_key(e) for e in plan.due(100)], plan.exhausted,
                plan.due(101))
    t, j = _both(run)
    assert t == j
    assert [k[0] for k in t[0]] == [2, 3] and len(t[1]) == 3


@pytest.mark.parametrize("max_retries", [0, 1, 2, 6])
def test_backoff_schedule_and_final_raise_match(max_retries):
    """Always failing: min(2**a, 10) after each failed attempt but the
    last, which raises; on_retry sees (attempt, exception)."""
    def run(mod):
        sleeps, seen, calls = [], [], [0]

        def always_fails():
            calls[0] += 1
            raise RuntimeError(f"transient {calls[0]}")

        with pytest.raises(RuntimeError, match="transient") as exc:
            mod.run_with_retries(always_fails, max_retries=max_retries,
                                 on_retry=lambda a, e: seen.append(
                                     (a, str(e))),
                                 sleep=sleeps.append)
        return sleeps, seen, calls[0], str(exc.value)
    t, j = _both(run)
    assert t == j
    assert t[0] == [min(2.0 ** a, 10.0) for a in range(max_retries)]
    assert t[2] == max_retries + 1


def test_recovery_and_on_retry_arguments_match():
    def run(mod):
        seen, calls = [], [0]

        def flaky():
            calls[0] += 1
            if calls[0] < 3:
                raise RuntimeError(f"boom {calls[0]}")
            return "ok"

        out = mod.run_with_retries(
            flaky, max_retries=3,
            on_retry=lambda a, e: seen.append((a, str(e))),
            sleep=lambda s: None)
        return out, seen, calls[0]
    t, j = _both(run)
    assert t == j == ("ok", [(0, "boom 1"), (1, "boom 2")], 3)


def test_value_error_is_not_retried_in_either():
    def run(mod):
        sleeps, calls = [], [0]

        def typo():
            calls[0] += 1
            raise ValueError("not a runtime fault")

        with pytest.raises(ValueError):
            mod.run_with_retries(typo, max_retries=5, sleep=sleeps.append)
        return sleeps, calls[0]
    t, j = _both(run)
    assert t == j == ([], 1)


def test_real_step_error_is_not_retried_when_narrowed():
    """The serving harness passes retry_on=(InjectedFault,): a step that
    wrote state and then failed (a RuntimeError, as a CUDA launch error
    or an out-of-memory error is) raises at once, with no retry and no
    sleep; an injected fault, raised before the step runs, is still
    retried on the same schedule as a RuntimeError by default."""
    state = {"pos": 0}
    sleeps = []

    def step():
        state["pos"] += 1  # the write a retry would repeat
        raise RuntimeError("CUDA error: an illegal memory access")

    with pytest.raises(RuntimeError, match="illegal memory"):
        tft.run_with_retries(step, max_retries=3, sleep=sleeps.append,
                             retry_on=(tft.InjectedFault,))
    assert state["pos"] == 1 and sleeps == []

    calls = [0]

    def flaky():
        calls[0] += 1
        if calls[0] < 3:
            raise tft.InjectedFault("injected transient fault")
        return "ok"

    assert tft.run_with_retries(flaky, max_retries=3, sleep=sleeps.append,
                                retry_on=(tft.InjectedFault,)) == "ok"
    assert sleeps == [1.0, 2.0]
    assert issubclass(tft.InjectedFault, RuntimeError)


def test_watchdog_and_nan_guard_match():
    """The primitives the harness composes with the plan: the same
    flags, EMA and strikes on one scripted sequence."""
    times = [0.5, 0.5, 0.5, 5.0, 0.6, 2.0, 0.4, 9.0]

    def run(mod):
        wd = mod.StragglerWatchdog(threshold=2.0, warmup=3)
        flags = [wd.record(t, host_id=i % 2) for i, t in enumerate(times)]
        guard = mod.NaNGuard(max_strikes=2)
        checks = [guard.check(x) for x in (1.0, float("nan"), 2.0)]
        return flags, round(wd.ema, 12), wd.flagged, checks, guard.strikes
    t, j = _both(run)
    assert t == j
    assert t[0] == [False] * 3 + [True, False, True, False, True]
