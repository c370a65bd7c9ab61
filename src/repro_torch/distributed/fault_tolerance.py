"""Fault tolerance: straggler watchdog, non-finite-loss guard, retryable
step execution and the scripted fault plans of disaggregated serving.
Counterpart of `repro.distributed.fault_tolerance`.

  * `StragglerWatchdog`: per-step wall times tracked with an EMA; a step
    slower than `threshold x EMA` is flagged with its host id, so a
    scheduler can drain the slow worker;
  * `NaNGuard`: skips an update with a non-finite loss and raises after
    `max_strikes` in a row;
  * `run_with_retries`: one step, retried on transient errors with the
    backoff min(2**attempt, 10) seconds (`sleep` injectable);
  * `FaultEvent` / `FaultPlan`: the deterministic injection side of the
    same contract. The disaggregated serving harness
    (`serving/disagg.py`) consumes a scripted schedule of kill / straggle
    / flake events, so that worker loss, drain and requeue run the same
    way in every run.

The reference retries on any `RuntimeError`, which is safe there because
a failed jitted step commits nothing. A step of the port writes its
state in place before it can fail (a CUDA launch error and
`torch.OutOfMemoryError` are `RuntimeError`s), so the serving harness
retries only its own injected flakes (`InjectedFault`, through
`retry_on`) and lets a real step's error through.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch

FAULT_KINDS = ("kill", "straggle", "flake")
FAULT_POOLS = ("prefill", "decode")


class InjectedFault(RuntimeError):
    """The transient error a scripted flake raises before its step runs
    (so nothing was written and a retry is safe)."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scripted fault: at scheduler tick `tick`, do `kind` to worker
    `worker` of pool `pool`.

    kind == "kill":     the worker dies; its in-flight work must be
                        requeued (or the loss surfaced loudly).
    kind == "straggle": the worker's measured tick durations are
                        multiplied by `factor` from then on, so the
                        StragglerWatchdog sees a slow host.
    kind == "flake":    the worker's next `failures` ticks raise a
                        transient `InjectedFault` (absorbed by
                        run_with_retries).
    """
    tick: int
    kind: str
    pool: str
    worker: int
    factor: float = 1.0
    failures: int = 1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        if self.pool not in FAULT_POOLS:
            raise ValueError(f"unknown worker pool {self.pool!r}; "
                             f"expected one of {FAULT_POOLS}")
        if self.tick < 0:
            raise ValueError("fault tick must be >= 0")


class FaultPlan:
    """A deterministic schedule of FaultEvents, popped by tick.

    `due(tick)` returns (and consumes) every event whose tick has arrived,
    in (tick, pool, worker, kind) order, so multi-fault ticks replay
    identically run over run."""

    def __init__(self, events: Sequence[FaultEvent] = ()):
        self._pending: List[FaultEvent] = sorted(
            events, key=lambda e: (e.tick, e.pool, e.worker, e.kind))
        self.fired: List[FaultEvent] = []

    def due(self, tick: int) -> List[FaultEvent]:
        ready = [e for e in self._pending if e.tick <= tick]
        if ready:
            self._pending = [e for e in self._pending if e.tick > tick]
            self.fired.extend(ready)
        return ready

    @property
    def exhausted(self) -> bool:
        return not self._pending

    @property
    def pending(self) -> Tuple[FaultEvent, ...]:
        return tuple(self._pending)


@dataclasses.dataclass
class StragglerWatchdog:
    """EMA-based step-time anomaly detector."""
    threshold: float = 2.0
    decay: float = 0.9
    warmup: int = 5
    ema: float = 0.0
    steps: int = 0
    flagged: List[dict] = dataclasses.field(default_factory=list)

    def record(self, seconds: float, host_id: int = 0) -> bool:
        """Returns True if this step is a straggler."""
        self.steps += 1
        if self.steps <= self.warmup:
            self.ema = seconds if self.ema == 0 else \
                self.decay * self.ema + (1 - self.decay) * seconds
            return False
        slow = seconds > self.threshold * self.ema
        if slow:
            self.flagged.append({"step": self.steps, "host": host_id,
                                 "seconds": seconds, "ema": self.ema})
        else:
            self.ema = self.decay * self.ema + (1 - self.decay) * seconds
        return slow


@dataclasses.dataclass
class NaNGuard:
    """Skips poisoned updates; aborts after `max_strikes` consecutive."""
    max_strikes: int = 3
    strikes: int = 0

    def check(self, loss) -> bool:
        """True -> step is healthy; False -> skip this update."""
        healthy = bool(torch.isfinite(torch.as_tensor(loss)).all())
        if healthy:
            self.strikes = 0
        else:
            self.strikes += 1
            if self.strikes >= self.max_strikes:
                raise FloatingPointError(
                    f"{self.strikes} consecutive non-finite losses — "
                    "aborting for restart from checkpoint")
        return healthy


def run_with_retries(step_fn: Callable, max_retries: int = 2,
                     on_retry: Optional[Callable] = None,
                     sleep: Callable[[float], None] = time.sleep,
                     retry_on: Tuple[type, ...] = (RuntimeError,)):
    """Execute one step, retrying on transient runtime errors (the
    single-process analogue of restart-on-collective-timeout): after
    failed attempt `a` (from 0), `on_retry(a, exc)` is called and
    `sleep(min(2**a, 10))` backs off; the last failure is raised without
    a sleep. `retry_on` names the errors taken as transient (default
    `RuntimeError`, as the reference); anything else propagates at once.

    `sleep` is injectable so fault-injection tests can record the backoff
    schedule instead of waiting for it."""
    for attempt in range(max_retries + 1):
        try:
            return step_fn()
        except retry_on as e:
            if attempt == max_retries:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            sleep(min(2.0 ** attempt, 10.0))
