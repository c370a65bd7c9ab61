"""Training fault tolerance: step-time straggler detection and the
non-finite-loss guard. Counterpart of `repro.distributed.fault_tolerance`
(`StragglerWatchdog`, `NaNGuard`); the serving fault plans arrive with
disaggregated serving (ROADMAP.md queue 1, item 14).
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch


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
