"""Typed request surface shared by the serving schedulers.

Counterpart of the part of `repro.serving.api` the DiT denoise service
uses: the request lifecycle, per-request metrics, stream events, the
scheduler's counters, and the metrics helpers. The LM `Scheduler` and
`PrefillEngine` arrive with the LM serving slice.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional

from repro_torch.configs.base import ArchConfig


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    FINISHED = "finished"


@dataclasses.dataclass
class RequestMetrics:
    """Wall-clock request accounting (absolute times from time.time()).

    Each derived metric is None until the event it measures has happened
    (an unfinished request has no latency, a never-admitted one no queue
    time) — never clamped to 0.0."""

    submit_t: float = 0.0
    admit_t: float = 0.0
    first_token_t: float = 0.0
    finish_t: float = 0.0
    decode_tokens: int = 0  # generated tokens / executed denoise steps

    @property
    def queue_s(self) -> Optional[float]:
        if self.admit_t == 0.0:
            return None
        return self.admit_t - self.submit_t

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_t == 0.0:
            return None
        return self.first_token_t - self.submit_t

    @property
    def latency_s(self) -> Optional[float]:
        if self.finish_t == 0.0:
            return None
        return self.finish_t - self.submit_t


@dataclasses.dataclass
class StreamEvent:
    """One streaming output event: "start" (admitted to a slot), "step"
    (one denoising step; `index` set), "finish"."""

    rid: int
    kind: str
    t: float
    index: Optional[int] = None


@dataclasses.dataclass
class ServeStats:
    """Scheduler counters: the reference's fields that the DiT service
    keeps, under the same names, so the --stats-json payloads of the two
    packages line up. The LM fields arrive with the LM serving slice."""

    decode_s: float = 0.0  # wall time inside batched ticks
    # plan accounting (layer granularity): builds = first plans, replans
    # = drift-triggered rebuilds, reuses = layers served by a kept plan
    plan_builds: int = 0
    plan_replans: int = 0
    plan_reuses: int = 0
    last_retention: float = 1.0
    # continuous batching: active vs total slot-steps
    admissions: int = 0
    slot_steps_active: int = 0
    slot_steps_total: int = 0
    denoise_steps: int = 0  # per-request Euler steps executed

    def occupancy(self) -> float:
        """Slot utilization in [0, 1]."""
        return self.slot_steps_active / max(1, self.slot_steps_total)


def normalize_drift_threshold(cfg: ArchConfig, drift_threshold):
    """CLI/user drift threshold -> scalar or per-layer tuple."""
    if drift_threshold is None:
        return cfg.sla.plan_drift_threshold
    if isinstance(drift_threshold, (tuple, list)):
        return tuple(float(t) for t in drift_threshold)
    return float(drift_threshold)


def percentile(xs, p: float) -> float:
    """Nearest-rank percentile: sorted(xs)[ceil(p * n) - 1]."""
    xs = sorted(xs)
    if not xs:
        raise ValueError("percentile() of an empty sequence")
    rank = min(len(xs), max(1, math.ceil(p * len(xs))))
    return xs[rank - 1]


def stats_json_payload(mode: str, stats, requests=()) -> dict:
    """JSON-ready dump of a stats dataclass + per-request metrics
    (`launch/serve.py --stats-json`). Derived metrics of in-flight
    requests stay None (JSON null)."""
    rows = []
    for r in requests:
        m = getattr(r, "metrics", None)
        state = getattr(r, "state", None)
        if state is None and m is not None:
            state = "finished" if m.finish_t else "in_flight"
        row = {"rid": getattr(r, "rid", None),
               "state": getattr(state, "value", state)}
        if m is not None:
            row.update(queue_s=m.queue_s, ttft_s=m.ttft_s,
                       latency_s=m.latency_s,
                       decode_tokens=m.decode_tokens)
        rows.append(row)
    return {"mode": mode, "stats": dataclasses.asdict(stats),
            "requests": rows}
