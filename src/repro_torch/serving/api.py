"""Typed request surface shared by the serving schedulers.

Counterpart of the part of `repro.serving.api` that the DiT denoise
service and the static LM engine use: the request lifecycle, per-request
metrics, stream events, the counters, the metrics helpers, and the
shared LM serving helpers (`block_bucket`, `prefill_with_plan_reuse`,
`check_serving_family`). The continuous LM `Scheduler` and the
`PrefillEngine` arrive with the paged LM scheduler (ROADMAP.md queue 1,
item 14).
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional

import torch

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
    """Serving counters: the reference's fields that the DiT service and
    the static LM engine keep, under the same names and in the same
    order, so the --stats-json payloads of the two packages line up."""

    prefill_tokens: int = 0
    decode_tokens: int = 0
    prefill_s: float = 0.0
    decode_s: float = 0.0  # wall time inside decode loops / batched ticks
    # prefill plan accounting (layer granularity): builds = first plans,
    # replans = drift-triggered rebuilds, reuses = layers served by a kept
    # plan
    plan_builds: int = 0
    plan_replans: int = 0
    plan_reuses: int = 0
    last_retention: float = 1.0
    # decode-plan accounting (layer granularity): builds = decode plans
    # seeded at prefill (one per layer per group), extends = completed
    # rows appended by plan_extend, replans / reuses = live rows
    # re-classified / inherited at a block boundary
    decode_plan_builds: int = 0
    decode_plan_extends: int = 0
    decode_plan_replans: int = 0
    decode_plan_reuses: int = 0
    decode_last_retention: float = 1.0
    # slot accounting: active vs total slot-steps over the configured pool
    admissions: int = 0
    slot_steps_active: int = 0
    slot_steps_total: int = 0
    denoise_steps: int = 0  # per-request Euler steps executed

    def occupancy(self) -> float:
        """Slot utilization in [0, 1]."""
        return self.slot_steps_active / max(1, self.slot_steps_total)


def block_bucket(length: int, block: int) -> int:
    """`length` rounded up to a whole number of SLA query blocks."""
    block = max(block, 1)
    return max(block, ((length + block - 1) // block) * block)


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


def prefill_with_plan_reuse(prefill_plan, prefill_reuse, params, toks,
                            plans, stats: ServeStats, num_layers: int):
    """Shared plan-reuse prefill step: build the per-layer plan stack on
    the first chunk, reuse it with drift-gated refresh afterwards, and
    account builds / replans / reuses / retention on `stats`. Returns
    (last_hidden, cache, plans)."""
    if plans is None:
        last_hidden, cache, plans = prefill_plan(params, toks)
        stats.plan_builds += num_layers
    else:
        last_hidden, cache, plans, info = prefill_reuse(params, toks, plans)
        replans = int(torch.as_tensor(info["replanned"]).sum())
        stats.plan_replans += replans
        stats.plan_reuses += num_layers - replans
        stats.last_retention = float(torch.as_tensor(
            info["retention"]).min())
    return last_hidden, cache, plans


def check_serving_family(cfg: ArchConfig, mdl, plan_reuse: str,
                         decode_sla: bool, continuous: bool = False):
    """Loudly reject model families without the capabilities a serving
    mode needs (plan-aware prefill, decode-SLA prefill, slot caches)."""
    import inspect

    prefill_fn = getattr(mdl, "prefill", None)
    if plan_reuse != "off":
        if (prefill_fn is None
                or "plans" not in inspect.signature(prefill_fn).parameters):
            raise ValueError(
                f"plan_reuse={plan_reuse!r} requires a model family with "
                f"plan-aware prefill (got family {cfg.family!r})")
    if decode_sla:
        if (prefill_fn is None or "decode_max_len" not in
                inspect.signature(prefill_fn).parameters):
            raise ValueError(
                f"decode_sla requires a model family with decode-SLA "
                f"prefill (got family {cfg.family!r})")
    if continuous and getattr(mdl, "insert_slot", None) is None:
        raise ValueError(
            f"the continuous-batching scheduler requires a model family "
            f"with per-slot caches (make_cache(per_slot=True) + "
            f"insert_slot); family {cfg.family!r} has neither")
