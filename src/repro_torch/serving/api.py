"""Serving API: the typed request surface and the continuous LM scheduler.

Counterpart of `repro.serving.api`:

  * `SamplingParams` / `RequestState` / `StreamEvent` / `RequestMetrics` /
    `ServedRequest`: the request lifecycle (QUEUED -> PREFILLING ->
    DECODING -> FINISHED), greedy or temperature sampling with stop
    tokens, and per-request queue time / TTFT / latency;
  * `ServeStats` and the shared helpers (`block_bucket`,
    `prefill_with_plan_reuse`, `check_serving_family`, `percentile`,
    `stats_json_payload`);
  * `PrefillEngine`: the (1, bucket) prefill of an admission, shared by
    a disaggregated prefill pool (`serving/disagg.py`);
  * `Scheduler`: continuous batching over a fixed pool of decode slots on
    ONE live per-slot cache (`make_cache(per_slot=True)`) or a paged,
    prefix-shared one (`make_paged_cache`, `serving/pages.py`). `submit()`
    enqueues; `step()` admits queued requests into free slots (each
    prefilled in its own block-aligned (1, bucket) call and copied into
    its slot) and runs one batched decode step with per-slot positions;
    `drain()` runs to completion in rolled greedy segments; `stream()`
    yields StreamEvents; `admit_external()` adopts a request another
    worker prefilled (the disaggregated handoff).

The port decodes eagerly and in place: a rolled segment is a Python loop
of `decode_step`s with the greedy tokens kept on the device (one sync per
dispatch), and the reference's masked mixed tick (some slots sample, the
rest roll greedily; unpaged) runs the full batch and puts the frozen
slots' touched state back (`transformer.snapshot_slots` /
`restore_slots`), which commits the same tokens and counters. Chunked
admission (`prefill_chunk_blocks`, paged only) runs a request's prompt
one chunk per tick (`_PrefillJob`) while the other slots decode, resuming
from a chunk-boundary carry snapshot when a prompt shares a prefix.
"""
from __future__ import annotations

import collections
import dataclasses
import enum
import math
import time
import warnings
from typing import Deque, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import registry
from repro_torch.models.common import logits_from_hidden


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    FINISHED = "finished"


@dataclasses.dataclass
class SamplingParams:
    """Per-request sampling policy.

    temperature == 0.0 is greedy argmax; > 0 samples from
    softmax(logits / T) with a per-request deterministic host RNG
    (`seed`). Generation stops at `max_new_tokens` or on the first token
    in `stop_tokens` (the stop token itself is kept)."""

    max_new_tokens: int = 16
    temperature: float = 0.0
    stop_tokens: Tuple[int, ...] = ()
    seed: int = 0

    def validate(self) -> "SamplingParams":
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1 (got {self.max_new_tokens})")
        if self.temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0 (got {self.temperature})")
        return self


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
    """One streaming output event: "start" (admitted to a slot), "token"
    (one generated token; `token` and `index` set), "step" (one denoising
    step; `index` set), "finish"."""

    rid: int
    kind: str
    t: float
    token: Optional[int] = None
    index: Optional[int] = None


@dataclasses.dataclass
class ServedRequest:
    """A request inside the continuous scheduler."""

    rid: int
    prompt: np.ndarray
    sampling: SamplingParams
    state: RequestState = RequestState.QUEUED
    tokens_out: List[int] = dataclasses.field(default_factory=list)
    metrics: RequestMetrics = dataclasses.field(
        default_factory=RequestMetrics)
    slot: Optional[int] = None


@dataclasses.dataclass
class ServeStats:
    """Serving counters: the reference's fields under the same names and
    in the same order, so the --stats-json payloads of the two packages
    line up."""

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
    # paged-KV accounting: pages_in_use / pages_peak = referenced
    # physical pages (current / high-water), page_allocs = pool
    # allocations, prefix_hits / misses = per-page prefix-cache lookups at
    # admission, prefix_full_hits = whole-prompt snapshot hits (prefill
    # skipped), cow_copies = copy-on-write duplications of a shared page
    pages_in_use: int = 0
    pages_peak: int = 0
    page_allocs: int = 0
    prefix_hits: int = 0
    prefix_misses: int = 0
    prefix_full_hits: int = 0
    cow_copies: int = 0
    # chunked-admission accounting (requests admitted by chunks, chunk
    # dispatches) and the largest wall-clock gap between consecutive
    # token emissions, the decode stall chunked admission bounds
    chunked_admissions: int = 0
    prefill_chunks: int = 0
    max_decode_gap_s: float = 0.0
    denoise_steps: int = 0  # per-request Euler steps executed
    # the cross-request plan cache's counters (DiffusionScheduler)
    plan_cache_hits: int = 0
    plan_cache_misses: int = 0
    plan_cache_invalidations: int = 0
    plan_cache_evictions: int = 0

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


def lift_column_capacity(cfg: ArchConfig) -> ArchConfig:
    """`cfg` with `sla.col_capacity_factor` lifted to None, with a warning
    when it was set: what paged serving runs. A prompt page is interned by
    its padded prefix bytes, and the column-capacity demotion ranks a
    column over every query row, so with it a shared page could depend on
    the prompt's suffix. Uncapped, the plan keeps strictly more critical
    blocks, still a valid SLA plan."""
    if cfg.sla.col_capacity_factor is None:
        return cfg
    warnings.warn(
        f"paged=True: lifting sla.col_capacity_factor "
        f"({cfg.sla.col_capacity_factor} -> None); a shared prompt page is "
        f"a pure function of its prefix only uncapped", stacklevel=3)
    return dataclasses.replace(
        cfg, sla=cfg.sla.replace(col_capacity_factor=None))


def _to_host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


# ---------------------------------------------------------------------------
# the prefill engine
# ---------------------------------------------------------------------------
class PrefillEngine:
    """The prefill half of the scheduler: the (1, bucket) prefill of an
    admission (fresh, plan-building, or drift-gated reuse) over the
    parameters cast once to the compute dtype (`compute_params`), the
    first-token logits, and chunked admission: the chunk / finalize
    dispatches (`chunk_tokens` tokens a chunk, 0 for blocking), the zero
    carry of a job, and the LRU of chunk-boundary carry snapshots.
    Counterpart of the reference's `PrefillEngine`. A disaggregated
    prefill pool shares one, so carry snapshots amortize across the pool
    and a requeued request re-prefills the same on any worker (prefill
    is a pure function of the padded prompt and bucket with plan_reuse
    off).

    The reference's carries are immutable arrays, so it keeps one zero
    carry per bucket and stores snapshots by reference; here
    `prefill_chunk` writes its carry in place. So every job starts from a
    zero carry of its own (`carry_proto`), and a snapshot keeps a copy of
    the rows written so far (`carry_put`), restored into a fresh zero
    carry by `carry_get`: the values the reference's snapshot holds,
    without the zero rows past them."""

    def __init__(self, cfg: ArchConfig, params, mdl, *, backend: str,
                 compute_dtype, decode_sla: bool, max_len: int,
                 drift_threshold, plan_reuse: str = "off",
                 chunk_tokens: int = 0, cparams=None):
        self.cfg = cfg
        self.mdl = mdl
        self.backend = backend
        self.compute_dtype = compute_dtype
        self.decode_sla = decode_sla
        self.max_len = max_len
        self.plan_reuse = plan_reuse
        self.chunk_tokens = chunk_tokens
        self.drift_threshold = drift_threshold
        self.params = (cparams if cparams is not None
                       else mdl.compute_params(params, compute_dtype))
        self.device = self.params.embed.device
        self._dkw = {"decode_max_len": max_len} if decode_sla else {}
        self._carry_snaps = collections.OrderedDict()
        self._carry_cap = 16

    @torch.no_grad()
    def _prefill(self, params, tokens):
        return self.mdl.prefill(params, self.cfg, tokens,
                                compute_dtype=self.compute_dtype,
                                backend=self.backend, **self._dkw)

    @torch.no_grad()
    def _prefill_plan(self, params, tokens):
        return self.mdl.prefill(params, self.cfg, tokens,
                                compute_dtype=self.compute_dtype,
                                backend=self.backend, return_plans=True,
                                **self._dkw)

    @torch.no_grad()
    def _prefill_reuse(self, params, tokens, plans):
        return self.mdl.prefill(params, self.cfg, tokens,
                                compute_dtype=self.compute_dtype,
                                backend=self.backend, plans=plans,
                                drift_threshold=self.drift_threshold,
                                return_plans=True, **self._dkw)

    def run(self, toks: torch.Tensor, plans, stats: ServeStats,
            num_layers: int):
        """(1, bucket) prefill. With plan_reuse off, `plans` passes through
        untouched; otherwise the shared drift-gated reuse path runs and
        the updated plan stack comes back. Returns (last_hidden, cache,
        plans)."""
        if self.plan_reuse == "off":
            last_hidden, cache = self._prefill(self.params, toks)
            return last_hidden, cache, plans
        return prefill_with_plan_reuse(
            self._prefill_plan, self._prefill_reuse, self.params, toks,
            plans, stats, num_layers)

    def logits(self, last_hidden) -> np.ndarray:
        """(1, vocab) first-token logits row, on the host."""
        with torch.no_grad():
            return _to_host(logits_from_hidden(self.params, last_hidden))

    # -- chunked prefill ---------------------------------------------------
    def chunk(self, toks_span: torch.Tensor, carry: dict, start: int):
        """Run ONE prefill chunk into `carry` (in place); returns (carry,
        last_hidden)."""
        return self.mdl.prefill_chunk(
            self.params, self.cfg, toks_span, carry, start,
            compute_dtype=self.compute_dtype, backend=self.backend,
            decode_max_len=self.max_len if self.decode_sla else None)

    @torch.no_grad()
    def finalize(self, carry: dict) -> dict:
        """A completed carry -> the cache dict blocking prefill returns."""
        return self.mdl.finalize_chunked_prefill(
            self.cfg, carry,
            decode_max_len=self.max_len if self.decode_sla else None)

    def carry_proto(self, bucket: int) -> dict:
        """A zero chunked-prefill carry for `bucket`, new for each job
        (the job writes into it; keeping one to copy from would hold a
        whole carry for nothing)."""
        return self.mdl.make_prefill_carry(
            self.cfg, bucket, compute_dtype=self.compute_dtype,
            decode_sla=self.decode_sla, device=self.device)

    def carry_get(self, key) -> Optional[dict]:
        """LRU lookup of a chunk-boundary carry snapshot (touches); a hit
        comes back as a fresh carry with the snapshot's rows written."""
        snap = self._carry_snaps.get(key)
        if snap is None:
            return None
        self._carry_snaps.move_to_end(key)
        return self.mdl.carry_restore(self.carry_proto(key[0]), snap)

    def carry_put(self, key, carry: dict, tokens: int):
        """Keep a copy of the first `tokens` prompt tokens' rows of `carry`
        under `key` (bucket, padded prefix bytes)."""
        self._carry_snaps[key] = self.mdl.carry_rows(carry, tokens,
                                                     self.cfg.sla.block_q)
        self._carry_snaps.move_to_end(key)
        while len(self._carry_snaps) > self._carry_cap:
            self._carry_snaps.popitem(last=False)

    def carry_bytes(self) -> int:
        """Device bytes the carry snapshots hold."""
        return sum(t.numel() * t.element_size()
                   for snap in self._carry_snaps.values()
                   for t in snap.values())


@dataclasses.dataclass
class _PrefillJob:
    """One in-flight chunked admission. The request owns `slot` in
    PREFILLING state while its prompt advances one chunk per tick;
    `carry` is the model's chunked-prefill carry (KV written so far,
    pooled block features, decode-grid rows), `pids` the pool refs
    claimed page by page as chunks land (taken over by `_set_slot_pages`
    at completion), and `dispatched` the prompt tokens that actually ran
    (prefix-resumed chunks are skipped)."""

    r: ServedRequest
    slot: int
    toks: np.ndarray        # (1, bucket) left-padded prompt
    keys: List[bytes]       # page intern keys for every prompt page
    bucket: int             # admission-time bucket (survives later growth)
    carry: dict
    num_chunks: int
    t0: float               # admission wall-clock (metrics.admit_t)
    next_chunk: int = 0
    dispatched: int = 0
    pids: List[int] = dataclasses.field(default_factory=list)
    last_hidden: Optional[torch.Tensor] = None


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------
class Scheduler:
    """Continuous-batching scheduler over a fixed pool of decode slots.

    One live per-slot cache holds `num_slots` independent sequences
    (per-slot positions, per-slot decode-SLA plan and state). The moment
    a request finishes, the next queued request is prefilled in its own
    (1, bucket) call and copied into the freed slot. With `paged=True`
    the cache is a global pool of block_kv-sized pages with a per-slot
    page table: prompt pages are interned by their padded prefix bytes
    and shared between requests, decode pages are made private by a
    copy-on-write pass before each dispatch, and an exact repeat of a
    prompt admits from a full-prompt snapshot without a prefill.
    Runs on the device of `params`.

    Sharing a prompt page assumes its contents are a pure function of
    the padded tokens below its end. SLA's column-capacity demotion
    (`sla.col_capacity_factor`) ranks a column's critical blocks over
    every query row, later ones included, so with it set a shared page's
    K/V from layer 1 on can depend on the prompt's suffix (ROADMAP.md
    queue 3). So `paged=True` lifts the capacity (None) with a warning,
    as the reference CLI does for chunked admission: the plan keeps
    strictly more critical blocks, still a valid SLA plan, and every
    shared page is what an unshared prefill would write.

    `cparams` takes parameters already cast by `compute_params`, so that
    schedulers over the same weights (a disaggregated decode pool) share
    one read-only copy."""

    def __init__(self, cfg: ArchConfig, params, num_slots: int = 4,
                 max_len: int = 512, backend: str = "gather",
                 decode_sla: Optional[bool] = None,
                 plan_reuse: str = "off", drift_threshold=None,
                 prefill_bucket: Optional[int] = None,
                 compute_dtype=torch.bfloat16,
                 paged: Optional[bool] = None,
                 pool_pages: Optional[int] = None,
                 prefill_chunk_blocks: Optional[int] = None,
                 cparams=None):
        from repro_torch.core import backends as backend_registry

        backend = backend_registry.resolve(backend)
        cfg.sla.validate()
        if plan_reuse not in ("off", "adaptive"):
            raise ValueError(
                f"unknown plan_reuse mode {plan_reuse!r}; expected "
                "'off' or 'adaptive'")
        if decode_sla is None:
            decode_sla = cfg.sla.decode_mode == "sla"
        if paged is None:
            paged = cfg.sla.paged
        if paged and plan_reuse == "adaptive":
            # prefix pages are interned by prompt BYTES; adaptive plan
            # reuse makes a prefill depend on every earlier request's
            # plans, so identical bytes would no longer mean identical
            # page contents
            raise ValueError(
                "paged=True is incompatible with plan_reuse='adaptive': "
                "cross-request plan state breaks content-keyed prefix "
                "page interning (use plan_reuse='off')")
        if paged and cfg.sla.block_q != cfg.sla.block_kv:
            raise ValueError(
                f"paged KV pages are block_kv-sized and admission is "
                f"block_q-aligned; the grids must match (got block_q="
                f"{cfg.sla.block_q}, block_kv={cfg.sla.block_kv})")
        if paged:
            cfg = lift_column_capacity(cfg)
        if prefill_chunk_blocks is None:
            prefill_chunk_blocks = cfg.sla.prefill_chunk_blocks
        if prefill_chunk_blocks is not None:
            if prefill_chunk_blocks < 1:
                raise ValueError(
                    f"prefill_chunk_blocks must be >= 1 (got "
                    f"{prefill_chunk_blocks})")
            if not paged:
                raise ValueError(
                    "prefill_chunk_blocks requires paged=True: chunked "
                    "admission lands its pages through the page-table "
                    "scatter and the prefix page cache")
        self.cfg = cfg
        self.mdl = registry.get_model(cfg)
        check_serving_family(cfg, self.mdl, plan_reuse, decode_sla,
                             continuous=True)
        if prefill_chunk_blocks is not None:
            chk = getattr(self.mdl, "check_chunked_prefill", None)
            if chk is None:
                raise ValueError(
                    f"prefill_chunk_blocks requires a model family with "
                    f"chunked prefill (prefill_chunk / "
                    f"finalize_chunked_prefill); family {cfg.family!r} "
                    f"has none")
            chk(cfg, backend)  # all-SLA, no column capacity, ...
        self.num_slots = num_slots
        self.backend = backend
        self.decode_sla = decode_sla
        self.paged = paged
        self.plan_reuse = plan_reuse
        self.drift_threshold = normalize_drift_threshold(cfg,
                                                         drift_threshold)
        self.block = max(cfg.sla.block_q, 1)
        # admission at block boundaries: cache length and prefill buckets
        # are whole numbers of blocks, so every slot's position starts
        # block-aligned and plan_extend's static-grid invariants hold per
        # slot
        self.max_len = block_bucket(max_len, self.block) \
            if (decode_sla or paged) else max_len
        self.compute_dtype = compute_dtype
        self.device = params.embed.device
        self.stats = ServeStats()

        self._queue: Deque[ServedRequest] = collections.deque()
        self._slots: List[Optional[ServedRequest]] = [None] * num_slots
        self._tokens = np.zeros((num_slots,), np.int32)
        self._next_rid = 0
        self._requests: List[ServedRequest] = []  # submission order
        self._bucket = (block_bucket(prefill_bucket, self.block)
                        if prefill_bucket else None)
        self._plans = None  # (1, bucket) plan stack for plan_reuse
        self._stat_base = [None] * num_slots  # decode-SLA counter bases
        # chunked admission: one optional in-flight _PrefillJob per slot;
        # the zero carries and the boundary-snapshot LRU live on the
        # PrefillEngine below
        self.prefill_chunk_blocks = prefill_chunk_blocks
        self._chunk_tokens = (prefill_chunk_blocks or 0) * self.block
        self._job_by_slot: List[Optional[_PrefillJob]] = [None] * num_slots
        self._last_token_t: Optional[float] = None

        if paged:
            from repro_torch.serving.pages import PagePool, ZERO_PAGE

            if getattr(self.mdl, "make_paged_cache", None) is None:
                raise ValueError(
                    f"paged=True requires a model family with a paged "
                    f"decode cache (make_paged_cache / insert_slot_paged)"
                    f"; family {cfg.family!r} has none")
            tn = self.max_len // self.block
            # full per-slot backing + one pinned scratch page per slot +
            # the permanent zero page: exactly enough for zero sharing
            default_pool = 1 + num_slots + num_slots * tn
            if pool_pages is None:
                pool_pages = (cfg.sla.page_pool_size
                              if cfg.sla.page_pool_size is not None
                              else default_pool)
            self.pool_pages = pool_pages
            self._pool = PagePool(pool_pages)
            self._zero_page = ZERO_PAGE
            # one pinned scratch page per slot: inactive slots keep
            # stepping through every batched dispatch, and their garbage
            # writes must land somewhere harmless
            self._scratch = [self._pool.alloc() for _ in range(num_slots)]
            self._pt_host = np.zeros((num_slots, tn), np.int32)
            for j in range(num_slots):
                self._pt_host[j, :] = self._scratch[j]
            self._slot_pids: List[List[int]] = [[] for _ in
                                                range(num_slots)]
            self._slot_base = [0] * num_slots  # prefill bucket at admit
            # full-prompt snapshots: (bucket, padded bytes) -> (per-slot
            # prefill state, first-token logits); exact hits skip the
            # prefill dispatch entirely
            self._snapshots = collections.OrderedDict()
            self._snapshot_cap = 32

        self._cparams = (cparams if cparams is not None else
                         self.mdl.compute_params(params, compute_dtype))
        self._pf = PrefillEngine(
            cfg, params, self.mdl, backend=backend,
            compute_dtype=compute_dtype, decode_sla=decode_sla,
            max_len=self.max_len, drift_threshold=self.drift_threshold,
            plan_reuse=plan_reuse, chunk_tokens=self._chunk_tokens,
            cparams=self._cparams)
        # the model's cache writers, as attributes (the reference's jitted
        # closures), so a caller can wrap one
        self._admit = self.mdl.insert_slot
        if paged:
            self._admit_paged = self.mdl.insert_slot_paged
            self._admit_state = self.mdl.insert_slot_state_paged
            self._copy_page = self.mdl.copy_page
            self._live = self.mdl.make_paged_cache(
                cfg, num_slots, self.max_len, pool_pages,
                dtype=compute_dtype, decode_sla=decode_sla,
                device=self.device)
            self._push_pt()
        else:
            self._live = self.mdl.make_cache(
                cfg, num_slots, self.max_len, dtype=compute_dtype,
                decode_sla=decode_sla, per_slot=True, device=self.device)

    # -- decode dispatches ---------------------------------------------------
    @torch.no_grad()
    def _one(self, token: torch.Tensor):
        """One decode step of the whole batch on the live cache, in place;
        returns the (B, vocab) logits."""
        kw = dict(compute_dtype=self.compute_dtype)
        if self.decode_sla:
            kw.update(backend=self.backend,
                      drift_threshold=self.drift_threshold)
        logits, _ = self.mdl.decode_step(self._cparams, self.cfg, token,
                                         self._live, **kw)
        return logits

    def _device_tokens(self) -> torch.Tensor:
        return torch.from_numpy(self._tokens).long().to(self.device)

    def _frozen(self, keep: List[int]) -> dict:
        """Snapshot of every slot outside `keep` (their step writes)."""
        return self.mdl.snapshot_slots(
            self._live, [j for j in range(self.num_slots) if j not in keep])

    @torch.no_grad()
    def _decode_multi(self, nsteps: int, keep: Optional[List[int]] = None):
        """`nsteps` greedy decode steps; with `keep`, only those slots
        move (the rest are put back after every step and keep feeding
        their token). Returns the (nsteps, B) tokens on the host (the
        dispatch's one sync)."""
        token = self._device_tokens()
        buf = torch.zeros((nsteps, self.num_slots), dtype=torch.long,
                          device=self.device)
        if keep is not None:
            mask = torch.zeros(self.num_slots, dtype=torch.bool,
                               device=self.device)
            mask[keep] = True
            frozen = self._frozen(keep)
        for i in range(nsteps):
            new = self._one(token).argmax(dim=-1)
            if keep is not None:
                self.mdl.restore_slots(self._live, frozen)
                new = torch.where(mask, new, token)
            token = new
            buf[i] = token
        return buf.cpu().numpy()

    # -- public API ----------------------------------------------------------
    def submit(self, prompt, sampling: Optional[SamplingParams] = None
               ) -> int:
        """Enqueue one request; returns its rid. O(1), never blocks."""
        sampling = (sampling or SamplingParams()).validate()
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        # capacity check against the SHARED prefill bucket (every
        # admission pads to it); _admit_next re-checks after any growth
        bucket = max(block_bucket(len(prompt), self.block),
                     self._bucket or 0)
        need = bucket + sampling.max_new_tokens
        if need > self.max_len:
            raise ValueError(
                f"max_len={self.max_len} cannot hold a {len(prompt)}-token "
                f"prompt (shared prefill bucket {bucket}) plus "
                f"{sampling.max_new_tokens} new tokens; raise max_len "
                f"to >= {need}")
        r = ServedRequest(rid=self._next_rid, prompt=prompt,
                          sampling=sampling)
        r.metrics.submit_t = time.time()
        self._next_rid += 1
        self._queue.append(r)
        self._requests.append(r)
        return r.rid

    def free_slots(self) -> List[int]:
        """Slots with no resident request."""
        return [j for j in range(self.num_slots) if self._slots[j] is None]

    def admit_external(self, r: ServedRequest, slot: int, cache: dict,
                       logits: np.ndarray, toks: np.ndarray, bucket: int, *,
                       prefilled: int, plan_built: bool = True,
                       start_emitted: bool = True) -> List[StreamEvent]:
        """Admit a request another worker prefilled into `slot`: the
        disaggregated handoff (`serving/disagg.py`). The prefill worker
        hands over the batch-1 prefill `cache`, the (1, vocab) first-token
        `logits` row and the (1, bucket) left-padded prompt `toks`. Runs
        blocking admission's tail: paged, page claim -> page-table scatter
        -> full-prompt snapshot; unpaged, k/v padded to max_len (new
        tensors) -> `insert_slot`. So the slot's cache and every later
        greedy token are what self-admission of the same prompt at the
        same bucket gives, and admitting the same bundle again after a
        worker loss replays the same trajectory. Nothing here writes
        `cache`: its leaves are copied, or kept unwritten by the snapshot.

        `prefilled` is the prompt tokens the prefill dispatched (0 for a
        replayed bundle) and `plan_built` gates the decode-plan build
        count alike."""
        if self._slots[slot] is not None \
                or self._job_by_slot[slot] is not None:
            raise ValueError(
                f"slot {slot} is occupied; admit_external needs a slot "
                f"from free_slots()")
        r.state = RequestState.PREFILLING
        r.slot = slot
        t0 = time.time()
        if r.metrics.admit_t == 0.0:
            r.metrics.admit_t = t0
        # the handoff bucket raises this scheduler's shared floor as a
        # self-admitted long prompt would
        if self._bucket is None or bucket > self._bucket:
            self._bucket = bucket
            self._plans = None
        if bucket + r.sampling.max_new_tokens > self.max_len:
            r.state = RequestState.QUEUED
            r.slot = None
            raise ValueError(
                f"max_len={self.max_len} cannot hold handoff request "
                f"{r.rid}: bucket {bucket} plus "
                f"{r.sampling.max_new_tokens} new tokens does not fit; "
                f"raise max_len to >= "
                f"{bucket + r.sampling.max_new_tokens}")
        if self.paged:
            padded = np.asarray(toks[0])
            pids = [self._claim_page(key) for key in self._page_keys(padded)]
            self._land_paged(cache, logits, padded, slot, pids, bucket)
        else:
            self._land_dense(cache, slot)
        events: List[StreamEvent] = []
        self._finish_admission(r, slot, logits, t0, events,
                               prefilled=prefilled, plan_built=plan_built,
                               start_emitted=start_emitted)
        return events

    @property
    def has_work(self) -> bool:
        return bool(self._queue) or any(r is not None for r in self._slots)

    def step(self) -> List[StreamEvent]:
        """Advance in-flight chunked prefills by one chunk and admit queued
        requests into free slots, then run ONE batched decode step over
        the live cache. Returns the events produced."""
        events: List[StreamEvent] = []
        self._tick_admit(events)
        return events + self._decode_tick()

    def _tick_admit(self, events: List[StreamEvent]):
        """Shared tick head: every in-flight chunked-prefill job advances
        ONE chunk (a completion hands its slot to this tick's decode),
        then queued requests fill free slots."""
        for slot in range(self.num_slots):
            if self._job_by_slot[slot] is not None:
                self._advance_job(slot, events)
        for slot in range(self.num_slots):
            if self._slots[slot] is None and self._queue:
                self._admit_next(slot, events)

    def _decoding(self) -> List[int]:
        """Slots eligible for decode dispatch: occupied and past their
        prefill. A PREFILLING job's slot is masked out like a free one:
        its page-table row still points at its pinned scratch page, so
        the batched dispatch's writes for it land there until the
        completion scatters the real pages in."""
        return [j for j in range(self.num_slots)
                if self._slots[j] is not None
                and self._slots[j].state is RequestState.DECODING]

    def _decode_tick(self) -> List[StreamEvent]:
        """ONE batched decode step over the live cache."""
        events: List[StreamEvent] = []
        active = self._decoding()
        if not active:
            return events
        if self.paged:
            for j in active:
                self._ensure_decode_pages(j, 1)
        t0 = time.time()
        logits = self._one(self._device_tokens())
        # greedy slots argmax on the device (a (B,) transfer); the full
        # (B, vocab) logits cross to the host only when a request samples
        greedy_toks = logits.argmax(dim=-1).cpu().numpy()  # host sync
        larr = None
        if any(self._slots[j].sampling.temperature > 0.0 for j in active):
            larr = _to_host(logits)
        now = time.time()
        self.stats.decode_s += now - t0
        self.stats.decode_tokens += len(active)
        self.stats.slot_steps_active += len(active)
        self.stats.slot_steps_total += self.num_slots
        self._note_gap(now)
        for j in active:
            r = self._slots[j]
            tok = int(greedy_toks[j]) if r.sampling.temperature <= 0.0 \
                else self._sample(r, larr[j])
            self._emit(r, j, tok, now, events)
        return events

    def _emit(self, r: ServedRequest, j: int, tok: int, now: float,
              events: List[StreamEvent]):
        self._tokens[j] = tok
        r.tokens_out.append(tok)
        r.metrics.decode_tokens += 1
        events.append(StreamEvent(rid=r.rid, kind="token", t=now,
                                  token=tok, index=len(r.tokens_out) - 1))
        if self._is_done(r):
            self._finish(r, j, now, events)

    def drain(self) -> List[ServedRequest]:
        """Run until every submitted request has finished; returns all
        requests in submission order. Greedy slots decode in rolled
        segments (one dispatch covers the smallest remaining budget);
        sampling or stop-token requests need per-token host control."""
        while self.has_work:
            self._drain_tick()
        return list(self._requests)

    def _drain_tick(self) -> List[StreamEvent]:
        """One drain iteration: admit, then decode one rolled segment.
        Pure-greedy slots take a rolled dispatch; host-controlled slots
        (temperature > 0 or stop tokens) take one masked single step. A
        paged cache falls back to per-token steps for all: its page pools
        have no batch axis to freeze a slot on."""
        events: List[StreamEvent] = []
        self._tick_admit(events)
        active = self._decoding()
        if not active:
            return events
        ctl = [j for j in active
               if self._slots[j].sampling.temperature > 0.0
               or self._slots[j].sampling.stop_tokens]
        greedy = [j for j in active if j not in ctl]
        if ctl and self.paged:
            return events + self._decode_tick()
        if ctl and greedy:
            events += self._masked_ctl_step(ctl)
            # a ctl slot may have finished; greedy slots are untouched
            return events + self._greedy_roll(greedy, masked=True)
        if ctl:
            return events + self._decode_tick()
        return events + self._greedy_roll(greedy, masked=False)

    def _masked_ctl_step(self, ctl: List[int]) -> List[StreamEvent]:
        """One decode step committed only for the host-controlled slots in
        `ctl`: the whole batch runs and every other slot is put back."""
        events: List[StreamEvent] = []
        frozen = self._frozen(ctl)
        t0 = time.time()
        logits = self._one(self._device_tokens())
        self.mdl.restore_slots(self._live, frozen)
        larr = _to_host(logits)  # host sync; ctl slots sample anyway
        now = time.time()
        self.stats.decode_s += now - t0
        self.stats.decode_tokens += len(ctl)
        self.stats.slot_steps_active += len(ctl)
        self.stats.slot_steps_total += self.num_slots
        self._note_gap(now)
        for j in ctl:
            r = self._slots[j]
            self._emit(r, j, self._sample(r, larr[j]), now, events)
        return events

    def _greedy_roll(self, greedy: List[int],
                     masked: bool) -> List[StreamEvent]:
        """Rolled multi-step greedy decode over the slots in `greedy`:
        nothing can finish before the smallest remaining budget, so run
        exactly that many steps in one dispatch (masked when
        host-controlled slots share the batch and must not move)."""
        events: List[StreamEvent] = []
        nsteps = min(self._slots[j].sampling.max_new_tokens
                     - len(self._slots[j].tokens_out) for j in greedy)
        if any(job is not None for job in self._job_by_slot):
            # a chunked prefill is in flight: one step, so its next chunk
            # interleaves at per-token granularity
            nsteps = 1
        if self.paged:
            for j in greedy:
                self._ensure_decode_pages(j, nsteps)
        t0 = time.time()
        toks = self._decode_multi(nsteps, greedy if masked else None)
        now = time.time()
        self.stats.decode_s += now - t0
        self.stats.decode_tokens += nsteps * len(greedy)
        self.stats.slot_steps_active += nsteps * len(greedy)
        self.stats.slot_steps_total += nsteps * self.num_slots
        self._note_gap(now)
        for j in greedy:
            r = self._slots[j]
            for i in range(nsteps):
                tok = int(toks[i][j])
                self._tokens[j] = tok
                r.tokens_out.append(tok)
                r.metrics.decode_tokens += 1
                events.append(StreamEvent(rid=r.rid, kind="token", t=now,
                                          token=tok,
                                          index=len(r.tokens_out) - 1))
            if self._is_done(r):
                self._finish(r, j, now, events)
        return events

    def stream(self) -> Iterator[StreamEvent]:
        """Yield StreamEvents as they are produced, until drained."""
        while self.has_work:
            yield from self.step()

    # -- internals -----------------------------------------------------------
    def _admit_next(self, slot: int, events: List[StreamEvent]):
        r = self._queue.popleft()
        r.state = RequestState.PREFILLING
        r.slot = slot
        t0 = time.time()
        r.metrics.admit_t = t0
        plen = len(r.prompt)
        if self._bucket is None or plen > self._bucket:
            # a longer prompt grows the bucket; cached (1, bucket) plans
            # are for the old block grid, so they die with it
            self._bucket = block_bucket(plen, self.block)
            self._plans = None
        if self._bucket + r.sampling.max_new_tokens > self.max_len:
            # the shared bucket grew past this request's submit-time
            # check: back to the queue head, then fail loudly
            self._queue.appendleft(r)
            r.state = RequestState.QUEUED
            r.slot = None
            raise ValueError(
                f"max_len={self.max_len} cannot hold request {r.rid}: "
                f"the shared prefill bucket grew to {self._bucket} "
                f"(longest admitted prompt, block-aligned) and "
                f"{r.sampling.max_new_tokens} new tokens no longer fit; "
                f"raise max_len to >= "
                f"{self._bucket + r.sampling.max_new_tokens}")
        toks = np.zeros((1, self._bucket), np.int32)
        toks[0, self._bucket - plen:] = r.prompt  # left-pad
        if self.paged:
            padded = toks[0]
            keys = self._page_keys(padded)
            # precedence: full-prompt snapshot > chunked job > blocking
            logits = self._try_snapshot(padded, keys, slot)
            if logits is not None:
                self._finish_admission(r, slot, logits, t0, events,
                                       prefilled=0, plan_built=False)
                return
            if self._chunk_tokens:
                self._start_job(r, slot, toks, keys, t0, events)
                return
            logits = self._dispatch_paged(toks, keys, slot)
        else:
            last_hidden, cache = self._run_prefill(toks)
            logits = self._pf.logits(last_hidden)
            self._land_dense(cache, slot)
            del cache
        self._finish_admission(r, slot, logits, t0, events,
                               prefilled=self._bucket, plan_built=True)

    def _finish_admission(self, r: ServedRequest, slot: int, logits,
                          t0: float, events: List[StreamEvent], *,
                          prefilled: int, plan_built: bool,
                          start_emitted: bool = False):
        """Common admission tail (blocking, snapshot hit, chunked
        completion): decode-SLA accounting (a snapshot hit builds no plans
        and prefills no tokens), first-token sampling, events, and the
        slot's hand-off to DECODING."""
        if self.decode_sla:
            if plan_built:
                self.stats.decode_plan_builds += self.cfg.num_layers
            self._stat_base[slot] = self._slot_counters(slot)
        tok = self._sample(r, logits[0])
        self._tokens[slot] = tok
        now = time.time()
        self.stats.admissions += 1
        self.stats.prefill_tokens += prefilled
        self.stats.prefill_s += now - t0
        r.metrics.first_token_t = now
        r.state = RequestState.DECODING
        r.tokens_out.append(tok)
        r.metrics.decode_tokens += 1
        if not start_emitted:
            events.append(StreamEvent(rid=r.rid, kind="start", t=t0))
        self._note_gap(now)
        events.append(StreamEvent(rid=r.rid, kind="token", t=now,
                                  token=tok, index=0))
        self._slots[slot] = r
        if self._is_done(r):
            self._finish(r, slot, now, events)

    def _note_gap(self, now: float):
        """The largest wall-clock gap between consecutive token emissions
        (`ServeStats.max_decode_gap_s`)."""
        if self._last_token_t is not None:
            gap = now - self._last_token_t
            if gap > self.stats.max_decode_gap_s:
                self.stats.max_decode_gap_s = gap
        self._last_token_t = now

    def _run_prefill(self, toks: np.ndarray):
        """(1, bucket) prefill, through the plan-reuse path if enabled."""
        last_hidden, cache, self._plans = self._pf.run(
            torch.from_numpy(toks).long().to(self.device), self._plans,
            self.stats, self.cfg.num_layers)
        return last_hidden, cache

    # -- paged KV internals ----------------------------------------------
    def _page_keys(self, padded: np.ndarray) -> List[bytes]:
        """One intern key per prompt page: the raw bytes of the padded
        prompt up to that page's END (page j's KV rows and h/z partials
        are a pure function of the tokens below (j + 1) * block_kv)."""
        bkv = self.block
        return [padded[:(j + 1) * bkv].tobytes()
                for j in range(padded.size // bkv)]

    def _push_pt(self):
        """Publish the host-owned page table to the device cache, in place
        (the scheduler owns it and overwrites it between dispatches)."""
        self._live["pt"].copy_(torch.from_numpy(self._pt_host))

    def _sync_page_stats(self):
        ps, st = self._pool.stats, self.stats
        st.pages_in_use = self._pool.in_use()
        st.pages_peak = max(st.pages_peak, st.pages_in_use)
        st.page_allocs = ps.allocs
        st.prefix_hits = ps.prefix_hits
        st.prefix_misses = ps.prefix_misses
        st.cow_copies = ps.cow_copies

    def _set_slot_pages(self, slot: int, pids: List[int],
                        bucket: Optional[int] = None):
        """Point `slot`'s page-table row at its prompt pages (one pool ref
        each, already taken); the decode tail reads the permanent zero
        page until the CoW pass makes it private. `bucket` defaults to the
        shared prefill bucket; a chunked completion passes its own
        admission-time bucket, which a later longer prompt may have
        outgrown."""
        npp = len(pids)
        self._pt_host[slot, :npp] = pids
        self._pt_host[slot, npp:] = self._zero_page
        self._slot_pids[slot] = list(pids)
        self._slot_base[slot] = self._bucket if bucket is None else bucket
        self._push_pt()

    def _try_snapshot(self, padded: np.ndarray, keys: List[bytes],
                      slot: int) -> Optional[np.ndarray]:
        """Full-prompt snapshot fast path: an exact (bucket, padded bytes)
        snapshot hit whose prompt pages are all still interned skips the
        prefill; the per-slot state and first-token logits were kept when
        the prompt was first seen and the pages hold its KV/partials.
        Returns the logits row, or None on a miss."""
        snap_key = (self._bucket, padded.tobytes())
        snap = self._snapshots.get(snap_key)
        if snap is None:
            return None
        pids = []
        for key in keys:
            pid = self._pool.lookup(key)
            if pid is None:  # a page was evicted since the snapshot
                for taken in pids:  # hand the taken refs back
                    self._pool.release(taken)
                return None
            pids.append(pid)
        self._snapshots.move_to_end(snap_key)
        state, logits = snap
        self._admit_state(self._live, state, slot)
        self._set_slot_pages(slot, pids)
        self.stats.prefix_full_hits += 1
        self._sync_page_stats()
        return logits

    def _claim_page(self, key: bytes) -> int:
        """Lookup-or-alloc one prompt page by its prefix-bytes key; the
        returned pool ref belongs to the caller."""
        pid = self._pool.lookup(key)
        if pid is None:
            pid = self._pool.alloc()
            self._pool.intern(key, pid)
        return pid

    def _land_dense(self, cache: dict, slot: int):
        """Unpaged admission's copy: the batch-1 cache into `slot`, its k/v
        padded to max_len first (dense prefill caches stop at the bucket;
        the padding makes new tensors, `cache` is not written)."""
        grow = self.max_len - cache["k"].shape[-2]
        if grow > 0:
            cache = dict(cache, **{key: torch.nn.functional.pad(
                cache[key], (0, 0, 0, grow)) for key in ("k", "v")})
        self._admit(self._live, cache, slot)

    def _land_paged(self, cache: dict, logits, padded: np.ndarray,
                    slot: int, pids: List[int], bucket: int):
        """Paged admission's tail: the batch-1 cache scattered into the
        prompt pages `pids` (one pool ref each, taken), the page-table row
        pointed at them, the full-prompt snapshot stored under (bucket,
        padded bytes)."""
        self._admit_paged(self._live, cache, slot, pids)
        self._set_slot_pages(slot, pids, bucket=bucket)
        self._store_snapshot((bucket, padded.tobytes()), cache, logits)
        self._sync_page_stats()

    def _store_snapshot(self, snap_key, cache, logits):
        self._snapshots[snap_key] = (
            self.mdl.slot_state_from_prefill(cache), logits)
        self._snapshots.move_to_end(snap_key)
        while len(self._snapshots) > self._snapshot_cap:
            self._snapshots.popitem(last=False)

    def _dispatch_paged(self, toks: np.ndarray, keys: List[bytes],
                        slot: int) -> np.ndarray:
        """Blocking page-granular admission: one (1, bucket) prefill, each
        prompt page interned by its prefix bytes; pages that hit are
        REWRITTEN with the same contents. Returns the first-token logits
        row."""
        last_hidden, cache = self._run_prefill(toks)
        logits = self._pf.logits(last_hidden)
        pids = [self._claim_page(key) for key in keys]
        self._land_paged(cache, logits, toks[0], slot, pids, self._bucket)
        return logits

    # -- chunked admission -------------------------------------------------
    def _claim_job_pages(self, job: _PrefillJob, lo: int, hi: int):
        """Intern-or-alloc the pages covering padded tokens [lo, hi), one
        pool ref each, held by the job until `_set_slot_pages` takes them
        over at completion. Interned hits count prefix hits once per page,
        as in blocking admission; the pages' contents land at the
        completion's full rewrite (nothing reads a slot's pages before
        its own completion: snapshot hits need a stored snapshot, stored
        only after such a rewrite)."""
        bkv = self.block
        for j in range(lo // bkv, hi // bkv):
            job.pids.append(self._claim_page(job.keys[j]))
        self._sync_page_stats()

    def _start_job(self, r: ServedRequest, slot: int, toks: np.ndarray,
                   keys: List[bytes], t0: float,
                   events: List[StreamEvent]):
        """Claim `slot` for a multi-tick chunked admission. The request
        sits in PREFILLING state (masked out of decode) while `_tick_admit`
        advances it one chunk per tick; its first chunk runs in THIS tick.
        If a carry snapshot survives for a chunk-boundary prefix of the
        padded prompt, the job resumes past those chunks, their pages
        claimed by intern lookup instead of recomputed."""
        bucket, ct = self._bucket, self._chunk_tokens
        job = _PrefillJob(r=r, slot=slot, toks=toks, keys=keys,
                          bucket=bucket, carry=None,
                          num_chunks=-(-bucket // ct), t0=t0)
        for c in range(job.num_chunks - 1, 0, -1):
            snap = self._pf.carry_get((bucket, toks[0, :c * ct].tobytes()))
            if snap is not None:
                job.carry = snap
                job.next_chunk = c
                self._claim_job_pages(job, 0, c * ct)
                break
        if job.carry is None:
            job.carry = self._pf.carry_proto(bucket)
        self.stats.chunked_admissions += 1
        self._job_by_slot[slot] = job
        self._slots[slot] = r  # owns the slot; PREFILLING masks decode
        events.append(StreamEvent(rid=r.rid, kind="start", t=t0))
        self._advance_job(slot, events)

    def _advance_job(self, slot: int, events: List[StreamEvent]):
        """Run ONE prefill chunk for the job in `slot`: its KV and pooled
        rows land in the carry, its pages are claimed from the pool, and
        the boundary carry is snapshotted for later prefix resumes. The
        last chunk hands the slot to decode."""
        job = self._job_by_slot[slot]
        ct = self._chunk_tokens
        lo = job.next_chunk * ct
        hi = min(lo + ct, job.bucket)
        t0 = time.time()
        span = torch.from_numpy(job.toks[:, lo:hi]).long().to(self.device)
        job.carry, job.last_hidden = self._pf.chunk(span, job.carry, lo)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats.prefill_s += time.time() - t0
        self.stats.prefill_chunks += 1
        job.dispatched += hi - lo
        self._claim_job_pages(job, lo, hi)
        if hi < job.bucket:  # a full-prompt resume is the snapshot's job
            self._pf.carry_put((job.bucket, job.toks[0, :hi].tobytes()),
                               job.carry, hi)
        job.next_chunk += 1
        if job.next_chunk >= job.num_chunks:
            self._complete_job(slot, job, events)

    def _complete_job(self, slot: int, job: _PrefillJob,
                      events: List[StreamEvent]):
        """Blocking admission's tail: finalize the carry into the cache
        dict blocking prefill returns (decode state rebuilt with
        `_seed_decode_state`), scatter it into `slot` through the page
        table, store the full-prompt snapshot, emit the first token."""
        t0 = time.time()
        cache = self._pf.finalize(job.carry)
        logits = self._pf.logits(job.last_hidden)
        self._land_paged(cache, logits, job.toks[0], slot, job.pids,
                         job.bucket)
        self._job_by_slot[slot] = None
        job.carry = None
        del cache
        self._finish_admission(job.r, slot, logits, t0, events,
                               prefilled=job.dispatched, plan_built=True,
                               start_emitted=True)

    def _ensure_decode_pages(self, slot: int, nsteps: int):
        """Copy-on-write pass before a decode dispatch: every page in
        `slot`'s write range for the next `nsteps` tokens must be private
        (refcount 1, not the zero page) before the step touches it. Fresh
        decode pages start as a copy of the zero page (the h/z partials
        ACCUMULATE into them); shared pages are duplicated on their first
        divergent write."""
        r = self._slots[slot]
        pos = self._slot_base[slot] + len(r.tokens_out) - 1
        bkv = self.block
        tn = self._pt_host.shape[1]
        first = min(pos // bkv, tn - 1)
        last = min((pos + nsteps - 1) // bkv, tn - 1)
        changed = False
        for blk in range(first, last + 1):
            pid = int(self._pt_host[slot, blk])
            if pid != self._zero_page and self._pool.refs(pid) == 1:
                continue  # already exclusively ours
            new, src = self._pool.ensure_private(pid)
            self._copy_page(self._live, new, src)
            own = self._slot_pids[slot]
            if pid in own:
                own[own.index(pid)] = new
            else:
                own.append(new)  # the zero page was never slot-owned
            self._pt_host[slot, blk] = new
            changed = True
        if changed:
            self._push_pt()
            self._sync_page_stats()

    def _slot_counters(self, slot: int) -> dict:
        st = self._live["sla"]
        # copies: on the CPU .numpy() would share the live counters
        return {key: st[key][:, slot].cpu().numpy().copy()
                for key in ("extends", "replans", "reuses")}

    def _sample(self, r: ServedRequest, logits_row: np.ndarray) -> int:
        if r.sampling.temperature <= 0.0:
            return int(np.argmax(logits_row))
        rng = np.random.default_rng(
            (r.sampling.seed, r.rid, len(r.tokens_out)))
        z = logits_row.astype(np.float64) / r.sampling.temperature
        z -= z.max()
        p = np.exp(z)
        return int(rng.choice(len(p), p=p / p.sum()))

    def _is_done(self, r: ServedRequest) -> bool:
        if len(r.tokens_out) >= r.sampling.max_new_tokens:
            return True
        return bool(r.tokens_out) and \
            r.tokens_out[-1] in r.sampling.stop_tokens

    def _finish(self, r: ServedRequest, slot: int, now: float,
                events: List[StreamEvent]):
        r.state = RequestState.FINISHED
        r.metrics.finish_t = now
        self._slots[slot] = None
        if self.paged:
            # drop this slot's page refs (interned prefix pages stay under
            # the index's own ref until evicted) and point the row back at
            # the pinned scratch page
            for pid in self._slot_pids[slot]:
                self._pool.release(pid)
            self._slot_pids[slot] = []
            self._pt_host[slot, :] = self._scratch[slot]
            self._push_pt()
            self._sync_page_stats()
        if self.decode_sla and self._stat_base[slot] is not None:
            base, cur = self._stat_base[slot], self._slot_counters(slot)
            self.stats.decode_plan_extends += int(
                (cur["extends"] - base["extends"]).sum())
            self.stats.decode_plan_replans += int(
                (cur["replans"] - base["replans"]).sum())
            self.stats.decode_plan_reuses += int(
                (cur["reuses"] - base["reuses"]).sum())
            self.stats.decode_last_retention = float(
                self._live["sla"]["retention"][:, slot].min())
            self._stat_base[slot] = None
        events.append(StreamEvent(rid=r.rid, kind="finish", t=now))
