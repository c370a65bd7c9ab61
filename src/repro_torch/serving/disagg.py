"""Disaggregated prefill/decode serving. Counterpart of
`repro.serving.disagg`.

The continuous-batching Scheduler runs admission (quadratic prefill) and
decode (O(1) state per token with decode-SLA) on ONE worker, so a long
prompt and the token stream fight for the same device queue. This module
splits them into two worker pools with an explicit state handoff:

  * `PrefillWorker`: runs the (1, bucket) prefill (blocking, or one chunk
    per tick with carry-snapshot resume) on a shared `PrefillEngine` and
    produces a `HandoffBundle`: the batch-1 prefill cache (KV rows and,
    with decode-SLA, the per-block h/z partials, pooled features, live-row
    LUTs and plan rows: what `insert_slot` / `insert_slot_paged` copy),
    the first-token logits row and the padded prompt.
  * `DecodeWorker`: a full `Scheduler` whose queue stays empty: requests
    enter only through `Scheduler.admit_external`, which runs blocking
    admission's tail, so tokens are what a single-Scheduler run gives.
    Decode runs the rolled drain ticks (or per-token steps).
  * `DisaggScheduler`: the control plane, a tick-driven loop that assigns
    queued requests to idle prefill workers, routes finished bundles to
    the least-loaded decode worker and drives the fault machinery of
    `distributed/fault_tolerance.py`:

      - a `FaultPlan` injects kill / straggle / flake events by tick;
      - every worker tick runs under `run_with_retries`, which absorbs
        injected flakes with recorded backoff; an error a real step
        raises is not retried (the step may have written state) and
        propagates;
      - measured decode-tick durations feed a shared `StragglerWatchdog`;
        a flagged worker is DRAINED: it finishes its residents but takes
        no new ones;
      - a killed decode worker's residents REQUEUE from their retained
        handoff bundles (a killed prefill worker's from scratch), and its
        live cache is freed. Greedy decode is deterministic, so a
        replayed bundle reproduces the lost trajectory. A request over
        `max_requeues` goes back to the queue (QUEUED, no slot) and the
        loss is raised.

Requeue determinism needs prefill to be a pure function of (padded
prompt, bucket), so plan reuse stays off here. A bundle is replayed by
copying: nothing writes its tensors after the prefill that made them (the
worker drops its carry when it finalizes; admission copies, and the
decode worker's full-prompt snapshot only reads). With `paged=True` the
column capacity is lifted (None) for the prefill pool as for the decode
workers, as the paged Scheduler does, so that a paged disaggregated run
equals a paged single-Scheduler run.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, Iterator, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.fault_tolerance import (FaultEvent, FaultPlan,
                                                     InjectedFault,
                                                     StragglerWatchdog,
                                                     run_with_retries)
from repro_torch.models import registry
from repro_torch.serving.api import (PrefillEngine, RequestState,
                                     SamplingParams, Scheduler,
                                     ServedRequest, StreamEvent,
                                     block_bucket, check_serving_family,
                                     lift_column_capacity,
                                     normalize_drift_threshold)


@dataclasses.dataclass
class HandoffBundle:
    """Everything a decode worker needs to adopt a prefilled request, and
    everything a requeue needs to replay it after the worker dies.

    `cache` is the batch-1 prefill cache ({"k", "v", "pos"} and, with
    decode-SLA, the "sla" state), the argument `insert_slot` /
    `insert_slot_paged` copy into a slot. The DisaggScheduler keeps a
    bundle until its request finishes; nothing writes its tensors, so one
    bundle can be replayed any number of times."""

    rid: int
    toks: np.ndarray      # (1, bucket) left-padded prompt
    bucket: int
    cache: dict           # batch-1 prefill cache
    logits: np.ndarray    # (1, vocab) first-token logits row
    prefilled: int        # prompt tokens the prefill actually dispatched


@dataclasses.dataclass
class DisaggStats:
    """Control-plane accounting; the per-worker decode counters live on
    each DecodeWorker's own Scheduler stats (`DisaggScheduler.pool_stats`)."""

    ticks: int = 0
    submitted: int = 0
    completed: int = 0
    handoffs: int = 0
    requeues: int = 0
    kills: int = 0
    straggler_drains: int = 0
    retries: int = 0
    drain_fallbacks: int = 0
    prefill_tokens: int = 0
    prefill_chunks: int = 0
    prefill_s: float = 0.0
    # prefill-pool occupancy: busy worker-ticks over live worker-ticks
    prefill_busy_steps: int = 0
    prefill_steps_total: int = 0

    def prefill_occupancy(self) -> float:
        return self.prefill_busy_steps / max(1, self.prefill_steps_total)


@dataclasses.dataclass
class _PrefillTask:
    """One request's prefill in flight on a worker (the pool-side
    counterpart of api._PrefillJob, minus pages: a prefill worker owns no
    PagePool; the decode worker claims pages at admission)."""

    r: ServedRequest
    toks: np.ndarray        # (1, bucket) left-padded prompt
    bucket: int
    carry: Optional[dict] = None
    num_chunks: int = 0
    next_chunk: int = 0
    dispatched: int = 0
    last_hidden: Optional[torch.Tensor] = None


class PrefillWorker:
    """One prefill lane over the pool-shared PrefillEngine: blocking (the
    whole prompt in one tick) or chunked (one block-aligned chunk per
    tick, resuming from a carry snapshot at a shared prefix)."""

    def __init__(self, wid: int, engine: PrefillEngine):
        self.wid = wid
        self.engine = engine
        self.alive = True
        self.straggle_factor = 1.0
        self.flakes_pending = 0
        self.task: Optional[_PrefillTask] = None

    @property
    def name(self) -> str:
        return f"prefill:{self.wid}"

    @property
    def busy(self) -> bool:
        return self.task is not None

    def assign(self, r: ServedRequest, toks: np.ndarray, bucket: int):
        assert self.task is None, f"{self.name} already busy"
        task = _PrefillTask(r=r, toks=toks, bucket=bucket)
        ct = self.engine.chunk_tokens
        if ct:
            task.num_chunks = -(-bucket // ct)
            # resume past any chunk-boundary prefix another worker (or an
            # earlier request) already computed: the snapshot holds the
            # rows a recomputation would write
            for c in range(task.num_chunks - 1, 0, -1):
                snap = self.engine.carry_get(
                    (bucket, toks[0, :c * ct].tobytes()))
                if snap is not None:
                    task.carry = snap
                    task.next_chunk = c
                    break
            if task.carry is None:
                task.carry = self.engine.carry_proto(bucket)
        self.task = task

    def tick(self, stats: DisaggStats
             ) -> Optional[Tuple[ServedRequest, HandoffBundle]]:
        """Advance the task one step: the whole prompt (blocking) or one
        chunk (chunked). Returns (request, bundle) on completion."""
        task = self.task
        eng = self.engine
        ct = eng.chunk_tokens
        t0 = time.time()
        if not ct:
            toks = torch.from_numpy(task.toks).long().to(eng.device)
            last_hidden, cache, _ = eng.run(toks, None, None, 0)
            task.dispatched = task.bucket
        else:
            lo = task.next_chunk * ct
            hi = min(lo + ct, task.bucket)
            span = torch.from_numpy(task.toks[:, lo:hi]).long().to(
                eng.device)
            task.carry, task.last_hidden = eng.chunk(span, task.carry, lo)
            if eng.device.type == "cuda":  # prefill_s counts device time
                torch.cuda.synchronize(eng.device)
            stats.prefill_chunks += 1
            task.dispatched += hi - lo
            if hi < task.bucket:
                eng.carry_put((task.bucket, task.toks[0, :hi].tobytes()),
                              task.carry, hi)
            task.next_chunk += 1
            if task.next_chunk < task.num_chunks:
                stats.prefill_s += time.time() - t0
                return None
            # the cache may share the carry's storage; the carry is
            # dropped here, so the bundle owns it
            cache = eng.finalize(task.carry)
            task.carry = None
            last_hidden = task.last_hidden
        bundle = HandoffBundle(rid=task.r.rid, toks=task.toks,
                               bucket=task.bucket, cache=cache,
                               logits=eng.logits(last_hidden),
                               prefilled=task.dispatched)
        stats.prefill_s += time.time() - t0
        stats.prefill_tokens += task.dispatched
        self.task = None
        return task.r, bundle


class DecodeWorker:
    """One decode pool member: a full Scheduler whose queue stays empty.
    Requests enter only through `admit_external` and leave by finishing,
    or by the worker dying: then its slots are abandoned and its live
    cache and snapshots freed (`release`), like a lost host's memory,
    while its counters stay readable."""

    def __init__(self, wid: int, sched: Scheduler, step_mode: str = "roll"):
        if step_mode not in ("roll", "token"):
            raise ValueError(f"unknown decode step_mode {step_mode!r}; "
                             "expected 'roll' or 'token'")
        self.wid = wid
        self.sched = sched
        self.step_mode = step_mode
        self.alive = True
        self.draining = False
        self.straggle_factor = 1.0
        self.flakes_pending = 0
        self.admitted = 0

    @property
    def name(self) -> str:
        return f"decode:{self.wid}"

    @property
    def load(self) -> int:
        return sum(1 for r in self.sched._slots if r is not None)

    def free_slots(self) -> List[int]:
        return self.sched.free_slots()

    def in_flight(self) -> List[ServedRequest]:
        """Resident requests in slot order (deterministic requeue order)."""
        return [r for r in self.sched._slots if r is not None]

    def admit(self, r: ServedRequest, bundle: HandoffBundle, *,
              plan_built: bool, prefilled: int) -> List[StreamEvent]:
        slot = self.free_slots()[0]
        self.admitted += 1
        return self.sched.admit_external(
            r, slot, bundle.cache, bundle.logits, bundle.toks,
            bundle.bucket, prefilled=prefilled, plan_built=plan_built,
            start_emitted=True)

    def tick(self) -> List[StreamEvent]:
        """One decode advance: a rolled drain tick (`_greedy_roll` over
        the smallest remaining budget) or one per-token step. The two give
        the same tokens per slot; 'token' gives fault tests per-token kill
        granularity."""
        if self.step_mode == "roll":
            return self.sched._drain_tick()
        return self.sched.step()

    def release(self):
        """Free the dead worker's device state (live cache, full-prompt
        snapshots); `sched.stats` stays for `pool_stats`."""
        self.sched._live = None
        if self.sched.paged:
            self.sched._snapshots.clear()


def least_loaded(workers) -> Optional[object]:
    """Deterministic least-loaded pick: fewest resident requests, ties to
    the lowest worker id. Returns None if `workers` is empty."""
    best = None
    for w in workers:
        if best is None or (w.load, w.wid) < (best.load, best.wid):
            best = w
    return best


class DisaggScheduler:
    """Disaggregated prefill/decode serving control plane.

    The public surface mirrors the Scheduler: `submit()` enqueues,
    `tick()` advances every pool one step, `drain()` runs to completion,
    `stream()` yields events. Faults are injected via `fault_plan`;
    `clock` (the watchdog's durations) and `sleep` (the retry backoff)
    are injectable, so fault tests measure virtual seconds and never back
    off. Runs on the device of `params`; the decode workers and the
    prefill pool share one cast copy of them."""

    def __init__(self, cfg: ArchConfig, params, *,
                 prefill_workers: int = 1, decode_workers: int = 2,
                 slots_per_worker: int = 2, max_len: int = 512,
                 backend: str = "gather",
                 decode_sla: Optional[bool] = None,
                 prefill_bucket: Optional[int] = None,
                 compute_dtype=torch.bfloat16,
                 paged: Optional[bool] = None,
                 pool_pages: Optional[int] = None,
                 prefill_chunk_blocks: Optional[int] = None,
                 decode_step_mode: str = "roll",
                 fault_plan: Optional[FaultPlan] = None,
                 watchdog: Optional[StragglerWatchdog] = None,
                 max_requeues: int = 1, max_retries: int = 2,
                 clock=time.time, sleep=time.sleep):
        from repro_torch.core import backends as backend_registry
        from repro_torch.distributed import ctx

        ctx.require_unsharded("disaggregated serving (DisaggScheduler)")
        if prefill_workers < 1 or decode_workers < 1:
            raise ValueError("need at least one worker per pool (got "
                             f"prefill={prefill_workers}, "
                             f"decode={decode_workers})")
        backend = backend_registry.resolve(backend)
        cfg.sla.validate()
        if decode_sla is None:
            decode_sla = cfg.sla.decode_mode == "sla"
        if paged is None:
            paged = cfg.sla.paged
        if prefill_chunk_blocks is None:
            prefill_chunk_blocks = cfg.sla.prefill_chunk_blocks
        if paged:
            # the prefill pool must write the pages the decode workers'
            # paged Schedulers would
            cfg = lift_column_capacity(cfg)
        self.cfg = cfg
        self.mdl = registry.get_model(cfg)
        check_serving_family(cfg, self.mdl, "off", decode_sla,
                             continuous=True)
        self.backend = backend
        self.decode_sla = decode_sla
        self.paged = paged
        self.block = max(cfg.sla.block_q, 1)
        self.max_len = block_bucket(max_len, self.block) \
            if (decode_sla or paged) else max_len
        self.compute_dtype = compute_dtype
        self.device = params.embed.device
        if prefill_chunk_blocks is not None:
            if prefill_chunk_blocks < 1:
                raise ValueError(
                    f"prefill_chunk_blocks must be >= 1 (got "
                    f"{prefill_chunk_blocks})")
            chk = getattr(self.mdl, "check_chunked_prefill", None)
            if chk is None:
                raise ValueError(
                    f"prefill_chunk_blocks requires a model family with "
                    f"chunked prefill; family {cfg.family!r} has none")
            chk(cfg, backend)
        self._chunk_tokens = (prefill_chunk_blocks or 0) * self.block

        # the weights cast once, read by every worker
        self._cparams = self.mdl.compute_params(params, compute_dtype)
        # ONE engine shared by every prefill worker: carry snapshots
        # amortize across the pool, and prefill stays a pure function of
        # (padded prompt, bucket) with plan reuse off (requeue determinism)
        self._engine = PrefillEngine(
            cfg, params, self.mdl, backend=backend,
            compute_dtype=compute_dtype, decode_sla=decode_sla,
            max_len=self.max_len,
            drift_threshold=normalize_drift_threshold(cfg, None),
            plan_reuse="off", chunk_tokens=self._chunk_tokens,
            cparams=self._cparams)
        self._prefill_pool = [PrefillWorker(i, self._engine)
                              for i in range(prefill_workers)]
        # decode workers own their Schedulers outright: separate slots,
        # PagePools and live caches (one "host" each). Chunking happens on
        # the prefill pool and admission here is bundle-only, so the
        # workers get a cfg with the chunk default nulled out (an unpaged
        # Scheduler refuses chunking)
        dcfg = dataclasses.replace(
            cfg, sla=cfg.sla.replace(prefill_chunk_blocks=None))
        self._decode_pool = [
            DecodeWorker(
                i,
                Scheduler(dcfg, params, num_slots=slots_per_worker,
                          max_len=self.max_len, backend=backend,
                          decode_sla=decode_sla, plan_reuse="off",
                          prefill_bucket=prefill_bucket,
                          compute_dtype=compute_dtype, paged=paged,
                          pool_pages=pool_pages, cparams=self._cparams),
                step_mode=decode_step_mode)
            for i in range(decode_workers)]
        self.slots_per_worker = slots_per_worker

        self.stats = DisaggStats()
        self._faults = fault_plan or FaultPlan()
        self._watchdog = watchdog or StragglerWatchdog()
        self._max_requeues = max_requeues
        self._max_retries = max_retries
        self._clock = clock
        self._sleep = sleep
        self._tick_no = 0
        self._stall_ticks = 0

        self._queue: Deque[ServedRequest] = collections.deque()
        self._requests: List[ServedRequest] = []
        self._handoffs: Deque[Tuple[ServedRequest, HandoffBundle]] = \
            collections.deque()
        self._bundles: Dict[int, HandoffBundle] = {}
        self._owner: Dict[int, DecodeWorker] = {}
        self._requeue_counts: Dict[int, int] = {}
        self._started: Set[int] = set()
        self._admitted_once: Set[int] = set()
        self._next_rid = 0
        self._bucket = (block_bucket(prefill_bucket, self.block)
                        if prefill_bucket else None)

    # -- public API --------------------------------------------------------
    def submit(self, prompt, sampling: Optional[SamplingParams] = None
               ) -> int:
        """Enqueue one request; returns its rid. O(1), never blocks."""
        sampling = (sampling or SamplingParams()).validate()
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        bucket = max(block_bucket(len(prompt), self.block),
                     self._bucket or 0)
        need = bucket + sampling.max_new_tokens
        if need > self.max_len:
            raise ValueError(
                f"max_len={self.max_len} cannot hold a {len(prompt)}-token "
                f"prompt (shared prefill bucket {bucket}) plus "
                f"{sampling.max_new_tokens} new tokens; raise max_len to "
                f">= {need}")
        r = ServedRequest(rid=self._next_rid, prompt=prompt,
                          sampling=sampling)
        r.metrics.submit_t = time.time()
        self._next_rid += 1
        self._queue.append(r)
        self._requests.append(r)
        self.stats.submitted += 1
        return r.rid

    @property
    def has_work(self) -> bool:
        return (bool(self._queue) or bool(self._handoffs)
                or any(w.busy for w in self._prefill_pool if w.alive)
                or any(w.load for w in self._decode_pool if w.alive))

    def tick(self) -> List[StreamEvent]:
        """One control-plane step: fire due faults, advance the prefill
        pool one step each, route finished bundles to decode workers,
        advance every loaded decode worker one step (watchdogged)."""
        self._tick_no += 1
        self.stats.ticks += 1
        events: List[StreamEvent] = []
        for ev in self._faults.due(self._tick_no):
            self._apply_fault(ev)
        self._prefill_tick(events)
        self._assign_handoffs(events)
        self._decode_tick(events)
        if events:
            self._stall_ticks = 0
        else:
            self._stall_ticks += 1
            if self._stall_ticks > 10_000 and self.has_work:
                raise RuntimeError(
                    "disaggregated scheduler made no progress for 10000 "
                    "ticks with work pending — a pool is wedged (all "
                    "workers draining with full slots, or a fault left no "
                    "capacity)")
        return events

    def drain(self) -> List[ServedRequest]:
        """Run to completion; returns all requests in submission order."""
        while self.has_work:
            self.tick()
        return list(self._requests)

    def stream(self) -> Iterator[StreamEvent]:
        while self.has_work:
            yield from self.tick()

    def decode_occupancy(self) -> float:
        """Pool-wide decode-slot utilization: active slot-steps over total
        slot-steps, summed over every decode worker that ever stepped
        (dead workers' history included: their steps happened)."""
        act = sum(w.sched.stats.slot_steps_active for w in self._decode_pool)
        tot = sum(w.sched.stats.slot_steps_total for w in self._decode_pool)
        return act / max(1, tot)

    def pool_stats(self) -> dict:
        """Per-worker breakdown for reporting (serve CLI)."""
        return {
            "prefill": [{"worker": w.name, "alive": w.alive,
                         "busy": w.busy}
                        for w in self._prefill_pool],
            "decode": [{"worker": w.name, "alive": w.alive,
                        "draining": w.draining, "admitted": w.admitted,
                        "occupancy": w.sched.stats.occupancy(),
                        "decode_tokens": w.sched.stats.decode_tokens}
                       for w in self._decode_pool],
        }

    # -- fault machinery ---------------------------------------------------
    def _apply_fault(self, ev: FaultEvent):
        pool = (self._prefill_pool if ev.pool == "prefill"
                else self._decode_pool)
        if not (0 <= ev.worker < len(pool)):
            raise ValueError(
                f"FaultPlan names {ev.pool} worker {ev.worker}, but the "
                f"pool has {len(pool)} workers")
        w = pool[ev.worker]
        if ev.kind == "straggle":
            w.straggle_factor = ev.factor
        elif ev.kind == "flake":
            w.flakes_pending += ev.failures
        elif ev.kind == "kill":
            self._kill_worker(ev.pool, w)

    def _kill_worker(self, pool: str, w):
        """Hard worker loss: the worker's compute state (slots, pages,
        live cache / prefill carry) is abandoned, and every in-flight
        request is reset to an un-admitted state and requeued: from its
        retained handoff bundle if one exists (decode loss), from scratch
        otherwise (prefill loss). A request over its requeue budget goes
        back to the QUEUE (never a half-admitted slot) and the loss is
        raised."""
        if not w.alive:
            return
        w.alive = False
        self.stats.kills += 1
        lost: List[Tuple[ServedRequest, Optional[HandoffBundle]]] = []
        if pool == "prefill":
            if w.task is not None:
                lost.append((w.task.r, None))
                w.task = None
        else:
            lost = [(r, self._bundles.get(r.rid)) for r in w.in_flight()]
            w.release()
        over: List[int] = []
        for r, bundle in reversed(lost):  # appendleft preserves order
            self._owner.pop(r.rid, None)
            n = self._requeue_counts.get(r.rid, 0) + 1
            self._requeue_counts[r.rid] = n
            # back to exactly the pre-admission state, so a replay (or a
            # re-prefill) regenerates the trajectory from token 0
            r.state = RequestState.QUEUED
            r.slot = None
            r.tokens_out.clear()
            r.metrics.decode_tokens = 0
            r.metrics.first_token_t = 0.0
            r.metrics.finish_t = 0.0
            if n > self._max_requeues:
                self._bundles.pop(r.rid, None)
                self._queue.appendleft(r)
                over.append(r.rid)
                continue
            self.stats.requeues += 1
            if bundle is not None:
                self._handoffs.appendleft((r, bundle))
            else:
                self._queue.appendleft(r)
        if over:
            raise RuntimeError(
                f"request(s) {over} lost worker {w.name} after exceeding "
                f"max_requeues={self._max_requeues}; they were returned to "
                f"the queue (state QUEUED, no slot, no partial tokens) — "
                f"restore capacity and drain again, nothing is "
                f"half-admitted")

    def _worker_tick(self, w, fn):
        """Run one worker step under the retry contract: a pending
        injected flake raises `InjectedFault` before the step runs and is
        retried with the injected sleep. An error of the step itself is
        not retried: the step may already have written pages, positions
        or a carry, and a second run would start from that half-written
        state."""
        def attempt():
            if w.flakes_pending > 0:
                w.flakes_pending -= 1
                raise InjectedFault(
                    f"injected transient fault: {w.name} at tick "
                    f"{self._tick_no}")
            return fn()
        return run_with_retries(attempt, max_retries=self._max_retries,
                                on_retry=self._note_retry,
                                sleep=self._sleep,
                                retry_on=(InjectedFault,))

    def _note_retry(self, attempt: int, exc: Exception):
        self.stats.retries += 1

    # -- prefill pool ------------------------------------------------------
    def _prefill_tick(self, events: List[StreamEvent]):
        alive = [w for w in self._prefill_pool if w.alive]
        if not alive:
            if self._queue or any(w.busy for w in self._prefill_pool):
                raise RuntimeError(
                    "every prefill worker is dead with requests still "
                    "queued — no admission path remains")
            return
        for w in alive:
            if not w.busy and self._queue:
                self._assign_prefill(w, self._queue.popleft(), events)
        for w in alive:
            self.stats.prefill_steps_total += 1
            if not w.busy:
                continue
            self.stats.prefill_busy_steps += 1
            done = self._worker_tick(w, lambda w=w: w.tick(self.stats))
            if done is not None:
                r, bundle = done
                self.stats.handoffs += 1
                self._bundles[r.rid] = bundle
                self._handoffs.append((r, bundle))

    def _assign_prefill(self, w: PrefillWorker, r: ServedRequest,
                        events: List[StreamEvent]):
        r.state = RequestState.PREFILLING
        t0 = time.time()
        r.metrics.admit_t = t0
        plen = len(r.prompt)
        if self._bucket is None or plen > self._bucket:
            self._bucket = block_bucket(plen, self.block)
        if self._bucket + r.sampling.max_new_tokens > self.max_len:
            # the same no-limbo contract as Scheduler._admit_next: the
            # request goes back to the queue head BEFORE the raise
            self._queue.appendleft(r)
            r.state = RequestState.QUEUED
            raise ValueError(
                f"max_len={self.max_len} cannot hold request {r.rid}: the "
                f"shared prefill bucket grew to {self._bucket} and "
                f"{r.sampling.max_new_tokens} new tokens no longer fit; "
                f"raise max_len to >= "
                f"{self._bucket + r.sampling.max_new_tokens}")
        toks = np.zeros((1, self._bucket), np.int32)
        toks[0, self._bucket - plen:] = r.prompt  # left-pad
        w.assign(r, toks, self._bucket)
        if r.rid not in self._started:
            self._started.add(r.rid)
            events.append(StreamEvent(rid=r.rid, kind="start", t=t0))

    # -- decode pool -------------------------------------------------------
    def _pick_decode_worker(self) -> Optional[DecodeWorker]:
        """Least-loaded live worker with a free slot; draining workers are
        skipped unless they are the ONLY live capacity (no lost request
        beats a clean drain)."""
        ready = [w for w in self._decode_pool
                 if w.alive and not w.draining and w.free_slots()]
        if ready:
            return least_loaded(ready)
        if not any(w.alive and not w.draining for w in self._decode_pool):
            fallback = [w for w in self._decode_pool
                        if w.alive and w.free_slots()]
            if fallback:
                self.stats.drain_fallbacks += 1
                return least_loaded(fallback)
        return None

    def _assign_handoffs(self, events: List[StreamEvent]):
        while self._handoffs:
            if not any(w.alive for w in self._decode_pool):
                raise RuntimeError(
                    "every decode worker is dead with prefilled requests "
                    "awaiting handoff — no decode path remains")
            w = self._pick_decode_worker()
            if w is None:
                return  # no free slot this tick; bundles wait
            r, bundle = self._handoffs.popleft()
            first = r.rid not in self._admitted_once
            self._admitted_once.add(r.rid)
            self._owner[r.rid] = w
            evs = w.admit(r, bundle, plan_built=first,
                          prefilled=bundle.prefilled if first else 0)
            self._collect(evs, events)

    def _decode_tick(self, events: List[StreamEvent]):
        for w in self._decode_pool:
            if not w.alive or w.load == 0:
                continue
            t0 = self._clock()
            evs = self._worker_tick(w, w.tick)
            dur = (self._clock() - t0) * w.straggle_factor
            self._collect(evs, events)
            if self._watchdog.record(dur, host_id=w.wid) \
                    and not w.draining:
                w.draining = True
                self.stats.straggler_drains += 1

    def _collect(self, evs: List[StreamEvent], events: List[StreamEvent]):
        for ev in evs:
            if ev.kind == "finish":
                self.stats.completed += 1
                self._bundles.pop(ev.rid, None)
                self._owner.pop(ev.rid, None)
        events.extend(evs)
