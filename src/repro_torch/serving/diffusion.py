"""Streaming DiT denoise service.

Many users submit latents to denoise; the `DiffusionScheduler`
continuously batches them into ONE `dit.forward` per tick. Requests at
different timesteps share the batch: the timestep embedding, AdaLN
modulation and attention are row-independent, so a mixed-timestep batch
computes for each row what a batch-1 run at that row's t would.

  submit -> queue -> [admission: a batch-1 step-0 forward plans the
  request's per-layer SLAPlans and writes (latent, plans) into a free
  slot] -> per tick, ONE batched forward + Euler update advances every
  active slot one step at its own (t, dt) -> a slot that reaches its
  request's num_steps retires and frees for the next admission.

Plan refresh inside the tick is per sample
(`plan.refresh_plan_per_sample`): "fixed" intervals become a per-slot
0/1 threshold vector, "adaptive" measures real drift, so one slot's
refresh never couples to its neighbours' and each request's trajectory
equals its own sequential `dit.sample` run.

Counterpart of `repro.serving.diffusion`. The cross-request plan cache
(`plan_cache=`) arrives with a later slice (ROADMAP.md queue 1, item 12).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Iterator, List, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core import plan as plan_lib
from repro_torch.models import dit
from repro_torch.serving.api import (RequestMetrics, RequestState,
                                     ServeStats, StreamEvent,
                                     normalize_drift_threshold)

__all__ = ["DenoiseParams", "DenoiseRequest", "DiffusionScheduler"]


@dataclasses.dataclass
class DenoiseParams:
    """Per-request denoise policy: num_steps Euler steps from t_start down
    to 0 (dt = t_start / num_steps); t_start < 1.0 is SDEdit-style
    partial denoise."""

    num_steps: int = 8
    t_start: float = 1.0

    def validate(self) -> "DenoiseParams":
        if self.num_steps < 1:
            raise ValueError(
                f"num_steps must be >= 1 (got {self.num_steps})")
        if not 0.0 < self.t_start <= 1.0:
            raise ValueError(
                f"t_start must be in (0, 1] (got {self.t_start})")
        return self


@dataclasses.dataclass
class DenoiseRequest:
    """A denoise request inside the scheduler."""

    rid: int
    latent: np.ndarray  # (N, patch_dim) noise / partially-denoised input
    params: DenoiseParams
    cond: Optional[np.ndarray] = None  # (Lc, d_model) text embeddings
    state: RequestState = RequestState.QUEUED
    steps_done: int = 0
    metrics: RequestMetrics = dataclasses.field(
        default_factory=RequestMetrics)
    slot: Optional[int] = None
    result: Optional[np.ndarray] = None  # (N, patch_dim) final latent


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class DiffusionScheduler:
    """Continuous batching for DiT denoising over a fixed slot pool.

    One batched (forward + Euler) tick serves every active slot; one
    batch-1 admission forward plans each incoming request's SLAPlans.
    Runs on the CUDA device unless `device` says otherwise; `params` (a
    `models.dit.DiT`) must already live there.
    """

    def __init__(self, cfg: ArchConfig, params: dit.DiT, *,
                 num_slots: int = 4, seq_len: int = 64,
                 backend: str = "gather", compute_dtype=torch.float32,
                 refresh_mode: Optional[str] = None,
                 refresh_interval: Optional[int] = None,
                 drift_threshold=None, plan_cache=None, device=None):
        from repro_torch.core import backends as backend_registry
        backend = backend_registry.resolve(backend)
        if cfg.family != "dit":
            raise ValueError(
                f"DiffusionScheduler serves the dit family only "
                f"(got family={cfg.family!r})")
        if plan_cache not in (None, False):
            raise NotImplementedError(
                "the cross-request plan cache is not ported yet: it "
                "arrives with the plan_extend / plan-cache slice "
                "(ROADMAP.md queue 1, item 12); pass plan_cache=None")
        cfg.sla.validate()
        want = resolve_device(device)
        pdev = next(params.parameters()).device
        if pdev.type != want.type or (want.index is not None
                                      and pdev != want):
            raise ValueError(f"params live on {pdev} but the scheduler "
                             f"runs on {want}")
        self.device = pdev
        self.cfg = cfg
        self.params = params
        self.num_slots = int(num_slots)
        self.seq_len = int(seq_len)
        self.backend = backend
        self.compute_dtype = compute_dtype
        self.sla_cfg = dataclasses.replace(cfg.sla, causal=False)
        if seq_len % self.sla_cfg.block_q or seq_len % self.sla_cfg.block_kv:
            raise ValueError(
                f"seq_len={seq_len} must be a multiple of the SLA block "
                f"sizes ({self.sla_cfg.block_q}, {self.sla_cfg.block_kv}) "
                "— the plan grid is block-aligned")
        mode = (cfg.sla.plan_refresh_mode if refresh_mode is None
                else refresh_mode)
        if mode not in ("fixed", "adaptive"):
            raise ValueError(f"unknown refresh_mode {mode!r}; "
                             "expected 'fixed' or 'adaptive'")
        self.refresh_mode = mode
        self.refresh_interval = max(1, int(
            cfg.sla.plan_refresh_interval if refresh_interval is None
            else refresh_interval))
        nl = cfg.num_layers
        thr = normalize_drift_threshold(cfg, drift_threshold)
        self._thr_layers = np.broadcast_to(
            np.asarray(thr, np.float32), (nl,)).copy()
        self.plan_needed = (cfg.attention_kind == "sla"
                            and self.sla_cfg.mode
                            not in ("full", "linear_only"))

        # live batched state: one latent row + one per-layer plan row per
        # slot; host-side f32 (t0, dt) bookkeeping per slot
        dev = self.device
        self._lat = torch.zeros((num_slots, seq_len, cfg.patch_dim),
                                dtype=torch.float32, device=dev)
        self._cond = (torch.zeros((num_slots, cfg.cond_len, cfg.d_model),
                                  dtype=torch.float32, device=dev)
                      if cfg.cross_attn else None)
        if self.plan_needed:
            tm = seq_len // self.sla_cfg.block_q
            tn = seq_len // self.sla_cfg.block_kv
            proto = plan_lib.empty_plan(self.sla_cfg, num_slots,
                                        cfg.num_heads, tm, tn, dev)
            self._plans = plan_lib.plan_map(
                lambda leaf: torch.stack([leaf] * nl), proto)
        else:
            self._plans = None
        self._t0 = np.zeros((num_slots,), np.float32)
        self._dt = np.zeros((num_slots,), np.float32)

        self._queue: Deque[DenoiseRequest] = deque()
        self._requests: List[DenoiseRequest] = []
        self._slots: List[Optional[DenoiseRequest]] = [None] * num_slots
        self._next_rid = 0
        self.stats = ServeStats()

    # -- device steps ------------------------------------------------------
    def _admit_fresh(self, lat1, t1, dt1, cond1):
        """Step 0 of a request's trajectory: plan + first Euler step,
        exactly `dit.sample`'s first step at batch 1."""
        out = dit.forward(self.params, self.cfg, lat1, t1,
                          cond1 if self.cfg.cross_attn else None,
                          self.compute_dtype, self.backend,
                          return_plans=self.plan_needed)
        vel, plans = out if self.plan_needed else (out, None)
        return lat1 - dt1[:, None, None] * vel.to(lat1.dtype), plans

    def _tick(self, tv, dtv, thr, mask):
        """ONE batched denoise step for every slot: mixed per-slot
        (t, dt), per-sample plan refresh, masked commit so retired/free
        rows keep their state untouched."""
        cond = self._cond if self.cfg.cross_attn else None
        info = None
        if self.plan_needed:
            vel, new_plans, info = dit.forward(
                self.params, self.cfg, self._lat, tv, cond,
                self.compute_dtype, self.backend, plans=self._plans,
                return_plans=True, drift_threshold=thr,
                per_sample_refresh=True)
        else:
            vel = dit.forward(self.params, self.cfg, self._lat, tv, cond,
                              self.compute_dtype, self.backend)
        new_lat = self._lat - dtv[:, None, None] * vel.to(self._lat.dtype)
        self._lat = torch.where(mask[:, None, None], new_lat, self._lat)
        if self.plan_needed:
            def sel(n, o):
                return torch.where(
                    mask.reshape((1, -1) + (1,) * (n.ndim - 2)), n, o)
            self._plans = plan_lib.plan_map(sel, new_plans, self._plans)
        return info

    # -- request surface ---------------------------------------------------
    def submit(self, latent, params: Optional[DenoiseParams] = None,
               cond=None) -> int:
        """Enqueue one denoise request; returns its rid. Never blocks."""
        params = (params or DenoiseParams()).validate()
        latent = np.asarray(latent, np.float32)
        if latent.shape != (self.seq_len, self.cfg.patch_dim):
            raise ValueError(
                f"latent shape {latent.shape} != scheduler's "
                f"({self.seq_len}, {self.cfg.patch_dim})")
        if cond is not None:
            if not self.cfg.cross_attn:
                raise ValueError(
                    f"{self.cfg.name} has no cross-attention; cond must "
                    "be None")
            cond = np.asarray(cond, np.float32)
            want = (self.cfg.cond_len, self.cfg.d_model)
            if cond.shape != want:
                raise ValueError(f"cond shape {cond.shape} != {want}")
        r = DenoiseRequest(rid=self._next_rid, latent=latent,
                           params=params, cond=cond)
        r.metrics.submit_t = time.time()
        self._next_rid += 1
        self._queue.append(r)
        self._requests.append(r)
        return r.rid

    @property
    def has_work(self) -> bool:
        return bool(self._queue) or any(r is not None for r in self._slots)

    def active_timesteps(self) -> List[Optional[float]]:
        """Current diffusion time per slot (None = free)."""
        return [float(self._slot_t(j)) if r is not None else None
                for j, r in enumerate(self._slots)]

    def _slot_t(self, j: int) -> np.float32:
        """t for slot j's NEXT step, positionally (t0 - steps*dt in f32)
        — the value `dit.sample`'s tvec(step) computes."""
        r = self._slots[j]
        return np.float32(self._t0[j]
                          - np.float32(r.steps_done) * self._dt[j])

    # -- admission ---------------------------------------------------------
    def _admit_next(self, slot: int, events: List[StreamEvent]):
        r = self._queue.popleft()
        r.state = RequestState.PREFILLING
        r.slot = slot
        t0 = time.time()
        r.metrics.admit_t = t0
        dev = self.device
        t_start = np.float32(r.params.t_start)
        dt = np.float32(t_start / np.float32(r.params.num_steps))
        lat1 = torch.from_numpy(r.latent[None]).to(dev)
        t1 = torch.full((1,), float(t_start), dtype=torch.float32,
                        device=dev)
        dt1 = torch.full((1,), float(dt), dtype=torch.float32, device=dev)
        cond1 = None
        if self.cfg.cross_attn:
            c = (r.cond if r.cond is not None
                 else np.zeros((self.cfg.cond_len, self.cfg.d_model),
                               np.float32))
            cond1 = torch.from_numpy(c[None]).to(dev)
        new_lat, plan_row = self._admit_fresh(lat1, t1, dt1, cond1)
        if self.plan_needed:
            self.stats.plan_builds += self.cfg.num_layers
        self._lat, self._plans = dit.insert_denoise_slot(
            self._lat, self._plans, slot, new_lat, plan_row)
        if self._cond is not None:
            self._cond[slot] = cond1[0]
        self._t0[slot] = t_start
        self._dt[slot] = dt
        self._slots[slot] = r
        r.steps_done = 1
        r.metrics.decode_tokens = 1
        r.state = RequestState.DECODING
        _sync(dev)
        now = time.time()
        r.metrics.first_token_t = now
        self.stats.admissions += 1
        self.stats.denoise_steps += 1
        events.append(StreamEvent(rid=r.rid, kind="start", t=t0))
        events.append(StreamEvent(rid=r.rid, kind="step", t=now, index=0))
        if r.steps_done >= r.params.num_steps:
            self._finish(slot, events)

    def _finish(self, slot: int, events: List[StreamEvent]):
        r = self._slots[slot]
        # a copy: on the CPU .numpy() would alias the live pool, which the
        # next admission overwrites in place
        r.result = dit.retire_denoise_slot(self._lat, slot).cpu().numpy() \
            .copy()
        r.state = RequestState.FINISHED
        r.metrics.finish_t = time.time()
        r.slot = None
        self._slots[slot] = None
        events.append(StreamEvent(rid=r.rid, kind="finish",
                                  t=r.metrics.finish_t))

    # -- the tick ----------------------------------------------------------
    @torch.no_grad()
    def step(self) -> List[StreamEvent]:
        """Admit queued requests into free slots, then run ONE batched
        denoise step over every active slot. Returns the events."""
        events: List[StreamEvent] = []
        for slot in range(self.num_slots):
            if self._slots[slot] is None and self._queue:
                self._admit_next(slot, events)
        active = [j for j in range(self.num_slots)
                  if self._slots[j] is not None]
        if not active:
            return events
        nl, ns = self.cfg.num_layers, self.num_slots
        tv = np.zeros((ns,), np.float32)
        mask = np.zeros((ns,), bool)
        thr = np.ones((nl, ns), np.float32)  # >= 1.0: inert rows
        for j in active:
            r = self._slots[j]
            tv[j] = self._slot_t(j)
            mask[j] = True
            if self.refresh_mode == "fixed":
                # 0.0 forces the row's re-plan, 1.0 pins reuse —
                # dit.sample's static schedule expressed per slot
                thr[:, j] = (0.0 if r.steps_done % self.refresh_interval
                             == 0 else 1.0)
            else:
                thr[:, j] = self._thr_layers
        dev = self.device
        t_wall = time.time()
        info = self._tick(torch.from_numpy(tv).to(dev),
                          torch.from_numpy(self._dt.copy()).to(dev),
                          torch.from_numpy(thr).to(dev),
                          torch.from_numpy(mask).to(dev))
        _sync(dev)
        self.stats.decode_s += time.time() - t_wall
        if info is not None:
            rep = info["replanned"].cpu().numpy()[:, active]
            n_replan = int(rep.sum())
            self.stats.plan_replans += n_replan
            self.stats.plan_reuses += nl * len(active) - n_replan
            self.stats.last_retention = float(
                np.min(info["retention"].cpu().numpy()[:, active]))
        self.stats.slot_steps_active += len(active)
        self.stats.slot_steps_total += self.num_slots
        self.stats.denoise_steps += len(active)
        now = time.time()
        for j in active:
            r = self._slots[j]
            r.steps_done += 1
            r.metrics.decode_tokens += 1
            events.append(StreamEvent(rid=r.rid, kind="step", t=now,
                                      index=r.steps_done - 1))
            if r.steps_done >= r.params.num_steps:
                self._finish(j, events)
        return events

    def drain(self) -> List[DenoiseRequest]:
        """Run until every submitted request has finished; returns all
        requests in submission order."""
        while self.has_work:
            self.step()
        return list(self._requests)

    def stream(self) -> Iterator[StreamEvent]:
        """Generator draining the scheduler one tick at a time."""
        while self.has_work:
            yield from self.step()
