"""Batched LM serving engine: request queue -> SLA prefill -> batched decode.

Counterpart of `repro.serving.engine`. The "static" policy groups requests
into fixed-size decode batches; prefill runs per group, then tokens are
decoded in lockstep until each request's budget (finished requests keep
computing, their sampling frozen). The "continuous" policy is a thin
wrapper over `serving.api.Scheduler` (one slot per batch lane, unpaged or
with `paged=True` the paged, prefix-shared KV cache): `run()` submits
every request and drains the scheduler, sharing its ServeStats.

Prefill plan reuse (`plan_reuse="adaptive"`): every prefill chunk is
padded to one static (batch, length) bucket; the per-layer SLA block
structure is planned on the first chunk and reused across later chunks,
re-planning a layer when its drift reaches `drift_threshold`.

Decode-time SLA (`decode_sla=True` or cfg.sla.decode_mode == "sla"):
prefill seeds a static-grid incremental block plan and the linear
branch's running H/Z state, and each decode step attends to the live
row's critical KV blocks plus an O(1) linear term instead of the whole
cache. ServeStats counts decode-plan builds, extends, replans and reuses.

The engine computes in bf16 over the f32 parameters, as the reference:
it casts the matmul weights to bf16 once at construction
(`transformer.compute_params`). The reference's rolled per-segment decode
(one traced loop per run of steps between request finishes) is a Python
loop here with the same segments. Chunked admission
(`prefill_chunk_blocks`, or a config with `sla.prefill_chunk_blocks`)
passes through to the continuous scheduler; the static engine refuses
it, as the reference does.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import registry
from repro_torch.models.common import logits_from_hidden
from repro_torch.serving.api import (RequestMetrics, SamplingParams,
                                     Scheduler, ServeStats, block_bucket,
                                     check_serving_family,
                                     normalize_drift_threshold,
                                     prefill_with_plan_reuse)

__all__ = ["Request", "ServeStats", "ServingEngine"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 16
    tokens_out: Optional[List[int]] = None
    latency_s: float = 0.0  # = metrics.latency_s
    metrics: Optional[RequestMetrics] = None


def _sync(t: torch.Tensor):
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


class ServingEngine:
    def __init__(self, cfg: ArchConfig, params, batch_size: int = 4,
                 max_len: int = 512, greedy: bool = True,
                 backend: str = "gather", plan_reuse: str = "off",
                 drift_threshold=None, decode_sla: bool = False,
                 scheduler: str = "static", paged: Optional[bool] = None,
                 pool_pages: Optional[int] = None,
                 prefill_chunk_blocks: Optional[int] = None):
        from repro_torch.core import backends as backend_registry
        backend = backend_registry.resolve(backend)  # fail loudly, early
        cfg.sla.validate()
        if plan_reuse not in ("off", "adaptive"):
            raise ValueError(
                f"unknown plan_reuse mode {plan_reuse!r}; expected "
                "'off' or 'adaptive'")
        if scheduler not in ("static", "continuous"):
            raise ValueError(
                f"unknown scheduler {scheduler!r}; expected 'static' or "
                "'continuous'")
        if paged is None:
            paged = cfg.sla.paged
        if paged and scheduler != "continuous":
            raise ValueError(
                "paged KV caching requires the continuous-batching "
                "scheduler (the static engine decodes group-local "
                "caches; there is no shared pool to page)")
        if prefill_chunk_blocks is None:
            prefill_chunk_blocks = cfg.sla.prefill_chunk_blocks
        if prefill_chunk_blocks is not None and scheduler != "continuous":
            raise ValueError(
                "chunked admission prefill (prefill_chunk_blocks) "
                "requires the continuous-batching scheduler: the static "
                "engine has no decode to interleave chunks with")
        self.paged = paged
        self.cfg = cfg
        self.params = params
        self.mdl = registry.get_model(cfg)
        self.batch_size = batch_size
        self.greedy = greedy
        self.backend = backend
        self.plan_reuse = plan_reuse
        self.scheduler = scheduler
        self.decode_sla = decode_sla or cfg.sla.decode_mode == "sla"
        self.drift_threshold = normalize_drift_threshold(cfg,
                                                         drift_threshold)
        if self.decode_sla:
            # decode-SLA block grids are static: the cache length must be
            # a whole number of SLA blocks
            max_len = block_bucket(max_len, cfg.sla.block_q)
        self.max_len = max_len
        self.stats = ServeStats()
        self._plans = None
        self._bucket: Optional[int] = None  # static prefill (len) bucket
        check_serving_family(cfg, self.mdl, plan_reuse, self.decode_sla,
                             continuous=scheduler == "continuous")
        self.device = params.embed.device
        if scheduler == "continuous":
            # run() becomes a thin wrapper: one slot per static-batch
            # lane, the same bucket policy, the SAME ServeStats object
            self._sched = Scheduler(
                cfg, params, num_slots=batch_size, max_len=max_len,
                backend=backend, decode_sla=self.decode_sla,
                plan_reuse=plan_reuse, drift_threshold=drift_threshold,
                paged=paged, pool_pages=pool_pages,
                prefill_chunk_blocks=prefill_chunk_blocks)
            self._sched.stats = self.stats
            return
        # families without a compute copy (rwkv6, hybrid, encdec) cast
        # each weight in its matmul, as the reference
        cast = getattr(self.mdl, "compute_params", None)
        self._cparams = params if cast is None else cast(params)
        # decode-SLA prefills seed the decode state against the final
        # cache length; plain prefills are grown by _grow_cache instead
        self._dkw = ({"decode_max_len": self.max_len} if self.decode_sla
                     else {})

    # ---- the reference's jitted entry points, as methods -------------
    @torch.no_grad()
    def _prefill(self, params, tokens):
        return self.mdl.prefill(params, self.cfg, tokens,
                                backend=self.backend, **self._dkw)

    @torch.no_grad()
    def _prefill_plan(self, params, tokens):
        return self.mdl.prefill(params, self.cfg, tokens,
                                backend=self.backend, return_plans=True,
                                **self._dkw)

    @torch.no_grad()
    def _prefill_reuse(self, params, tokens, plans):
        return self.mdl.prefill(params, self.cfg, tokens,
                                backend=self.backend, plans=plans,
                                drift_threshold=self.drift_threshold,
                                return_plans=True, **self._dkw)

    def _one(self, params, token, cache):
        if self.decode_sla:
            return self.mdl.decode_step(params, self.cfg, token, cache,
                                        backend=self.backend,
                                        drift_threshold=self.drift_threshold)
        return self.mdl.decode_step(params, self.cfg, token, cache)

    @torch.no_grad()
    def _decode_loop(self, params, token, cache, nsteps: int):
        """Greedy-decode `nsteps` tokens; returns (token, cache, buf) with
        the produced tokens in buf[:nsteps] (on the device, no sync)."""
        buf = torch.zeros((self.max_len, token.shape[0]), dtype=torch.long,
                          device=token.device)
        for i in range(nsteps):
            logits, cache = self._one(params, token, cache)
            token = logits.argmax(dim=-1)
            buf[i] = token
        return token, cache, buf

    # cache leaves _grow_cache knows: "k"/"v" are the (L, B, H, S, D) KV
    # slabs padded along their sequence axis; the rest pass through.
    _GROW_KV_KEYS = ("k", "v")
    _GROW_PASS_KEYS = ("pos", "sla")

    def _grow_cache(self, cache):
        """Pad the prefill cache out to max_len decode slots."""
        grown = {}
        for key, leaf in cache.items():
            if key in self._GROW_KV_KEYS:
                extra = self.max_len - leaf.shape[3]
                if extra > 0:
                    leaf = torch.nn.functional.pad(leaf, (0, 0, 0, extra))
                grown[key] = leaf
            elif key in self._GROW_PASS_KEYS:
                grown[key] = leaf
            else:
                raise ValueError(
                    f"_grow_cache: unknown cache leaf {key!r} — add it to "
                    f"_GROW_KV_KEYS (sequence-padded KV) or _GROW_PASS_KEYS "
                    f"(passed through) so it cannot be silently mis-padded")
        return grown

    def _prefill_bucket(self, requests: List[Request]) -> int:
        """Static prefill length shared by every chunk: the longest prompt
        rounded up to a whole number of SLA query blocks."""
        plen = max(len(r.prompt) for r in requests)
        return block_bucket(plen, self.cfg.sla.block_q)

    def run(self, requests: List[Request]) -> List[Request]:
        t_submit = time.time()
        for r in requests:
            if r.metrics is None:
                r.metrics = RequestMetrics(submit_t=t_submit)
        if self.scheduler == "continuous":
            return self._run_continuous(requests)
        if self.plan_reuse != "off" or self.decode_sla:
            # both plan reuse and decode-SLA need block-aligned static
            # prefill shapes (reused plans / the decode block grid)
            bucket = self._prefill_bucket(requests)
            if self._bucket is None or bucket > self._bucket:
                # a longer prompt grows the bucket; cached plans die
                self._plans = None
                self._bucket = bucket
            budget = max(r.max_new_tokens for r in requests)
            if self._bucket + budget > self.max_len:
                raise ValueError(
                    f"max_len={self.max_len} cannot hold the prefill "
                    f"bucket ({self._bucket} tokens — longest prompt "
                    f"rounded up to sla.block_q={self.cfg.sla.block_q}) "
                    f"plus {budget} decode tokens; raise max_len to >= "
                    f"{self._bucket + budget}")
        done: List[Request] = []
        for i in range(0, len(requests), self.batch_size):
            done.extend(self._run_group(requests[i: i + self.batch_size]))
        return done

    def _run_continuous(self, requests: List[Request]) -> List[Request]:
        """The v1 surface over the continuous scheduler."""
        rid_map = {}
        for r in requests:
            sid = self._sched.submit(
                r.prompt, SamplingParams(max_new_tokens=r.max_new_tokens))
            rid_map[sid] = r
        for sr in self._sched.drain():
            if sr.rid not in rid_map:
                continue  # finished in an earlier run() call
            r = rid_map[sr.rid]
            # keep the caller's (or run()'s) submission stamp: it predates
            # the scheduler's own submit() stamp
            sr.metrics.submit_t = r.metrics.submit_t
            r.tokens_out = list(sr.tokens_out)
            r.metrics = sr.metrics
            r.latency_s = sr.metrics.latency_s
        return requests

    def _run_prefill(self, toks: torch.Tensor):
        """Prefill one chunk, through the plan-reuse path when enabled.
        Returns last_hidden, cache."""
        if self.decode_sla:
            # each layer's decode plan is seeded (all prompt rows) here
            self.stats.decode_plan_builds += self.cfg.num_layers
        if self.plan_reuse == "off":
            return self._prefill(self._cparams, toks)
        last_hidden, cache, self._plans = prefill_with_plan_reuse(
            self._prefill_plan, self._prefill_reuse, self._cparams, toks,
            self._plans, self.stats, self.cfg.num_layers)
        return last_hidden, cache

    def _run_group(self, group: List[Request]) -> List[Request]:
        b = len(group)
        if self.plan_reuse == "off" and not self.decode_sla:
            bpad, plen = b, max(len(r.prompt) for r in group)
        else:
            # one static (batch, len) bucket for every chunk
            bpad, plen = self.batch_size, self._bucket
        toks = np.zeros((bpad, plen), np.int32)
        for j, r in enumerate(group):
            toks[j, plen - len(r.prompt):] = r.prompt  # left-pad
        for j in range(b, bpad):
            # surplus rows cycle real prompts (all-zero rows would feed
            # the min-over-batch drift metric garbage)
            toks[j] = toks[j % b]
        budget = max(r.max_new_tokens for r in group)
        t0 = time.time()
        for r in group:
            r.metrics.admit_t = t0
        self.stats.admissions += b
        last_hidden, cache = self._run_prefill(
            torch.from_numpy(toks).long().to(self.device))
        if not self.decode_sla:
            cache = self._grow_cache(cache)
        _sync(last_hidden)
        self.stats.prefill_tokens += b * plen
        self.stats.prefill_s += time.time() - t0

        # first token from the last hidden state
        with torch.no_grad():
            logits = logits_from_hidden(self._cparams, last_hidden)
        token = logits.argmax(dim=-1)
        outs = [[] for _ in group]
        alive = np.array([r.max_new_tokens for r in group])
        t0 = time.time()
        stream = [token.cpu().numpy()]  # token produced at step i
        now = time.time()
        for r in group:
            r.metrics.first_token_t = now
        # one decode loop per segment between distinct request finishes
        done = 0
        for fin in sorted(set(int(a) for a in alive)):
            n = fin - 1 - done
            if n > 0:
                token, cache, buf = self._decode_loop(self._cparams, token,
                                                      cache, n)
                stream.extend(buf[:n].cpu().numpy())  # syncs the segment
                done = fin - 1
            now = time.time()
            for j, r in enumerate(group):
                if alive[j] == fin:
                    r.metrics.finish_t = now
        for step in range(budget):
            for j in range(b):
                if step < alive[j]:
                    outs[j].append(int(stream[step][j]))
        # per-step accounting from the static schedule (the reference's)
        for step in range(1, budget):
            active = int((step < alive).sum())
            self.stats.decode_tokens += active
            self.stats.slot_steps_active += active
            self.stats.slot_steps_total += self.batch_size
        _sync(token)
        self.stats.decode_s += time.time() - t0
        if self.decode_sla:
            # this group's decode-plan counters (zeroed by its prefill)
            stc = cache["sla"]
            self.stats.decode_plan_extends += int(stc["extends"].sum())
            self.stats.decode_plan_replans += int(stc["replans"].sum())
            self.stats.decode_plan_reuses += int(stc["reuses"].sum())
            self.stats.decode_last_retention = float(stc["retention"].min())
        for j, r in enumerate(group):
            r.tokens_out = outs[j][: r.max_new_tokens]
            r.metrics.decode_tokens = len(r.tokens_out)
            r.latency_s = r.metrics.latency_s
        return group
