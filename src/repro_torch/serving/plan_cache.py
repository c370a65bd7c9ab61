"""Cross-request SLA plan cache.

Per-(layer, head) block-sparsity patterns repeat across requests, not
just across adjacent timesteps (Sparse-vDiT, arXiv:2506.03065), so a
multi-user denoise service can share SLA's planning fleet-wide. This
module is a small LRU store of per-(layer, timestep-bucket) `SLAPlan`
rows, keyed by `core.plan.plan_compat_key` (the config and shape fields
under which two plans are interchangeable) plus a coarse timestep
bucket.

Reuse is validated, never blind: the DiffusionScheduler hands a cached
stack to the request's first forward with a drift threshold, and
`refresh_plan` decides per layer whether the cached structure still
fits the new sample's (q, k). Layers that re-plan count as
invalidations (their fresh rows are written back); layers that hold
count as validated reuse. Entries are stored serialized
(`core.plan.serialize_plan`: host numpy, no device memory) and
round-trip bitwise through `deserialize_plan`.

Keys are (compat, layer, bucket), but the scheduler reads and writes
whole per-layer stacks, so `get` hits only when every layer of a bucket
is present (the LRU may evict a bucket in part; the next lookup then
misses and fills it whole).

Counterpart of `repro.serving.plan_cache`: the same LRU, counters and
errors. `get` returns the stack on the device the cache was built for.
"""
from __future__ import annotations

import collections
from typing import Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import plan as plan_lib
from repro_torch.core.config import SLAConfig


class PlanCache:
    """LRU cache of per-(layer, timestep-bucket) serialized SLAPlan rows.

    Counters (all monotonic):
      hits / misses      — whole-bucket lookups at request admission
      invalidations      — cached layers whose drift validation re-planned
      evictions          — per-(layer, bucket) entries dropped by the LRU
      puts               — per-(layer, bucket) entries written
    """

    def __init__(self, cfg: SLAConfig, num_layers: int, *,
                 t_buckets: int = 8, max_entries: int = 256, device=None):
        if t_buckets < 1:
            raise ValueError(f"t_buckets must be >= 1 (got {t_buckets})")
        if max_entries < num_layers:
            raise ValueError(
                f"max_entries ({max_entries}) < num_layers ({num_layers}) "
                "— the LRU could never hold one complete bucket")
        self.cfg = cfg
        self.num_layers = int(num_layers)
        self.t_buckets = int(t_buckets)
        self.max_entries = int(max_entries)
        self.device = resolve_device(device)
        # key (compat, layer, bucket) -> serialized plan dict; ordered
        # oldest-first (move_to_end marks recency)
        self._entries: "collections.OrderedDict[tuple, dict]" = \
            collections.OrderedDict()
        self._compat: Optional[tuple] = None
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self.evictions = 0
        self.puts = 0

    def __len__(self) -> int:
        return len(self._entries)

    def bucket(self, t: float) -> int:
        """Timestep t in (0, 1] -> bucket id in [0, t_buckets)."""
        return int(min(max(float(t), 0.0) * self.t_buckets,
                       self.t_buckets - 1))

    def host_bytes(self) -> int:
        """Host memory the entries' leaves hold."""
        return sum(a.nbytes for e in self._entries.values()
                   for name, a in e.items() if name != "__version__")

    def _check_compat(self, plan_stack) -> tuple:
        # leaves are (L, 1, H, Tm, Tn) — static facts off the mc leaf
        _, _, h, tm, tn = plan_stack.mc.shape
        key = plan_lib.plan_compat_key(self.cfg, h, tm, tn)
        if self._compat is None:
            self._compat = key
        elif key != self._compat:
            raise ValueError(
                f"plan incompatible with cache: {key} != {self._compat}")
        return key

    def _present(self, bucket: int) -> bool:
        return self._compat is not None and all(
            (self._compat, layer, bucket) in self._entries
            for layer in range(self.num_layers))

    # -- whole-stack API (what the DiffusionScheduler speaks) ------------
    def get(self, bucket: int):
        """Stacked per-layer plans (leaves (L, 1, ...)) for `bucket` on
        the cache's device, or None. Counts one hit or miss; a hit
        refreshes LRU recency for every layer of the bucket."""
        if not self._present(bucket):
            self.misses += 1
            return None
        self.hits += 1
        rows = []
        for layer in range(self.num_layers):
            key = (self._compat, layer, bucket)
            self._entries.move_to_end(key)
            rows.append(plan_lib.deserialize_plan(self._entries[key],
                                                  self.device))
        return plan_lib.plan_map(lambda *ls: torch.cat(ls, dim=0), *rows)

    def put(self, bucket: int, plan_stack) -> None:
        """Store a per-layer stack (leaves (L, 1, ...)) under `bucket`,
        overwriting any existing layers and evicting LRU overflow."""
        self._check_compat(plan_stack)
        for layer in range(self.num_layers):
            self._store(layer, bucket, plan_stack)
        self._evict()

    def put_if_absent(self, bucket: int, plan_stack) -> bool:
        """`put` unless the bucket is already fully present (counts no
        hit or miss: this is filling as requests cross bucket boundaries
        mid-flight, not a lookup)."""
        if self._present(bucket):
            return False
        self.put(bucket, plan_stack)
        return True

    def update(self, bucket: int, plan_stack, replanned) -> int:
        """Write back drift-invalidated layers after a validated reuse.

        `replanned`: (L,) bools from the forward's drift info — True
        layers had their cached structure rejected and rebuilt; their
        fresh rows replace the cached entries and count as
        invalidations. Returns the invalidation count."""
        self._check_compat(plan_stack)
        flags = np.asarray(replanned).reshape(self.num_layers, -1)
        flags = flags.any(axis=1)
        n = 0
        for layer in range(self.num_layers):
            if flags[layer]:
                self._store(layer, bucket, plan_stack)
                n += 1
        self.invalidations += n
        self._evict()
        return n

    # -- internals -------------------------------------------------------
    def _store(self, layer: int, bucket: int, plan_stack) -> None:
        key = (self._compat, layer, bucket)
        row = plan_lib.plan_map(lambda leaf: leaf[layer:layer + 1],
                                plan_stack)
        self._entries[key] = plan_lib.serialize_plan(row)
        self._entries.move_to_end(key)
        self.puts += 1

    def _evict(self) -> None:
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)
            self.evictions += 1

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "invalidations": self.invalidations,
                "evictions": self.evictions, "puts": self.puts,
                "entries": len(self._entries)}
