"""Global KV page pool: refcounted block_kv-sized pages + prefix interning.

Counterpart of `repro.serving.pages`, copied: pure-Python host
bookkeeping with the same invariants. Device state lives in the paged
cache built by `models.transformer.make_paged_cache`: per-layer page
pools `kp`/`vp` (and, under decode-SLA, the pooled per-block H/Z/kpool
partials `slap`) indexed by ONE per-slot page table
`pt[slot, logical_block] -> physical_page`. This module owns the
allocation story:

  * `PagePool`: a fixed set of physical page ids with reference counts.
    Page 0 is the permanent all-zero page (never allocated, never
    written); the scheduler additionally pins one private scratch page
    per slot so inactive slots, which keep stepping through every
    batched decode dispatch, always have a harmless write target.
  * Prefix interning: prompt prefixes are keyed by the raw bytes of the
    left-padded token prefix up to each page boundary (exact content
    match, no hash collisions). Causal attention makes page j's KV (and
    its h/z partials) a pure function of the padded tokens below
    (j + 1) * page_size at fixed positions, so two prompts sharing those
    bytes may share the physical page. The index holds its own reference
    on every interned page, so shared prefixes survive request turnover;
    index-only pages are evicted LRU under pool pressure.
  * Copy-on-write: a slot about to WRITE into a page it does not own
    exclusively (refs > 1, or the zero page) asks `ensure_private` for a
    fresh page id; the scheduler then copies the old page's contents on
    the device. Fresh decode pages are copies of the zero page: the
    per-block H/Z partials accumulate onto the page, so a recycled page
    must start zeroed.

Exhaustion is loud: `alloc` raises `PagePoolExhausted` once every page is
referenced and nothing is evictable; pages are never silently reused
while referenced.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

ZERO_PAGE = 0


class PagePoolExhausted(RuntimeError):
    """Raised when an allocation cannot be served: every physical page
    is referenced and the prefix index has nothing evictable."""


@dataclasses.dataclass
class PageStats:
    """Host-side page accounting (mirrored into ServeStats)."""

    allocs: int = 0
    frees: int = 0
    cow_copies: int = 0
    prefix_hits: int = 0
    prefix_misses: int = 0
    evictions: int = 0


class PagePool:
    """Refcounted physical-page allocator with byte-keyed prefix interning.

    ``num_pages`` counts ALL physical pages including the zero page;
    ids are ``0 .. num_pages - 1``.  The pool never touches device
    memory — callers translate (old_pid, new_pid) decisions into page
    copies/zero-fills against the device pools.
    """

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(
                f"page pool needs >= 2 pages (zero page + 1), got {num_pages}")
        self.num_pages = int(num_pages)
        self._refs = [0] * self.num_pages
        self._refs[ZERO_PAGE] = 1  # permanently pinned
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))
        # prefix interning: key bytes -> pid; the index holds one ref per
        # entry.  _lru orders index-only candidates for eviction.
        self._index: Dict[bytes, int] = {}
        self._by_pid: Dict[int, bytes] = {}
        self._lru: "collections.OrderedDict[bytes, None]" = (
            collections.OrderedDict())
        self.stats = PageStats()

    # -- core refcounting ---------------------------------------------------
    def refs(self, pid: int) -> int:
        return self._refs[pid]

    def in_use(self) -> int:
        """Pages with at least one reference (including zero page)."""
        return sum(1 for r in self._refs if r > 0)

    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self) -> int:
        """Return a fresh page id with refcount 1.

        Evicts least-recently-used index-only interned pages if the
        free list is empty; raises PagePoolExhausted when nothing can
        be evicted."""
        if not self._free and not self._evict_one():
            raise PagePoolExhausted(
                f"page pool exhausted: all {self.num_pages} pages "
                f"referenced (no evictable interned pages)")
        pid = self._free.pop()
        assert self._refs[pid] == 0, (pid, self._refs[pid])
        self._refs[pid] = 1
        self.stats.allocs += 1
        return pid

    def retain(self, pid: int) -> int:
        if self._refs[pid] <= 0:
            raise ValueError(f"retain on unreferenced page {pid}")
        self._refs[pid] += 1
        return pid

    def release(self, pid: int) -> None:
        if pid == ZERO_PAGE:
            return
        if self._refs[pid] <= 0:
            raise ValueError(f"release on unreferenced page {pid}")
        self._refs[pid] -= 1
        if self._refs[pid] == 0:
            key = self._by_pid.get(pid)
            if key is not None:
                # should not happen: the index holds its own ref
                raise AssertionError(
                    f"interned page {pid} dropped to refcount 0")
            self._free.append(pid)
            self.stats.frees += 1
        elif self._refs[pid] == 1 and pid in self._by_pid:
            # only the index references it now -> eviction candidate
            self._lru[self._by_pid[pid]] = None

    # -- prefix interning ---------------------------------------------------
    def lookup(self, key: bytes) -> Optional[int]:
        """Return the interned pid for `key` (retaining it for the
        caller) or None on miss."""
        pid = self._index.get(key)
        if pid is None:
            self.stats.prefix_misses += 1
            return None
        self.stats.prefix_hits += 1
        self._lru.pop(key, None)  # referenced again: not evictable
        self._refs[pid] += 1
        return pid

    def intern(self, key: bytes, pid: int) -> None:
        """Publish `pid` (caller holds a ref) under `key`.  The index
        takes its own reference so the page outlives the request."""
        if key in self._index:
            return  # raced with itself across buckets; keep first
        if self._refs[pid] <= 0:
            raise ValueError(f"intern of unreferenced page {pid}")
        self._index[key] = pid
        self._by_pid[pid] = key
        self._refs[pid] += 1

    def _evict_one(self) -> bool:
        while self._lru:
            key, _ = self._lru.popitem(last=False)
            pid = self._index.get(key)
            if pid is None or self._refs[pid] != 1:
                continue  # stale candidate
            del self._index[key]
            del self._by_pid[pid]
            self._refs[pid] = 0
            self._free.append(pid)
            self.stats.frees += 1
            self.stats.evictions += 1
            return True
        return False

    # -- invariants ---------------------------------------------------------
    def check_invariants(self) -> None:
        """Assert every structural invariant the pool is built on; the
        property tests (tests/test_torch_pages.py) call this after
        every randomized operation.  Raises AssertionError with the
        violated condition spelled out.

        1. refcounts are never negative;
        2. the zero page is permanently pinned: refs >= 1, never on
           the free list, never interned;
        3. the free list is exactly the refcount-0 pages, each once;
        4. the intern index is a bijection (key <-> pid both ways) and
           every interned page holds at least the index's own ref;
        5. every LRU eviction candidate is index-only (refs == 1 and
           interned) or stale (already evicted/re-referenced — those
           are skipped lazily by _evict_one)."""
        assert all(r >= 0 for r in self._refs), \
            f"negative refcount: {self._refs}"
        assert self._refs[ZERO_PAGE] >= 1, "zero page lost its pin"
        assert ZERO_PAGE not in self._free, "zero page on the free list"
        assert ZERO_PAGE not in self._by_pid, "zero page interned"
        free_set = set(self._free)
        assert len(free_set) == len(self._free), \
            f"duplicate pids on the free list: {sorted(self._free)}"
        zero_ref = {pid for pid in range(self.num_pages)
                    if self._refs[pid] == 0}
        assert free_set == zero_ref, \
            (f"free list {sorted(free_set)} != refcount-0 pages "
             f"{sorted(zero_ref)}")
        assert len(self._index) == len(self._by_pid), \
            "intern index and reverse map disagree in size"
        for key, pid in self._index.items():
            assert self._by_pid.get(pid) == key, \
                f"intern bijection broken for pid {pid}"
            assert self._refs[pid] >= 1, \
                f"interned page {pid} has no reference"
        for key in self._lru:
            pid = self._index.get(key)
            if pid is not None:  # stale entries are legal (lazy purge)
                assert self._refs[pid] >= 1, \
                    f"LRU candidate {pid} unreferenced"

    # -- copy-on-write ------------------------------------------------------
    def ensure_private(self, pid: int) -> Tuple[int, Optional[int]]:
        """Make `pid` exclusively owned by the caller before a write.

        Returns (new_pid, copy_src): copy_src is None when the page was
        already private, else the page whose device contents must be
        copied into new_pid (the zero page for fresh decode pages —
        h/z partials accumulate onto the page, so recycled pages must
        start zeroed).  The caller's ref on the old page is released."""
        if self._refs[pid] == 1 and pid != ZERO_PAGE:
            return pid, None
        new_pid = self.alloc()
        self.release(pid)
        self.stats.cow_copies += 1
        return new_pid, pid
