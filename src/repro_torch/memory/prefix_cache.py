"""FIFO-bounded prefix cache over KV pages.

The serving-layer analogue of the paper's HashMap benchmark (§4.1): entries
are expensive partial results (here: full KV pages of prompt-prefix
blocks), guards live long (an entry is pinned while any admission copies
from it), memory per node is significant (a page), and the entry count is
bounded with FIFO eviction.  Evicted pages retire through the BlockPool's
pluggable reclamation policy — reclamation efficiency differences between
stamp-it and the scan/epoch baselines show up directly as pool pressure.
"""

from __future__ import annotations

import threading
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence, Tuple

from .block_pool import BlockPool


def block_key(tokens: Sequence[int]) -> Tuple[int, ...]:
    return tuple(int(t) for t in tokens)


def prefix_block_keys(prompt: Sequence[int],
                      block: int) -> List[Tuple[int, ...]]:
    """Cache keys for every full leading block of ``prompt`` — THE
    definition of "a cached prefix", shared by admission (engine),
    routing (prefix-affinity) and migration so they can never disagree
    on what a prefix is."""
    return [
        block_key(prompt[: (i + 1) * block])
        for i in range(len(prompt) // block)
    ]


class PrefixCacheEntry:
    __slots__ = ("slot", "page", "pins")

    def __init__(self, slot: int, page: int) -> None:
        self.slot = slot
        self.page = page
        self.pins = 0


class PrefixCache:
    """Maps (prefix-hash of a full token block) -> cached page.

    Cached pages are *owned* by the cache (they are not freed when their
    originating request finishes); admissions COPY matching pages into the
    new request's own pages (cross-slot aliasing is not possible with
    per-slot pools — see DESIGN.md).  Eviction is FIFO; pinned entries are
    skipped until unpinned.
    """

    def __init__(self, pool: BlockPool, max_entries: int) -> None:
        self.pool = pool
        self.max_entries = max_entries
        self._lock = threading.Lock()
        self._map: "OrderedDict[Tuple, PrefixCacheEntry]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # evictions of pages a CoW fork branch still references: the
        # retire is DEFERRED by the policy's fork park-table until the
        # last branch releases (then the whole set retires as one batch)
        self.evicted_while_forked = 0

    def __len__(self) -> int:
        return len(self._map)

    # ------------------------------------------------------------------
    def lookup(self, keys: List[Tuple]) -> List[Optional[PrefixCacheEntry]]:
        """Pin + return entries for the leading block keys (prefix match
        stops at the first miss)."""
        out: List[Optional[PrefixCacheEntry]] = []
        with self._lock:
            for key in keys:
                e = self._map.get(key)
                if e is None:
                    self.misses += 1
                    break
                e.pins += 1
                self.hits += 1
                out.append(e)
        return out

    def unpin(self, entries: Sequence[PrefixCacheEntry]) -> None:
        with self._lock:
            for e in entries:
                e.pins -= 1

    # -- cluster-plane probes (router affinity / migration) ------------
    def keys(self) -> List[Tuple]:
        """All cached keys in insertion order (stat-neutral) — the
        drain-time migration's export list."""
        with self._lock:
            return list(self._map)

    def get(self, key: Tuple) -> Optional[PrefixCacheEntry]:
        """Stat-neutral lookup of a single key (no pin, no hit/miss)."""
        with self._lock:
            return self._map.get(key)

    def match_len(self, keys: Sequence[Tuple]) -> int:
        """Length of the leading cached run of ``keys`` — the router's
        prefix-affinity signal.  Stat-neutral: probing every replica must
        not skew the hit/miss counters admissions are measured by."""
        n = 0
        with self._lock:
            for key in keys:
                if key not in self._map:
                    break
                n += 1
        return n

    def acquire(self, keys: Sequence[Tuple]) -> List[PrefixCacheEntry]:
        """Pin + return the leading cached run (stat-neutral ``lookup``,
        for migration readers rather than admissions)."""
        out: List[PrefixCacheEntry] = []
        with self._lock:
            for key in keys:
                e = self._map.get(key)
                if e is None:
                    break
                e.pins += 1
                out.append(e)
        return out

    def remove(self, keys: Sequence[Tuple]) -> int:
        """Evict specific keys (migration source dropping its copy);
        pinned entries are skipped.  Pages retire through the policy as
        ONE batch (chunk-batched stamping: a single bookkeeping event
        however many blocks the prefix spans)."""
        removed = 0
        refs = []
        with self._lock:
            for key in keys:
                e = self._map.get(key)
                if e is None or e.pins > 0:
                    continue
                del self._map[key]
                if self.pool.fork_count((e.slot, e.page)):
                    self.evicted_while_forked += 1
                refs.append((e.slot, e.page))
                self.evictions += 1
                removed += 1
            if refs:
                self.pool.free_refs(refs)
        return removed

    # ------------------------------------------------------------------
    def insert(self, key: Tuple, slot: int, page: int) -> bool:
        """Take ownership of (slot, page) under ``key``.  Returns False if
        the key is already cached (caller keeps ownership)."""
        with self._lock:
            if key in self._map or self.max_entries == 0:
                return False
            while len(self._map) >= self.max_entries:
                evicted = self._evict_one_locked()
                if not evicted:
                    return False  # everything pinned; refuse
            self._map[key] = PrefixCacheEntry(slot, page)
            return True

    def _evict_one_locked(self) -> bool:
        for key, e in self._map.items():  # FIFO order
            if e.pins == 0:
                del self._map[key]
                # evict-while-forked is SAFE, not an error: the policy
                # parks the retire until the last fork ref releases
                if self.pool.fork_count((e.slot, e.page)):
                    self.evicted_while_forked += 1
                self.pool.free(e.slot, [e.page])  # retire via policy
                self.evictions += 1
                return True
        return False

    def drain(self) -> None:
        refs = []
        with self._lock:
            for key, e in list(self._map.items()):
                if e.pins == 0:
                    del self._map[key]
                    refs.append((e.slot, e.page))
                    self.evictions += 1
            if refs:
                self.pool.free_refs(refs)  # one retire batch, one stamp
