"""Michael-style lock-free hash map (fixed bucket array of list-based sets)
plus the FIFO-bounded variant used by the paper's HashMap benchmark (§4.1):
large nodes (partial results of a "simulation"), long guard lifetimes, and a
FIFO eviction policy keeping the entry count below a threshold — the
workload where reclamation efficiency differences dominate.
"""

from __future__ import annotations

from typing import Any, Optional

from ..atomics import AtomicInt
from ..interface import Reclaimer
from .list_set import HarrisMichaelListSet
from .queue import MichaelScottQueue


class HashMap:
    def __init__(self, reclaimer: Reclaimer, n_buckets: int = 2048) -> None:
        self.reclaimer = reclaimer
        self.n_buckets = n_buckets
        self.buckets = [HarrisMichaelListSet(reclaimer) for _ in range(n_buckets)]

    def _bucket(self, key: Any) -> HarrisMichaelListSet:
        return self.buckets[hash(key) % self.n_buckets]

    def get(self, key: Any) -> Optional[Any]:
        return self._bucket(key).get(key)

    def contains(self, key: Any) -> bool:
        return self._bucket(key).contains(key)

    def insert(self, key: Any, value: Any = None) -> bool:
        return self._bucket(key).insert(key, value)

    def remove(self, key: Any) -> bool:
        return self._bucket(key).remove(key)


class BoundedHashMap(HashMap):
    """HashMap benchmark structure: capacity-bounded with FIFO eviction.

    Mirrors the paper's setup: 2048 buckets, max 10000 entries, payloads of
    1024 bytes; when the map is full the oldest key is evicted (its node
    retired through the reclamation scheme).
    """

    def __init__(
        self,
        reclaimer: Reclaimer,
        n_buckets: int = 2048,
        max_entries: int = 10000,
        payload_bytes: int = 1024,
    ) -> None:
        super().__init__(reclaimer, n_buckets)
        self.max_entries = max_entries
        self.payload_bytes = payload_bytes
        self.count = AtomicInt(0)
        self.fifo = MichaelScottQueue(reclaimer)

    def get_or_compute(self, key: Any) -> bytes:
        """Reuse a cached partial result or compute + publish it."""
        value = self.get(key)
        if value is not None:
            return value
        value = bytes(self.payload_bytes)  # the "expensive computation"
        if self.insert(key, value):
            self.fifo.enqueue(key)
            n = self.count.fetch_add(1) + 1
            while n > self.max_entries:
                old = self.fifo.dequeue()
                if old is None:
                    break
                if self.remove(old):
                    n = self.count.fetch_add(-1) - 1
                else:
                    n = self.count.load()
        else:
            # lost the race; reuse the winner's value
            cached = self.get(key)
            if cached is not None:
                value = cached
        return value
