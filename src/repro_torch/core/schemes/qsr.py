"""Quiescent-State-Based Reclamation (QSR; McKenney & Slingwine 1998, RCU).

Each thread passes through a *quiescent state* when it exits a critical
region ("QSR executes a fuzzy barrier when it exits the critical region",
paper §4.2): it copies the global counter G into its announced counter q_i
and, if all participating threads have announced G, advances G.

A node retired while G == g is reclaimable once every participating thread
has announced a counter > g (i.e. passed a quiescent state after the
retire).  Threads that stop passing quiescent states stall reclamation
globally — the failure mode the paper demonstrates in the HashMap benchmark.
"""

from __future__ import annotations

from ..atomics import AtomicInt
from ..interface import Reclaimer, ReclaimableNode, ThreadRecord


class QuiescentStateReclaimer(Reclaimer):
    name = "qsr"
    region_required = True

    def __init__(self, max_threads: int = 256):
        super().__init__(max_threads)
        self.global_counter = AtomicInt(1)
        self.scan_steps = AtomicInt(0)
        self.reclaim_calls = AtomicInt(0)

    def _on_thread_attach(self, rec: ThreadRecord) -> None:
        st = rec.scheme_state
        # participating=1 while the thread may hold references; cleared on
        # detach so dead threads do not stall the grace period forever.
        st["q"] = AtomicInt(self.global_counter.load())
        st["participating"] = AtomicInt(0)

    def _enter_region(self, rec: ThreadRecord) -> None:
        rec.scheme_state["participating"].store(1)

    def _leave_region(self, rec: ThreadRecord) -> None:
        # fuzzy barrier: announce + maybe advance + reclaim
        st = rec.scheme_state
        g = self.global_counter.load()
        st["q"].store(g)
        self._try_advance(g)
        self._reclaim(rec)
        st["participating"].store(0)

    def _try_advance(self, g: int) -> None:
        for other in self._records:
            if other.in_use.load() != 1 or not other.scheme_state:
                continue
            st = other.scheme_state
            self.scan_steps.fetch_add(1)
            if st["participating"].load() == 1 and st["q"].load() < g:
                return
        self.global_counter.compare_exchange(g, g + 1)

    def _min_announced(self) -> int:
        lo = self.global_counter.load()
        for other in self._records:
            if other.in_use.load() != 1 or not other.scheme_state:
                continue
            st = other.scheme_state
            self.scan_steps.fetch_add(1)
            if st["participating"].load() == 1:
                lo = min(lo, st["q"].load())
        return lo

    def _flush(self, rec: ThreadRecord) -> None:
        for _ in range(3):
            g = self.global_counter.load()
            rec.scheme_state["q"].store(g)
            self._try_advance(g)
        self._reclaim(rec)

    def _retire(self, rec: ThreadRecord, node: ReclaimableNode) -> None:
        node._retire_stamp = self.global_counter.load()
        rec.retire_append(node)

    def _reclaim(self, rec: ThreadRecord) -> None:
        self.reclaim_calls.fetch_add(1)
        lo = self._min_announced()
        node = rec.retire_head
        freed = 0
        while node is not None and node._retire_stamp < lo:
            nxt = node._retire_next
            self._free(node)
            node = nxt
            freed += 1
        self.scan_steps.fetch_add(freed + (1 if node is not None else 0))
        rec.retire_head = node
        rec.retire_count -= freed
        if node is None:
            rec.retire_tail = None
