"""Epoch-Based Reclamation (ER, Fraser 2004) and New Epoch-Based
Reclamation (NER, Hart et al. 2007).

Shared machinery: a global epoch counter; each thread announces the epoch it
observed on critical-region entry together with an *active* flag.  The global
epoch may advance from ``e`` to ``e+1`` only when every active thread has
announced ``e``; a node retired in epoch ``e`` is reclaimable once the global
epoch reaches ``e+2`` (two grace periods).

ER vs NER (per Hart et al. and the paper's setup §4.2):
  * ER brackets *every operation* with a critical region (guards auto-enter),
    and attempts to advance the epoch every 100 region entries.
  * NER relies on explicit, application-sized critical regions
    (``region_guard`` spanning many operations) and additionally attempts to
    advance on demand when the local retire list grows.

The per-thread retire list is appended in retire order, so epochs are
monotonically non-decreasing along it and reclamation frees a prefix.
"""

from __future__ import annotations

from typing import Optional

from ..atomics import AtomicInt
from ..interface import Reclaimer, ReclaimableNode, ThreadRecord

#: paper §4.2: "ER/NER try to advance the epoch every 100 critical region
#: entries."
ADVANCE_INTERVAL = 100


class EpochReclaimer(Reclaimer):
    name = "er"
    region_required = True

    def __init__(self, max_threads: int = 256):
        super().__init__(max_threads)
        self.global_epoch = AtomicInt(0)
        self.scan_steps = AtomicInt(0)
        self.reclaim_calls = AtomicInt(0)

    # ------------------------------------------------------------------
    def _on_thread_attach(self, rec: ThreadRecord) -> None:
        st = rec.scheme_state
        if "epoch" not in st:
            st["epoch"] = AtomicInt(0)
            st["active"] = AtomicInt(0)
            st["entries"] = 0

    def _enter_region(self, rec: ThreadRecord) -> None:
        st = rec.scheme_state
        st["active"].store(1)
        st["epoch"].store(self.global_epoch.load())
        st["entries"] += 1
        if st["entries"] % ADVANCE_INTERVAL == 0:
            self._try_advance(rec)
            self._reclaim(rec)

    def _leave_region(self, rec: ThreadRecord) -> None:
        rec.scheme_state["active"].store(0)

    # ------------------------------------------------------------------
    def _try_advance(self, rec: ThreadRecord) -> bool:
        """Advance the global epoch iff all active threads observed it.

        This is the O(P) scan of *all threads* that Stamp-it avoids.
        """
        e = self.global_epoch.load()
        for other in self._records:
            if other.in_use.load() != 1:
                continue
            st = other.scheme_state
            if not st:
                continue
            self.scan_steps.fetch_add(1)
            if st["active"].load() == 1 and st["epoch"].load() != e:
                return False
        return self.global_epoch.compare_exchange(e, e + 1)

    def _flush(self, rec: ThreadRecord) -> None:
        for _ in range(3):
            self._try_advance(rec)
        self._reclaim(rec)

    def _retire(self, rec: ThreadRecord, node: ReclaimableNode) -> None:
        node._retire_stamp = self.global_epoch.load()
        rec.retire_append(node)
        # Also drain orphans opportunistically when the list grows.
        if rec.retire_count % 512 == 0 and self._orphans:
            self.adopt_orphans()

    def _reclaim(self, rec: ThreadRecord) -> None:
        self.reclaim_calls.fetch_add(1)
        safe_before = self.global_epoch.load() - 2
        node = rec.retire_head
        freed = 0
        while node is not None and node._retire_stamp <= safe_before:
            nxt = node._retire_next
            self._free(node)
            node = nxt
            freed += 1
        self.scan_steps.fetch_add(freed + (1 if node is not None else 0))
        rec.retire_head = node
        rec.retire_count -= freed
        if node is None:
            rec.retire_tail = None


class NewEpochReclaimer(EpochReclaimer):
    name = "ner"

    #: on-demand advance once the local list exceeds this many nodes
    RETIRE_THRESHOLD = 128

    def _retire(self, rec: ThreadRecord, node: ReclaimableNode) -> None:
        super()._retire(rec, node)
        if rec.retire_count >= self.RETIRE_THRESHOLD:
            self._try_advance(rec)
            self._reclaim(rec)

    def _leave_region(self, rec: ThreadRecord) -> None:
        super()._leave_region(rec)
        self._reclaim(rec)
