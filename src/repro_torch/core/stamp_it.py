"""Stamp-it reclamation (paper §3): the Stamp Pool + stamp-ordered retire
lists with amortized constant-time reclamation.

Protocol
--------
* enter critical region  -> push this thread's block into the Stamp Pool
                            (assigns a strictly-increasing stamp)
* retire(node)           -> tag node with ``highest_stamp()`` and append to
                            the thread-local retire list (which is therefore
                            sorted by stamp)
* leave critical region  -> remove block from the pool; reclaim the local
                            list prefix with ``stamp < lowest_stamp()``.
                            If remove() returned False and the local list
                            holds more than THRESHOLD (=20, paper's empirical
                            value) nodes, splice it onto the global retire
                            list as an *ordered sublist*.  If remove()
                            returned True (we were the last thread), reclaim
                            the global list: O(n + m) for n reclaimable nodes
                            in m sublists — no time spent on non-reclaimable
                            nodes, no scanning of other threads' references.
"""

from __future__ import annotations

import threading
from typing import Optional

from .atomics import AtomicInt, AtomicRef
from .interface import Reclaimer, ReclaimableNode, ThreadRecord
from .stamp_pool import Block, StampPool


class _Sublist:
    """An ordered (by stamp, ascending) sublist on the global retire list.

    The global list is a Treiber stack of sublists (lock-free push / steal).
    """

    __slots__ = ("head", "count", "next")

    def __init__(self, head: ReclaimableNode, count: int) -> None:
        self.head = head
        self.count = count
        self.next: Optional["_Sublist"] = None


class StampItReclaimer(Reclaimer):
    name = "stamp-it"
    region_required = True

    #: paper §3: static threshold with an empirical value of 20
    THRESHOLD = 20

    def __init__(self, max_threads: int = 256, threshold: int = THRESHOLD):
        super().__init__(max_threads)
        self.pool = StampPool()
        self.threshold = threshold
        self._global_top = AtomicRef(None)  # Treiber stack of _Sublist
        # perf counters for the amortized-O(1) experiment
        self.scan_steps = AtomicInt(0)      # nodes touched during reclaim
        self.reclaim_calls = AtomicInt(0)

    # ------------------------------------------------------------------
    # Region protocol
    # ------------------------------------------------------------------
    def _on_thread_attach(self, rec: ThreadRecord) -> None:
        if "block" not in rec.scheme_state:
            rec.scheme_state["block"] = Block(f"T{rec.index}")

    def _enter_region(self, rec: ThreadRecord) -> None:
        self.pool.push(rec.scheme_state["block"])

    def _leave_region(self, rec: ThreadRecord) -> None:
        was_last = self.pool.remove(rec.scheme_state["block"])
        self._reclaim_local(rec)
        if was_last:
            self._reclaim_global()
        elif rec.retire_count > self.threshold:
            self._publish_local(rec)

    def _flush(self, rec: ThreadRecord) -> None:
        self._reclaim_local(rec)
        self._reclaim_global()

    # ------------------------------------------------------------------
    # Retire / reclaim
    # ------------------------------------------------------------------
    def _retire(self, rec: ThreadRecord, node: ReclaimableNode) -> None:
        node._retire_stamp = self.pool.highest_stamp()
        rec.retire_append(node)

    def _reclaim_local(self, rec: ThreadRecord) -> None:
        """Free the reclaimable prefix of the (stamp-sorted) local list.

        Runtime is linear in the number of nodes actually reclaimed — the
        paper's amortized-O(1) property (Prop. 2).
        """
        lowest = self.pool.lowest_stamp()
        self.reclaim_calls.fetch_add(1)
        node = rec.retire_head
        freed = 0
        while node is not None and node._retire_stamp < lowest:
            nxt = node._retire_next
            self._free(node)
            node = nxt
            freed += 1
        self.scan_steps.fetch_add(freed + (1 if node is not None else 0))
        rec.retire_head = node
        rec.retire_count -= freed
        if node is None:
            rec.retire_tail = None

    def _publish_local(self, rec: ThreadRecord) -> None:
        head, count = rec.retire_take_all()
        if head is None:
            return
        sub = _Sublist(head, count)
        while True:
            top = self._global_top.load()
            sub.next = top
            if self._global_top.compare_exchange(top, sub):
                return

    def _reclaim_global(self) -> None:
        """Reclaim the global list of ordered sublists: O(n + m).

        §4.4: after a pass, if the global lowest stamp advanced in the
        meantime, restart with the new stamp so end-of-run nodes are not
        stranded (Stamp-it's fix for the 'who reclaims last' race).
        """
        for _ in range(4):  # bounded restarts
            lowest = self.pool.lowest_stamp()
            top = self._global_top.exchange(None)
            if top is None:
                return
            survivors = []
            sub = top
            while sub is not None:
                node = sub.head
                freed = 0
                # sorted ascending: stop at the first non-reclaimable node
                while node is not None and node._retire_stamp < lowest:
                    nxt = node._retire_next
                    self._free(node)
                    node = nxt
                    freed += 1
                self.scan_steps.fetch_add(freed + (1 if node else 0))
                if node is not None:
                    survivors.append(_Sublist(node, sub.count - freed))
                sub = sub.next
            for s in survivors:
                while True:
                    top2 = self._global_top.load()
                    s.next = top2
                    if self._global_top.compare_exchange(top2, s):
                        break
            if self.pool.lowest_stamp() == lowest or not survivors:
                return

    # ------------------------------------------------------------------
    # Thread detach: hand the local list to the global list — the *last*
    # thread to leave takes responsibility (paper §4.4).
    # ------------------------------------------------------------------
    def _on_thread_detach(self, rec: ThreadRecord) -> None:
        assert rec.region_depth == 0, "detach inside a critical region"
        if rec.retire_head is not None:
            self._publish_local(rec)
        # Opportunistically reclaim what is already safe.
        self._reclaim_global()

    # ------------------------------------------------------------------
    # Introspection for tests/benchmarks
    # ------------------------------------------------------------------
    def global_list_size(self) -> int:
        n = 0
        sub = self._global_top.load()
        while sub is not None:
            node = sub.head
            while node is not None:
                n += 1
                node = node._retire_next
            sub = sub.next
        return n
