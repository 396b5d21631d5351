"""Interval-Based Reclamation (IR; Wen, Izraelevitz, Cai, Beadle & Scott,
PPoPP 2018) — BEYOND-PAPER: the paper cites IR as "too recent to be
considered" (§1); we add it to show the interface extends past the paper's
six competitors.

Idea: a global era clock advances every ``EPOCH_FREQ`` allocations.  Each
node records its *birth era*; retiring stamps its *retire era*, giving the
node a lifetime interval [birth, retire].  Readers publish a *reservation
interval* [lo, hi] of eras they may be reading from: entering a region
reserves [e, e]; every subsequent acquisition widens hi to the current era
(the paper's 2GEIBR variant).  A retired node is reclaimable iff its
lifetime interval overlaps NO thread's reservation — unlike HP this needs
no per-pointer publication, unlike ER a stalled reader only blocks nodes
whose lifetimes overlap its interval, not everything.
"""

from __future__ import annotations

from ..atomics import AtomicInt
from ..interface import Reclaimer, ReclaimableNode, ThreadRecord

#: advance the era every this many allocations (paper's epoch frequency)
EPOCH_FREQ = 64
#: attempt reclamation every this many retires
EMPTY_FREQ = 32


class IntervalReclaimer(Reclaimer):
    name = "ibr"
    region_required = True

    def __init__(self, max_threads: int = 256):
        super().__init__(max_threads)
        self.era = AtomicInt(1)
        self.scan_steps = AtomicInt(0)
        self.reclaim_calls = AtomicInt(0)
        self._alloc_count = AtomicInt(0)

    # ------------------------------------------------------------------
    def _on_thread_attach(self, rec: ThreadRecord) -> None:
        st = rec.scheme_state
        if "lo" not in st:
            st["lo"] = AtomicInt(0)  # 0 = no reservation
            st["hi"] = AtomicInt(0)

    def _enter_region(self, rec: ThreadRecord) -> None:
        e = self.era.load()
        rec.scheme_state["lo"].store(e)
        rec.scheme_state["hi"].store(e)

    def _leave_region(self, rec: ThreadRecord) -> None:
        rec.scheme_state["lo"].store(0)
        rec.scheme_state["hi"].store(0)
        self._reclaim(rec)

    def _protect(self, rec, cptr, expected):
        # widen the reservation to the current era before the read
        if rec.region_depth == 0:
            value, slot = super()._protect(rec, cptr, expected)
        else:
            rec.scheme_state["hi"].max_update(self.era.load())
            value, slot = super()._protect(rec, cptr, expected)
        return value, slot

    # ------------------------------------------------------------------
    def on_allocate(self, node: ReclaimableNode) -> None:
        super().on_allocate(node)
        node._birth_era = self.era.load()
        if self._alloc_count.fetch_add(1) % EPOCH_FREQ == EPOCH_FREQ - 1:
            self.era.fetch_add(1)

    def _retire(self, rec: ThreadRecord, node: ReclaimableNode) -> None:
        node._retire_stamp = self.era.load()  # retire era
        rec.retire_append(node)
        if rec.retire_count % EMPTY_FREQ == 0:
            self._reclaim(rec)

    # ------------------------------------------------------------------
    def _reservations(self):
        out = []
        for other in self._records:
            if other.in_use.load() != 1 or not other.scheme_state:
                continue
            st = other.scheme_state
            self.scan_steps.fetch_add(1)
            lo = st["lo"].load()
            if lo:
                out.append((lo, st["hi"].load()))
        return out

    def _reclaim(self, rec: ThreadRecord) -> None:
        self.reclaim_calls.fetch_add(1)
        res = self._reservations()
        node = rec.retire_head
        rec.retire_head = rec.retire_tail = None
        rec.retire_count = 0
        while node is not None:
            nxt = node._retire_next
            self.scan_steps.fetch_add(1)
            birth = node._birth_era
            retire = node._retire_stamp
            conflict = any(
                birth <= hi and lo <= retire for lo, hi in res
            )
            if conflict:
                node._retire_next = None
                rec.retire_append(node)
            else:
                self._free(node)
            node = nxt

    def _flush(self, rec: ThreadRecord) -> None:
        self.era.fetch_add(1)
        self._reclaim(rec)
