"""Hazard Pointers (HP/HPR; Michael 2004), with the extended dynamic-K
variant the paper uses for the HashMap benchmark.

Each thread owns K hazard slots (grown on demand).  Protecting a node is the
classic publish-then-validate loop.  Retired nodes go to a thread-local list;
once it exceeds the threshold

    R = 100 + 2 * sum_i K_i            (paper §4.2)

the thread *scans the hazard slots of all threads* (the O(P) cost Stamp-it
avoids) and frees every retired node not currently protected.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..atomics import AtomicInt, AtomicRef, MarkedValue
from ..interface import Reclaimer, ReclaimableNode, ThreadRecord

INITIAL_K = 3  # queue/list need at most 3 simultaneous guards


class HazardPointerReclaimer(Reclaimer):
    name = "hpr"
    region_required = False
    protect_implies_safe = False  # guards work without explicit regions

    def __init__(self, max_threads: int = 256):
        super().__init__(max_threads)
        self.scan_steps = AtomicInt(0)
        self.reclaim_calls = AtomicInt(0)

    # ------------------------------------------------------------------
    def _on_thread_attach(self, rec: ThreadRecord) -> None:
        st = rec.scheme_state
        if "slots" not in st:
            st["slots"] = [AtomicRef(None) for _ in range(INITIAL_K)]
            st["free"] = list(range(INITIAL_K))
        st.setdefault("nslots", AtomicInt(len(st["slots"])))

    def _acquire_slot(self, rec: ThreadRecord) -> int:
        st = rec.scheme_state
        if not st["free"]:
            # dynamic extension (Michael's extended scheme)
            st["slots"].append(AtomicRef(None))
            st["free"].append(len(st["slots"]) - 1)
            st["nslots"].store(len(st["slots"]))
        return st["free"].pop()

    # ------------------------------------------------------------------
    # Regions are no-ops for HP (kept so region_guard is scheme-agnostic).
    # ------------------------------------------------------------------
    def _enter_region(self, rec: ThreadRecord) -> None:
        pass

    def _leave_region(self, rec: ThreadRecord) -> None:
        pass

    # ------------------------------------------------------------------
    def _protect(
        self, rec: ThreadRecord, cptr, expected
    ) -> Tuple[Optional[MarkedValue], Optional[int]]:
        idx = self._acquire_slot(rec)
        slot = rec.scheme_state["slots"][idx]
        while True:
            v = cptr.load()
            if v.obj is None:
                self._release_slot(rec, idx)
                if expected is not None and v != expected:
                    return None, None
                return v, None
            if expected is not None and v != expected:
                self._release_slot(rec, idx)
                return None, None
            slot.store(v.obj)
            if cptr.load() == v:
                return v, idx
            if expected is not None:
                # acquire_if_equal is single-shot (wait-free usable)
                slot.store(None)
                self._release_slot(rec, idx)
                return None, None

    def _unprotect(self, rec: ThreadRecord, value, slot) -> None:
        if slot is None:
            return
        rec.scheme_state["slots"][slot].store(None)
        self._release_slot(rec, slot)

    def _release_slot(self, rec: ThreadRecord, idx: int) -> None:
        rec.scheme_state["free"].append(idx)

    # ------------------------------------------------------------------
    def _threshold(self) -> int:
        total_k = 0
        for other in self._records:
            if other.in_use.load() == 1 and other.scheme_state:
                ns = other.scheme_state.get("nslots")
                total_k += ns.load() if ns else 0
        return 100 + 2 * total_k

    def _retire(self, rec: ThreadRecord, node: ReclaimableNode) -> None:
        rec.retire_append(node)
        if rec.retire_count >= self._threshold():
            self._scan(rec)

    def _scan(self, rec: ThreadRecord) -> None:
        """Collect all hazard pointers, free unprotected retired nodes."""
        self.reclaim_calls.fetch_add(1)
        hazards = set()
        for other in self._records:
            if other.in_use.load() != 1 or not other.scheme_state:
                continue
            slots = other.scheme_state.get("slots")
            if not slots:
                continue
            for s in list(slots):
                self.scan_steps.fetch_add(1)
                obj = s.load()
                if obj is not None:
                    hazards.add(id(obj))
        node = rec.retire_head
        rec.retire_head = rec.retire_tail = None
        rec.retire_count = 0
        while node is not None:
            nxt = node._retire_next
            self.scan_steps.fetch_add(1)
            if id(node) in hazards:
                node._retire_next = None
                rec.retire_append(node)
            else:
                self._free(node)
            node = nxt

    def _flush(self, rec: ThreadRecord) -> None:
        self._scan(rec)

    def _on_thread_detach(self, rec: ThreadRecord) -> None:
        # clear slots, scan once, then hand leftovers to the orphan list
        for s in rec.scheme_state.get("slots", []):
            s.store(None)
        self._scan(rec)
        rec.scheme_state["free"] = list(
            range(len(rec.scheme_state.get("slots", [])))
        )
        super()._on_thread_detach(rec)
