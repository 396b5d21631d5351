"""DEBRA (Brown, PODC 2015): distributed epoch-based reclamation.

Like ER, but the O(P) epoch-advance scan is *amortized*: instead of checking
all threads at once, each thread checks a single other thread per check
opportunity ("DEBRA checks the next thread every 20 critical region entries",
paper §4.2).  The global epoch advances once a thread has verified all P
records for the current epoch.  With many threads this delays epoch
advancement — the poor reclamation efficiency the paper measures at high
thread counts.

Retired nodes are tagged with the retire epoch; a node is reclaimable when
the global epoch is at least two ahead (limbo-bag rotation expressed as a
sorted-prefix free, equivalent because tags are monotone per thread).
"""

from __future__ import annotations

from ..atomics import AtomicInt
from ..interface import Reclaimer, ReclaimableNode, ThreadRecord

#: check one neighbour every this many region entries (paper §4.2)
CHECK_INTERVAL = 20


class DebraReclaimer(Reclaimer):
    name = "debra"
    region_required = True

    def __init__(self, max_threads: int = 256):
        super().__init__(max_threads)
        self.global_epoch = AtomicInt(0)
        self.scan_steps = AtomicInt(0)
        self.reclaim_calls = AtomicInt(0)

    def _on_thread_attach(self, rec: ThreadRecord) -> None:
        st = rec.scheme_state
        if "epoch" not in st:
            st["epoch"] = AtomicInt(0)
            st["quiescent"] = AtomicInt(1)
            st["entries"] = 0
            st["check_idx"] = 0
            st["checked"] = 0
            st["check_epoch"] = -1

    def _enter_region(self, rec: ThreadRecord) -> None:
        st = rec.scheme_state
        e = self.global_epoch.load()
        if st["epoch"].load() != e:
            # new epoch observed: rotate limbo (free e-2 prefix)
            self._reclaim(rec)
        st["epoch"].store(e)
        st["quiescent"].store(0)
        st["entries"] += 1
        if st["entries"] % CHECK_INTERVAL == 0:
            self._check_next(rec, e)

    def _leave_region(self, rec: ThreadRecord) -> None:
        rec.scheme_state["quiescent"].store(1)

    # ------------------------------------------------------------------
    def _check_next(self, rec: ThreadRecord, e: int) -> None:
        """Amortized advance: verify one record per opportunity."""
        st = rec.scheme_state
        if st["check_epoch"] != e:
            st["check_epoch"] = e
            st["check_idx"] = 0
            st["checked"] = 0
        n = len(self._records)
        # verify (at most) one in-use record
        while st["checked"] < n:
            other = self._records[st["check_idx"] % n]
            st["check_idx"] += 1
            st["checked"] += 1
            if other.in_use.load() != 1 or not other.scheme_state:
                continue  # unused records are trivially quiescent
            self.scan_steps.fetch_add(1)
            ost = other.scheme_state
            if ost["quiescent"].load() == 1 or ost["epoch"].load() == e:
                break  # this one is fine; check the next one next time
            # not yet quiescent in e: retry the SAME record next opportunity
            st["check_idx"] -= 1
            st["checked"] -= 1
            return
        if st["checked"] >= n:
            self.global_epoch.compare_exchange(e, e + 1)
            st["check_epoch"] = -1

    def _flush(self, rec: ThreadRecord) -> None:
        for _ in range(3):
            e = self.global_epoch.load()
            for _ in range(len(self._records) + 1):
                self._check_next(rec, e)
                if self.global_epoch.load() != e:
                    break
        self._reclaim(rec)

    def _retire(self, rec: ThreadRecord, node: ReclaimableNode) -> None:
        node._retire_stamp = self.global_epoch.load()
        rec.retire_append(node)

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
