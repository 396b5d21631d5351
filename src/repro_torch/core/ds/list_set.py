"""Harris' list-based set with Michael's improvements (SPAA 2002), written
against the Robison interface exactly like the paper's Listing 1.

``find`` keeps two guards (cur, save) plus the address of the previous link
(prev), physically unlinking marked nodes as it goes and retiring them via
the pluggable reclamation scheme.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from ..atomics import DELETE_MARK, AtomicMarkedRef, MarkedValue
from ..interface import ConcurrentPtr, Reclaimer, ReclaimableNode


class ListNode(ReclaimableNode):
    __slots__ = ("key", "value", "next")

    def __init__(self, key: Any, value: Any = None) -> None:
        super().__init__()
        self.key = key
        self.value = value
        self.next: ConcurrentPtr = AtomicMarkedRef(None)

    def outgoing_refs(self):
        return [self.next]


class HarrisMichaelListSet:
    def __init__(self, reclaimer: Reclaimer) -> None:
        self.reclaimer = reclaimer
        self.head: ConcurrentPtr = AtomicMarkedRef(None)

    # ------------------------------------------------------------------
    # paper Listing 1
    # ------------------------------------------------------------------
    def _find(
        self, key: Any, cur_guard, save_guard
    ) -> Tuple[bool, ConcurrentPtr, MarkedValue]:
        """Position (prev, cur) around ``key``; splice out marked nodes.

        Returns (found, prev_link, next_snapshot); on return ``cur_guard``
        protects the node at/after key (if any), ``save_guard`` its
        predecessor.
        """
        while True:  # retry
            prev: ConcurrentPtr = self.head
            next_v = prev.load()
            save_guard.reset()
            retry = False
            while True:
                if not cur_guard.acquire_if_equal(prev, next_v):
                    retry = True
                    break
                cur = cur_guard.get()
                if cur is None:
                    return False, prev, next_v
                next_v2 = cur.next.load()
                if next_v2.mark & DELETE_MARK:
                    # cur is logically deleted: splice it out and retire it
                    if not prev.compare_exchange(next_v, next_v2.obj, 0):
                        retry = True
                        break
                    cur_guard.reclaim()
                    next_v = prev.load()
                    if next_v.mark & DELETE_MARK:
                        # prev's node was deleted meanwhile: a CAS against
                        # this marked value would clear its mark (revive
                        # it, and re-link a node already retired)
                        retry = True
                        break
                    continue
                if prev.load() != next_v:
                    retry = True
                    break
                assert not cur._reclaimed, "use-after-free in list find"
                ckey = cur.key
                if ckey >= key:
                    return ckey == key, prev, next_v
                prev = cur.next
                next_v = next_v2
                save_guard.adopt(cur_guard)
            if retry:
                continue

    # ------------------------------------------------------------------
    def contains(self, key: Any) -> bool:
        with self.reclaimer.region_guard():
            cur_guard = self.reclaimer.guard()
            save_guard = self.reclaimer.guard()
            found, _, _ = self._find(key, cur_guard, save_guard)
            cur_guard.reset()
            save_guard.reset()
            return found

    def get(self, key: Any) -> Optional[Any]:
        with self.reclaimer.region_guard():
            cur_guard = self.reclaimer.guard()
            save_guard = self.reclaimer.guard()
            found, _, _ = self._find(key, cur_guard, save_guard)
            value = cur_guard.get().value if found else None
            cur_guard.reset()
            save_guard.reset()
            return value

    # ------------------------------------------------------------------
    def insert(self, key: Any, value: Any = None) -> bool:
        with self.reclaimer.region_guard():
            cur_guard = self.reclaimer.guard()
            save_guard = self.reclaimer.guard()
            node: Optional[ListNode] = None
            try:
                while True:
                    found, prev, next_v = self._find(key, cur_guard, save_guard)
                    if found:
                        return False
                    if node is None:
                        node = ListNode(key, value)
                    node.next.store(next_v.obj, 0)
                    if prev.compare_exchange(next_v, node, 0):
                        self.reclaimer.on_allocate(node)
                        return True
            finally:
                cur_guard.reset()
                save_guard.reset()

    # ------------------------------------------------------------------
    def remove(self, key: Any) -> bool:
        with self.reclaimer.region_guard():
            cur_guard = self.reclaimer.guard()
            save_guard = self.reclaimer.guard()
            try:
                while True:
                    found, prev, next_v = self._find(key, cur_guard, save_guard)
                    if not found:
                        return False
                    cur = cur_guard.get()
                    next_v2 = cur.next.load()
                    if next_v2.mark & DELETE_MARK:
                        continue  # someone else is deleting it; re-find
                    # logical delete: mark cur.next
                    if not cur.next.compare_exchange(
                        next_v2, next_v2.obj, DELETE_MARK
                    ):
                        continue
                    # physical unlink (or let a later find do it)
                    if prev.compare_exchange(next_v, next_v2.obj, 0):
                        cur_guard.reclaim()
                    else:
                        f2, s2 = self.reclaimer.guard(), self.reclaimer.guard()
                        self._find(key, f2, s2)
                        f2.reset()
                        s2.reset()
                    return True
            finally:
                cur_guard.reset()
                save_guard.reset()

    # ------------------------------------------------------------------
    def size(self) -> int:
        """Quiescent-only helper for tests."""
        n = 0
        v = self.head.load()
        while v.obj is not None:
            if not (v.obj.next.load().mark & DELETE_MARK):
                n += 1
            v = v.obj.next.load()
        return n
