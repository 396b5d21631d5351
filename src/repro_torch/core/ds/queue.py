"""Michael & Scott non-blocking queue (PODC 1996) on the Robison interface.

Nodes are protected with guard_ptrs while referenced and retired through the
pluggable reclamation scheme when dequeued (the classic dummy-node design:
the dequeued value lives in the *new* dummy).
"""

from __future__ import annotations

from typing import Any, Optional

from ..atomics import AtomicMarkedRef
from ..interface import ConcurrentPtr, Reclaimer, ReclaimableNode


class QueueNode(ReclaimableNode):
    __slots__ = ("value", "next")

    def __init__(self, value: Any = None) -> None:
        super().__init__()
        self.value = value
        self.next: ConcurrentPtr = AtomicMarkedRef(None)

    def outgoing_refs(self):
        return [self.next]


class MichaelScottQueue:
    def __init__(self, reclaimer: Reclaimer) -> None:
        self.reclaimer = reclaimer
        dummy = QueueNode()
        self.head: ConcurrentPtr = AtomicMarkedRef(dummy)
        self.tail: ConcurrentPtr = AtomicMarkedRef(dummy)

    # ------------------------------------------------------------------
    def enqueue(self, value: Any) -> None:
        node = QueueNode(value)
        self.reclaimer.on_allocate(node)
        t_guard = self.reclaimer.guard()
        while True:
            tail_v = t_guard.acquire(self.tail)
            tail = tail_v.obj
            next_v = tail.next.load()
            if self.tail.load() != tail_v:
                continue
            if next_v.obj is not None:
                # help swing tail forward
                self.tail.compare_exchange(tail_v, next_v.obj, 0)
                continue
            if tail.next.compare_exchange(next_v, node, 0):
                self.tail.compare_exchange(tail_v, node, 0)
                t_guard.reset()
                return

    # ------------------------------------------------------------------
    def dequeue(self) -> Optional[Any]:
        h_guard = self.reclaimer.guard()
        n_guard = self.reclaimer.guard()
        while True:
            head_v = h_guard.acquire(self.head)
            head = head_v.obj
            tail_v = self.tail.load()
            next_v = head.next.load()
            if self.head.load() != head_v:
                continue
            if next_v.obj is None:
                h_guard.reset()
                return None  # empty
            if head is tail_v.obj:
                # tail lagging: help
                self.tail.compare_exchange(tail_v, next_v.obj, 0)
                continue
            if not n_guard.acquire_if_equal(head.next, next_v):
                continue
            # Michael's re-validation: head.next may be a stale cell once
            # head is unlinked; only head still being the queue's head
            # guarantees the protected next node is not yet retired.
            if self.head.load() != head_v:
                n_guard.reset()
                continue
            nxt = n_guard.get()
            assert not nxt._reclaimed, "use-after-free in MS queue"
            value = nxt.value
            if self.head.compare_exchange(head_v, next_v.obj, 0):
                n_guard.reset()
                h_guard.reclaim()  # retire the old dummy
                return value
            n_guard.reset()

    # ------------------------------------------------------------------
    def drain(self) -> int:
        """Dequeue everything (teardown helper)."""
        n = 0
        while self.dequeue() is not None:
            n += 1
        return n
