"""Device-plane stamp ledger — the serving-layer form of the Stamp Pool.

CUDA dispatch is asynchronous: the host enqueues step N+k while the
device still executes step N, so HBM pages freed "now" may still be read
by an in-flight step.  The paper's insight transfers directly:

  * every engine step takes a strictly-increasing **stamp** when dispatched
    (the paper's contended FAA degenerates to a local counter because the
    per-replica dispatch loop is the single issuer — one stream per
    engine, so that serialization is real, not a simplification);
  * host-side actors (checkpoint writer, detokenizer, prefix-cache pins)
    take stamps through the same ledger via ``hold()``;
  * a retired resource is tagged with ``highest_stamp`` and parked on a
    stamp-sorted ring; it is recycled once ``lowest_active_stamp`` exceeds
    its tag — reclamation cost is O(#reclaimable), independent of how many
    steps/actors are in flight (Prop. 2 at the serving layer).

Lowest-active tracking mirrors the paper's doubly-linked Stamp Pool with a
structure that exploits the single-issuer property: stamps are issued in
monotone order, so the active set is an issue-ordered queue with lazy
deletion.  ``lowest_active`` pops completed stamps off the front; each
stamp is enqueued once and dequeued once, so the cost is amortized O(1)
per issue/complete — there is no ``min()`` over the active set anywhere on
the reclaim path.  ``scan_steps`` counts every queue-front pop plus every
retire-ring inspection, so the amortized-O(1) claim is *observable* (and
asserted in tests/test_torch_memory.py).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable, Deque, Dict, Iterable, Optional, Tuple


class StampLedger:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._next = 1
        self._active: Dict[int, str] = {}  # stamp -> tag (debug)
        # issue-ordered queue + lazy deletion: front is the lowest active
        # stamp after popping completed entries (amortized O(1))
        self._issue_q: Deque[int] = deque()
        self._retired: Deque[Tuple[int, Callable[[], None]]] = deque()
        # perf counters (serving-layer reclamation-efficiency benchmark)
        self.retired_total = 0
        self.reclaimed_total = 0
        self.scan_steps = 0
        # stamped point events (e.g. CoW forks): tag -> count.  An event
        # is NOT a critical region — it borrows the current highest stamp
        # as its timestamp and never blocks reclamation.
        self.events: Dict[str, int] = {}

    # ------------------------------------------------------------------
    # stamps
    # ------------------------------------------------------------------
    def issue(self, tag: str = "step") -> int:
        """Issue a stamp and mark it active (a critical-region entry)."""
        with self._lock:
            s = self._next
            self._next += 1
            self._active[s] = tag
            self._issue_q.append(s)
            return s

    def complete(self, stamp: int) -> None:
        """Mark a stamp inactive (critical-region exit) and reclaim."""
        with self._lock:
            self._active.pop(stamp, None)
            self._maybe_compact_locked()
        self.reclaim()

    def highest_stamp(self) -> int:
        with self._lock:
            return self._next - 1

    def note_event(self, tag: str) -> int:
        """Stamp a point event (a CoW fork, a branch kill): the event is
        tagged with the current highest stamp — a single O(1) ledger
        operation, the stamp-it answer to per-page refcount traffic —
        and counted under ``tag``.  Returns the stamp."""
        with self._lock:
            self.events[tag] = self.events.get(tag, 0) + 1
            return self._next - 1

    def _lowest_active_locked(self) -> int:
        """Lowest active stamp (or next-to-issue when none are active).

        Pops completed stamps off the issue-ordered queue front; every
        stamp transits the queue exactly once, so the aggregate cost over
        any operation sequence is O(#issued) — amortized O(1), with no
        scan over the active set.  Each pop is charged to ``scan_steps``.
        """
        q = self._issue_q
        while q and q[0] not in self._active:
            q.popleft()
            self.scan_steps += 1
        return q[0] if q else self._next

    def _maybe_compact_locked(self) -> None:
        """Bound queue memory when a long-lived hold pins the front.

        Front pops alone would retain one entry per stamp issued while
        the hold is active; once dead entries outnumber live ones the
        queue is rebuilt (order-preserving), so memory stays O(#active)
        and each stamp still leaves the queue exactly once — the
        compaction cost amortizes against the >=half entries removed.
        """
        q = self._issue_q
        if len(q) > 2 * len(self._active) + 8:
            removed = len(q) - len(self._active)
            self._issue_q = deque(
                s for s in q if s in self._active
            )
            self.scan_steps += removed

    def lowest_active(self) -> int:
        """Lowest active stamp, or next-to-issue if none are active."""
        with self._lock:
            return self._lowest_active_locked()

    def hold(self, tag: str = "hold") -> "_Hold":
        """Context manager pinning the current epoch (host-side actor)."""
        return _Hold(self, tag)

    def unreclaimed(self) -> int:
        return self.retired_total - self.reclaimed_total

    # ------------------------------------------------------------------
    # retire / reclaim
    # ------------------------------------------------------------------
    def retire(self, on_reclaim: Callable[[], None]) -> int:
        """Defer ``on_reclaim`` until every current consumer is done.

        Appended stamps are monotone, so the ring stays sorted and
        ``reclaim`` frees exactly a prefix.
        """
        with self._lock:
            stamp = self._next - 1  # highest assigned
            self._retired.append((stamp, on_reclaim))
            self.retired_total += 1
            return stamp

    def retire_many(
        self, on_reclaim: Iterable[Callable[[], None]]
    ) -> int:
        """Batch retire: one lock acquisition for a whole page batch.

        All callbacks are tagged with the same (current highest) stamp, so
        the ring stays sorted; counters advance exactly as if ``retire``
        had been called per element.
        """
        with self._lock:
            stamp = self._next - 1
            n = 0
            for cb in on_reclaim:
                self._retired.append((stamp, cb))
                n += 1
            self.retired_total += n
            return stamp

    def reclaim(self) -> int:
        callbacks = []
        with self._lock:
            lowest = self._lowest_active_locked()
            while self._retired and self._retired[0][0] < lowest:
                callbacks.append(self._retired.popleft()[1])
            self.scan_steps += len(callbacks) + (1 if self._retired else 0)
            self.reclaimed_total += len(callbacks)
        for cb in callbacks:
            cb()
        return len(callbacks)

    def force_expire(self, stamp: int) -> None:
        """Fault tolerance: drop a dead member's stamp (bounds the paper's
        reclamation-blocking weakness after a heartbeat timeout)."""
        with self._lock:
            self._active.pop(stamp, None)
        self.reclaim()

    def force_expire_all(self) -> int:
        """Wholesale forced expiry: drop EVERY active stamp — steps and
        holds alike — of a domain whose owner was declared dead (the
        cluster lifecycle plane's domain force-expire).  Returns the
        number of stamps expired."""
        with self._lock:
            n = len(self._active)
            self._active.clear()
            self.scan_steps += len(self._issue_q)
            self._issue_q.clear()
        self.reclaim()
        return n


class _Hold:
    def __init__(self, ledger: StampLedger, tag: str) -> None:
        self._ledger = ledger
        self._tag = tag
        self.stamp: Optional[int] = None

    def __enter__(self) -> "_Hold":
        self.stamp = self._ledger.issue(self._tag)
        return self

    def __exit__(self, *exc) -> None:
        if self.stamp is not None:
            self._ledger.complete(self.stamp)
            self.stamp = None
