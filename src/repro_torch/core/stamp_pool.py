"""The Stamp Pool — the paper's lock-free doubly-linked list (§3.1-§3.2).

Derived from Sundell & Tsigas' doubly-linked list with the directions
reversed: the ``prev`` list (head -> tail) is always kept consistent, the
``next`` pointers (tail -> head) are only hints.  Blocks (= per-thread
control blocks) are pushed right after ``head`` and can be removed from any
position.  ``head`` carries the stamp counter (FAA), ``tail`` mirrors (a
lower bound of) the lowest stamp of any block still in the pool.

Operations (paper's abstract Stamp Pool interface):
  1. ``push(block)``      - add a block, assigning a strictly-increasing stamp
  2. ``remove(block)``    - remove a block; True iff it held the lowest stamp
  3. ``highest_stamp()``  - last stamp assigned
  4. ``lowest_stamp()``   - lowest stamp of all blocks currently in the pool

Stamp layout (paper): the two low bits of a block's stamp hold the flags
``PendingPush`` (being inserted) and ``NotInList`` (fully removed), so the
stamp counter advances in steps of ``STAMP_INC = 4``.  Pointers carry a
delete mark + 17-bit version tag (see ``atomics.MarkedValue``).

OCR damage in the paper's Listings 2/6/7/8/9 was repaired against the prose
of §3.2.  This copy of the JAX package's pool differs in one place, the
helping unlink in :meth:`StampPool._remove_or_skip_marked_block` (paper
Listing 8): the reference re-reads ``last.prev`` and CASes it against that
fresh value, so a helper holding a stale ``next_prev`` can splice ``last``
onto a predecessor from the ``next`` block's *previous* life once that
block has been removed and pushed again (blocks are reused).  The list
then routes through a removed block, a remover concludes its block is
out of the list while ``head.prev`` still names it, its next ``push``
links the block to itself, and every thread spins on the self-loop.  The
CAS here expects the tagged word that was read from ``last.prev`` when
``next`` was reached, as the paper's tagged ``compare_exchange`` does, so
a reuse in between fails it.  ``tests/test_torch_core.py`` holds the copy
to the reference's sequential behaviour and runs the stress under a time
bound.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

from .atomics import (
    DELETE_MARK,
    AtomicInt,
    AtomicMarkedRef,
    MarkedValue,
)

# Stamp flag bits (low two bits of the stamp counter).
PENDING_PUSH = 1
NOT_IN_LIST = 2
STAMP_INC = 4

_NULL = MarkedValue(None)


class Block:
    """A thread_control_block acting as a node in the Stamp Pool.

    Blocks are *reused* across thread lifetimes (the ABA scenario the
    version tags defend against).
    """

    __slots__ = ("prev", "next", "stamp", "name")

    def __init__(self, name: str = "") -> None:
        self.prev = AtomicMarkedRef(None)
        self.next = AtomicMarkedRef(None)
        self.stamp = AtomicInt(0)
        self.name = name

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Block({self.name}, stamp={self.stamp.load()})"


class StampPool:
    def __init__(self) -> None:
        self.head = Block("head")
        self.tail = Block("tail")
        # Empty pool: head.prev -> tail, tail.next -> head.
        self.head.prev.store(self.tail, 0)
        self.tail.next.store(self.head, 0)
        # head.stamp is the *next* stamp to hand out; tail.stamp is the
        # lower bound on the lowest in-pool stamp.
        self.head.stamp.store(STAMP_INC)
        self.tail.stamp.store(0)

    # ------------------------------------------------------------------
    # Abstract interface ops 3 + 4
    # ------------------------------------------------------------------
    def highest_stamp(self) -> int:
        """The last stamp assigned to any block (retire tags use this)."""
        return self.head.stamp.load() - STAMP_INC

    def lowest_stamp(self) -> int:
        """Lower bound on the lowest stamp of any in-pool block.

        Nodes retired with ``stamp < lowest_stamp()`` are reclaimable.
        """
        return self.tail.stamp.load()

    # ------------------------------------------------------------------
    # push (paper Listing 4)
    # ------------------------------------------------------------------
    def push(self, block: Block) -> int:
        head = self.head
        # Setting next to head also clears the next-pointer delete mark.
        block.next.store(head, 0)
        head_prev = head.prev.load()
        while True:
            head_prev2 = head.prev.load()
            if head_prev2 != head_prev:
                head_prev = head_prev2
                continue
            stamp = head.stamp.fetch_add(STAMP_INC)
            # Pending stamp sorts strictly between the predecessor's stamp
            # (stamp - STAMP_INC) and our final stamp.
            block.stamp.store(stamp - (STAMP_INC - PENDING_PUSH))
            hp = head.prev.load()
            if hp != head_prev:
                head_prev = hp
                continue
            my_prev = head_prev
            block.prev.store(my_prev.obj, 0)
            if head.prev.compare_exchange(head_prev, block, 0):
                break
            head_prev = head.prev.load()
        # Inserted into the prev list: clear PendingPush.  A helper may have
        # already cleared it via CAS in move_next; both write `stamp`.
        block.stamp.store(stamp)
        # Final phase: hint our successor's next pointer at us.
        my_prev_blk = my_prev.obj
        while True:
            link = my_prev_blk.next.load()
            if (
                link.obj is block
                or (link.mark & DELETE_MARK)
                or block.prev.load().obj is not my_prev_blk
                or my_prev_blk.next.compare_exchange(link, block, 0)
            ):
                break
        return stamp

    # ------------------------------------------------------------------
    # remove (paper Listing 5)
    # ------------------------------------------------------------------
    def remove(self, block: Block) -> bool:
        """Remove ``block``; True iff it was the last (lowest-stamp) one."""
        prev = block.prev.set_mark().clear_mark()
        next_ = block.next.set_mark().clear_mark()
        fully_removed, prev, next_ = self._remove_from_prev_list(
            prev, block, next_
        )
        if not fully_removed:
            self._remove_from_next_list(prev, block, next_)
        stamp = block.stamp.load()
        block.stamp.store(stamp + NOT_IN_LIST)
        was_last = block.prev.load().obj is self.tail
        if was_last:
            self._update_tail_stamp(stamp + STAMP_INC)
        return was_last

    # ------------------------------------------------------------------
    # helpers (paper Listings 7 + 8 + 3)
    # ------------------------------------------------------------------
    def _mark_next(self, block: Block, stamp: int) -> bool:
        """Set the delete mark on ``block.next`` while its stamp matches.

        False means the stamp changed (block removed/reused): the caller can
        conclude its own block was removed as well.
        """
        while True:
            link = block.next.load()
            if block.stamp.load() != stamp:
                return False
            if link.mark & DELETE_MARK:
                return True
            if block.next.compare_exchange(link, link.obj, DELETE_MARK):
                return True

    def _move_next(
        self, next_prev: MarkedValue, next_: MarkedValue, last: MarkedValue
    ) -> Tuple[MarkedValue, MarkedValue]:
        """Move ``next`` one step toward tail (prev direction), keeping the
        old ``next`` in ``last``.  Helps clear a straggling PendingPush flag
        (required for lock-freedom, §3.2)."""
        cand = next_prev.obj
        st = cand.stamp.load()
        if st & PENDING_PUSH:
            # cand is reachable via a prev pointer => it IS in the prev
            # list; help finish its push.
            cand.stamp.compare_exchange(st, st + (STAMP_INC - PENDING_PUSH))
        return next_prev.clear_mark(), next_

    def _remove_or_skip_marked_block(
        self,
        next_: MarkedValue,
        last: MarkedValue,
        next_prev: MarkedValue,
        next_stamp: int,
    ) -> Tuple[bool, MarkedValue, MarkedValue]:
        """If ``next`` is marked for deletion, help remove it from the prev
        list (if we know its predecessor ``last``) or step around it in the
        next direction.  Returns (changed, next, last)."""
        if next_prev.mark & DELETE_MARK:
            self._mark_next(next_.obj, next_stamp)
            if last.obj is not None:
                # last should be next's predecessor: unlink next.  ``next_``
                # is the tagged word read from last.prev when we stepped
                # from last to next (_move_next), so the CAS fails if
                # last.prev changed since — above all if next was removed
                # and pushed again, when next_prev is stale.
                last.obj.prev.compare_exchange(next_, next_prev.obj, 0)
                return True, last, _NULL
            return True, next_.obj.next.load().clear_mark(), last
        return False, next_, last

    # ------------------------------------------------------------------
    # remove_from_prev_list (paper Listing 2)
    # ------------------------------------------------------------------
    def _remove_from_prev_list(
        self, prev: MarkedValue, b: Block, next_: MarkedValue
    ) -> Tuple[bool, MarkedValue, MarkedValue]:
        """Unlink ``b`` from the consistent prev list.

        Returns (fully_removed, prev, next): ``fully_removed`` True means we
        concluded b is already out of *both* lists; False means b is now out
        of the prev list and the caller must proceed to the next list with
        the returned (prev, next) positions.
        """
        my_stamp = b.stamp.load()
        last = _NULL
        while True:
            # prev and next converged: b is already unlinked from prev list.
            if next_.obj is prev.obj:
                return False, prev, b.next.load().clear_mark()
            if next_.obj is self.tail:
                # Fell past b entirely: b is no longer in the prev list.
                return False, prev, b.next.load().clear_mark()
            prev_prev = prev.obj.prev.load()
            prev_stamp = prev.obj.stamp.load()
            if prev_stamp > my_stamp or (prev_stamp & NOT_IN_LIST):
                # prev (reached via marked blocks only) was removed or
                # reused with a higher stamp => b fully removed (§3.2).
                return True, prev, next_
            if prev_prev.mark & DELETE_MARK:
                if not self._mark_next(prev.obj, prev_stamp):
                    return True, prev, next_
                prev = prev.obj.prev.load().clear_mark()
                continue
            next_prev = next_.obj.prev.load()
            next_stamp = next_.obj.stamp.load()
            if next_prev != next_.obj.prev.load():
                continue  # torn read; retry for a consistent snapshot
            if next_stamp < my_stamp:
                # next moved below us: b already out of the prev list.
                return False, prev, b.next.load().clear_mark()
            if next_stamp & (NOT_IN_LIST | PENDING_PUSH):
                if last.obj is not None:
                    next_, last = last, _NULL
                else:
                    next_ = next_.obj.next.load().clear_mark()
                continue
            changed, next_, last = self._remove_or_skip_marked_block(
                next_, last, next_prev, next_stamp
            )
            if changed:
                continue
            if next_prev.obj is not b:
                next_, last = self._move_next(next_prev, next_, last)
                continue
            # next is b's direct predecessor: splice b out.
            if next_.obj.prev.compare_exchange(next_prev, prev.obj, 0):
                return False, prev, next_

    # ------------------------------------------------------------------
    # remove_from_next_list (paper Listing 6)
    # ------------------------------------------------------------------
    def _remove_from_next_list(
        self, prev: MarkedValue, b: Block, next_: MarkedValue
    ) -> None:
        my_stamp = b.stamp.load()
        last = _NULL
        while True:
            if next_.obj is self.tail:
                # Fell past b: nothing left to fix in the next list (hints
                # tolerate staleness; consumers validate stamps/flags).
                return
            next_prev = next_.obj.prev.load()
            next_stamp = next_.obj.stamp.load()
            if next_prev != next_.obj.prev.load():
                continue
            if next_stamp & (NOT_IN_LIST | PENDING_PUSH):
                if last.obj is not None:
                    next_, last = last, _NULL
                else:
                    next_ = next_.obj.next.load().clear_mark()
                continue
            prev_next = prev.obj.next.load()
            prev_stamp = prev.obj.stamp.load()
            if prev_stamp > my_stamp or (prev_stamp & NOT_IN_LIST):
                return
            if prev_next.mark & DELETE_MARK:
                prev = prev.obj.prev.load().clear_mark()
                continue
            if next_.obj is prev.obj:
                return
            changed, next_, last = self._remove_or_skip_marked_block(
                next_, last, next_prev, next_stamp
            )
            if changed:
                continue
            if next_prev.obj is not prev.obj:
                next_, last = self._move_next(next_prev, next_, last)
                continue
            if next_stamp <= my_stamp or prev_next.obj is next_.obj:
                return
            if next_.obj.prev.load() == next_prev and prev.obj.next.compare_exchange(
                prev_next, next_.obj, 0
            ):
                # b is out of the next list; but if `next` got marked in the
                # meantime the hint chain may route through a dying block —
                # keep helping (paper Listing 6, final condition).
                if not (next_.obj.next.load().mark & DELETE_MARK):
                    return

    # ------------------------------------------------------------------
    # update_tail_stamp (paper Listing 9)
    # ------------------------------------------------------------------
    def _update_tail_stamp(self, guess: int) -> None:
        """Raise tail.stamp to the stamp of tail's new predecessor, or to
        ``guess`` (= remover's stamp + STAMP_INC) if the predecessor cannot
        be cheaply identified."""
        stamp = guess
        nv = self.tail.next.load()
        cand = nv.obj
        if cand is not self.head and cand is not self.tail:
            cstamp = cand.stamp.load()
            if not (cstamp & (NOT_IN_LIST | PENDING_PUSH)):
                cprev = cand.prev.load()
                if (
                    cprev.obj is self.tail
                    and not (cprev.mark & DELETE_MARK)
                    and self.tail.next.load() == nv
                    and cand.stamp.load() == cstamp
                ):
                    # cand verified as the current last block => its stamp
                    # is the lowest in-pool stamp.
                    stamp = max(stamp, cstamp)
        # Monotonic CAS-loop: only ever raise tail.stamp.
        self.tail.stamp.max_update(stamp)

    # ------------------------------------------------------------------
    # Test/debug support (quiescent only)
    # ------------------------------------------------------------------
    def prev_chain(self) -> List[Block]:
        """Walk head -> tail along prev pointers (quiescent use only)."""
        chain = [self.head]
        node = self.head.prev.load().obj
        seen = 0
        while node is not None and node is not self.tail:
            chain.append(node)
            node = node.prev.load().obj
            seen += 1
            if seen > 1_000_000:  # pragma: no cover
                raise RuntimeError("prev chain does not terminate")
        chain.append(self.tail)
        return chain

    def check_quiescent_invariants(self) -> None:
        """Assert structural invariants while no thread is mutating."""
        chain = self.prev_chain()
        stamps = []
        for blk in chain[1:-1]:
            st = blk.stamp.load()
            assert not (st & (PENDING_PUSH | NOT_IN_LIST)), (
                f"in-pool block {blk} carries flags"
            )
            assert not (blk.prev.load().mark & DELETE_MARK)
            stamps.append(st)
        assert stamps == sorted(stamps, reverse=True), (
            f"prev-direction stamps not strictly decreasing: {stamps}"
        )
        assert len(set(stamps)) == len(stamps)
        if stamps:
            assert self.tail.stamp.load() <= min(stamps)
        assert self.head.stamp.load() - STAMP_INC >= max(stamps or [0])
