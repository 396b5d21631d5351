"""Lock-Free Reference Counting (LFRC; Valois 1995).

The paper's efficiency "gold standard": a node is reclaimed the instant the
last reference drops — no grace periods, no scans.  As the paper notes, it is
*not* a general-purpose scheme: reclaimed nodes cannot be returned to the
memory manager and live on a type-stable free list (so the safe-read
increment of a just-freed node's counter is harmless).

Documented deviation (see DESIGN.md): reference counts here track *guards*
(acquired references), not intra-structure link counts; a retired node is
freed by the last guard release.  This keeps the Robison interface intact
(no intrusive pointer-operation rewrites in the data structures) while
preserving LFRC's benchmark role of immediate reclamation.  The safe-read
protocol (increment, validate, undo) is Valois' original.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

from ..atomics import AtomicInt, MarkedValue
from ..interface import Reclaimer, ReclaimableNode, ThreadRecord

_N_STRIPES = 64


class LockFreeRefCountReclaimer(Reclaimer):
    name = "lfrc"
    region_required = False
    protect_implies_safe = False

    def __init__(self, max_threads: int = 256):
        super().__init__(max_threads)
        self._stripes = [threading.Lock() for _ in range(_N_STRIPES)]
        self.free_list_size = AtomicInt(0)  # "global free-list" stand-in

    def _lock_for(self, node) -> threading.Lock:
        return self._stripes[id(node) % _N_STRIPES]

    # ------------------------------------------------------------------
    def _enter_region(self, rec: ThreadRecord) -> None:
        pass

    def _leave_region(self, rec: ThreadRecord) -> None:
        pass

    # ------------------------------------------------------------------
    def _protect(
        self, rec: ThreadRecord, cptr, expected
    ) -> Tuple[Optional[MarkedValue], Optional[object]]:
        while True:
            v = cptr.load()
            if v.obj is None:
                if expected is not None and v != expected:
                    return None, None
                return v, None
            if expected is not None and v != expected:
                return None, None
            node = v.obj
            with self._lock_for(node):
                node._rc += 1
            if cptr.load() == v:
                return v, node
            # validation failed: undo (Valois safe-read retry)
            self._drop_ref(node)
            if expected is not None:
                return None, None

    def _unprotect(self, rec: ThreadRecord, value, slot) -> None:
        if slot is not None:
            self._drop_ref(slot)

    def _drop_ref(self, node: ReclaimableNode) -> None:
        with self._lock_for(node):
            node._rc -= 1
            assert node._rc >= 0, "refcount underflow"
            free = node._rc == 0 and node._retired and not node._reclaimed
            if free:
                fin = self._free_locked(node)
        if free:
            self._finalize(fin)

    # ------------------------------------------------------------------
    def _retire(self, rec: ThreadRecord, node: ReclaimableNode) -> None:
        with self._lock_for(node):
            free = node._rc == 0 and not node._reclaimed
            if free:
                fin = self._free_locked(node)
        if free:
            self._finalize(fin)
        # else: the last _drop_ref will free it (node._retired already set).

    def _free_locked(self, node: ReclaimableNode):
        """``_free`` under the node's stripe lock, so that the check that
        decides to free and ``_reclaimed`` change together: the last
        guard release (or a stale safe-read's undo) racing the retire
        frees the node once.  Checked and freed apart, both could see
        ``_rc == 0`` and ``_reclaimed`` still False, and free it twice.
        Returns the node's finalizer (a page returned to its pool, which
        takes the pool's lock), held back for after the stripe lock."""
        fin, node.finalizer = node.finalizer, None
        self._free(node)
        return fin

    def _finalize(self, fin) -> None:
        if fin is not None:
            fin()
        self.free_list_size.fetch_add(1)
