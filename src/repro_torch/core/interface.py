"""Robison-style C++ reclamation interface (N3712), adapted to Python.

The paper builds every scheme behind one abstract interface so that data
structures are written once and parameterized by the reclaimer:

  * ``marked_ptr``      -> :class:`repro_torch.core.atomics.MarkedValue`
  * ``concurrent_ptr``  -> :class:`repro_torch.core.atomics.AtomicMarkedRef`
  * ``guard_ptr``       -> :class:`Guard` (acquire / acquire_if_equal /
                           reset / reclaim)
  * ``region_guard``    -> :meth:`Reclaimer.region_guard` context manager
                           (paper's amortization of critical-region entry)

Every scheme derives from :class:`Reclaimer` and supplies the four hook
methods (`_enter_region`, `_leave_region`, `_protect`, `_retire`).  Thread
management (control-block reuse for arbitrarily starting/stopping threads,
orphaned retire lists) lives here so all seven schemes share it.
"""

from __future__ import annotations

import threading
from abc import ABC, abstractmethod
from typing import Any, Callable, Dict, List, Optional

from .atomics import (
    DELETE_MARK,
    AtomicInt,
    AtomicMarkedRef,
    AtomicRef,
    MarkedValue,
)

ConcurrentPtr = AtomicMarkedRef  # Robison naming alias for data structures.


class ReclaimableNode:
    """Base class for nodes managed by a reclamation scheme.

    Scheme metadata is intrusive (as in the paper, where nodes carry hidden
    meta-information): a retire stamp/epoch, a retire-list link and a
    reference count (used only by LFRC).
    """

    __slots__ = (
        "_retire_stamp",
        "_retire_next",
        "_retired",
        "_reclaimed",
        "_rc",
        "_birth_era",
        "finalizer",
    )

    def __init__(self) -> None:
        self._retire_stamp = 0
        self._retire_next: Optional["ReclaimableNode"] = None
        self._retired = False
        self._reclaimed = False
        self._rc = 0        # LFRC only
        self._birth_era = 0  # IBR only
        #: optional zero-arg callback run when the scheme physically frees
        #: the node (the C++ destructor).  The serving plane's
        #: CoreSchemeAdapter uses it to return HBM pages to the BlockPool.
        self.finalizer: Optional[Callable[[], None]] = None

    def outgoing_refs(self) -> List[ConcurrentPtr]:
        """Links owned by this node (LFRC releases them on reclamation)."""
        return []


class Guard:
    """A ``guard_ptr``: protects one node from reclamation while held."""

    __slots__ = ("_reclaimer", "_record", "_value", "_slot")

    def __init__(self, reclaimer: "Reclaimer", record: "ThreadRecord") -> None:
        self._reclaimer = reclaimer
        self._record = record
        self._value: MarkedValue = MarkedValue(None)
        self._slot: Any = None  # scheme-private (e.g. hazard slot)

    # -- accessors (marked_ptr semantics) ---------------------------------
    def get(self) -> Any:
        return self._value.obj

    def mark(self) -> int:
        return self._value.mark

    @property
    def value(self) -> MarkedValue:
        return self._value

    def __bool__(self) -> bool:
        return self._value.obj is not None

    # -- acquisition -------------------------------------------------------
    def acquire(self, cptr: ConcurrentPtr) -> MarkedValue:
        """Snapshot ``cptr`` and protect its referent (may loop; see HP)."""
        self.reset()
        self._value, self._slot = self._reclaimer._protect(
            self._record, cptr, None
        )
        node = self._value.obj
        # Reclamation-safety invariant (paper Prop. 1): for region-based
        # schemes a successfully protected node must never already be
        # reclaimed.  HP/LFRC may transiently validate against a stale cell
        # (protect_implies_safe=False) — the data structure re-validates.
        assert (
            node is None
            or not self._reclaimer.protect_implies_safe
            or not node._reclaimed
        ), (
            f"{self._reclaimer.name}: use-after-free — guard acquired a "
            f"reclaimed node"
        )
        return self._value

    def acquire_if_equal(
        self, cptr: ConcurrentPtr, expected: MarkedValue
    ) -> bool:
        """Protect ``cptr``'s referent only if the cell still equals
        ``expected``; single-shot (usable in wait-free contexts)."""
        self.reset()
        value, slot = self._reclaimer._protect(self._record, cptr, expected)
        if value is None:
            return False
        node = value.obj
        assert (
            node is None
            or not self._reclaimer.protect_implies_safe
            or not node._reclaimed
        ), (
            f"{self._reclaimer.name}: use-after-free — guard acquired a "
            f"reclaimed node"
        )
        self._value, self._slot = value, slot
        return True

    def adopt(self, other: "Guard") -> None:
        """Move-assign: take over ``other``'s protection (std::move)."""
        self.reset()
        self._value, self._slot = other._value, other._slot
        other._value, other._slot = MarkedValue(None), None

    # -- release -----------------------------------------------------------
    def reset(self) -> None:
        if self._value.obj is not None or self._slot is not None:
            self._reclaimer._unprotect(self._record, self._value, self._slot)
        self._value, self._slot = MarkedValue(None), None

    def reclaim(self) -> None:
        """Retire the guarded node (deferred delete) and reset the guard."""
        node = self._value.obj
        assert node is not None, "reclaim() on empty guard"
        self.reset()
        self._reclaimer.retire(node)


#: ``ThreadRecord.in_use`` while ``_acquire_record`` attaches the record
ATTACHING = 2


class ThreadRecord:
    """Per-thread control block, **reused** across thread lifetimes.

    The paper's implementations keep a global list of thread control blocks
    that terminated threads release and new threads re-acquire, so the scheme
    works with arbitrary numbers of threads starting and stopping arbitrarily.
    """

    __slots__ = (
        "index",
        "in_use",
        "region_depth",
        "retire_head",
        "retire_tail",
        "retire_count",
        "scheme_state",
        "ops_since_maintenance",
    )

    def __init__(self, index: int) -> None:
        self.index = index
        self.in_use = AtomicInt(0)
        self.region_depth = 0
        # Singly-linked local retire-list (append at tail -> stamp-ordered).
        self.retire_head: Optional[ReclaimableNode] = None
        self.retire_tail: Optional[ReclaimableNode] = None
        self.retire_count = 0
        self.scheme_state: Dict[str, Any] = {}
        self.ops_since_maintenance = 0

    # -- local retire-list helpers ----------------------------------------
    def retire_append(self, node: ReclaimableNode) -> None:
        node._retire_next = None
        if self.retire_tail is None:
            self.retire_head = self.retire_tail = node
        else:
            self.retire_tail._retire_next = node
            self.retire_tail = node
        self.retire_count += 1

    def retire_take_all(self):
        head, count = self.retire_head, self.retire_count
        self.retire_head = self.retire_tail = None
        self.retire_count = 0
        return head, count


class _RegionGuard:
    def __init__(self, reclaimer: "Reclaimer") -> None:
        self._reclaimer = reclaimer

    def __enter__(self) -> "_RegionGuard":
        self._reclaimer._region_enter()
        return self

    def __exit__(self, *exc) -> None:
        self._reclaimer._region_leave()


class _ThreadContext:
    def __init__(self, reclaimer: "Reclaimer") -> None:
        self._reclaimer = reclaimer

    def __enter__(self):
        self._reclaimer._record()  # force registration
        return self

    def __exit__(self, *exc) -> None:
        self._reclaimer.detach_thread()


class Reclaimer(ABC):
    """Base class for all seven schemes.

    Subclasses implement::

        _enter_region(record)          # begin critical region
        _leave_region(record)          # end critical region (may reclaim)
        _protect(record, cptr, expected) -> (MarkedValue|None, slot)
        _unprotect(record, value, slot)
        _retire(record, node)          # defer deletion of node

    and may override ``_on_thread_detach`` for orphan handling.
    """

    name = "abstract"
    #: whether guards may exist outside an explicit region (HP/LFRC: yes)
    region_required = False
    #: True if a successful _protect alone guarantees the node is not yet
    #: reclaimed (region-based schemes).  HP/LFRC validate against a single
    #: cell that can be stale; the data structure must re-validate before
    #: dereferencing (exactly as in Michael's published algorithms).
    protect_implies_safe = True

    def __init__(self, max_threads: int = 256) -> None:
        self.max_threads = max_threads
        self._records: List[ThreadRecord] = [
            ThreadRecord(i) for i in range(max_threads)
        ]
        self._tls = threading.local()
        self.allocated = AtomicInt(0)
        self.reclaimed = AtomicInt(0)
        # Orphaned nodes from detached threads (paper §4.4): list of
        # (head, count) batches, lock-protected (not the hot path).
        self._orphan_lock = threading.Lock()
        self._orphans: List[ReclaimableNode] = []

    # ------------------------------------------------------------------
    # Thread management
    # ------------------------------------------------------------------
    def _record(self) -> ThreadRecord:
        rec = getattr(self._tls, "record", None)
        if rec is None:
            rec = self._acquire_record()
            self._tls.record = rec
        return rec

    def _acquire_record(self) -> ThreadRecord:
        # claimed as ATTACHING while the scheme fills the record's state in
        # place: the schemes' scans of other records read only records in
        # use (1), so none sees a first attach's state with a key missing
        for rec in self._records:
            if rec.in_use.compare_exchange(0, ATTACHING):
                self._on_thread_attach(rec)
                rec.in_use.store(1)
                return rec
        raise RuntimeError(
            f"{self.name}: more than {self.max_threads} concurrent threads"
        )

    def thread_context(self) -> _ThreadContext:
        return _ThreadContext(self)

    def detach_thread(self) -> None:
        rec = getattr(self._tls, "record", None)
        if rec is None:
            return
        self._tls.record = None
        self._on_thread_detach(rec)
        rec.region_depth = 0
        rec.in_use.store(0)

    def _on_thread_attach(self, rec: ThreadRecord) -> None:
        pass

    def _on_thread_detach(self, rec: ThreadRecord) -> None:
        """Default orphan policy: park leftover nodes on the global orphan
        list; any thread performing maintenance will try to adopt them."""
        head, count = rec.retire_take_all()
        if head is None:
            return
        with self._orphan_lock:
            node = head
            while node is not None:
                self._orphans.append(node)
                node = node._retire_next

    def adopt_orphans(self) -> None:
        """Move orphaned nodes into the calling thread's retire list."""
        with self._orphan_lock:
            orphans, self._orphans = self._orphans, []
        rec = self._record()
        for node in orphans:
            node._retire_next = None
            self._retire(rec, node)

    # ------------------------------------------------------------------
    # Public reclamation API (Robison-style)
    # ------------------------------------------------------------------
    def guard(self) -> Guard:
        return Guard(self, self._record())

    def region_guard(self) -> _RegionGuard:
        return _RegionGuard(self)

    def retire(self, node: ReclaimableNode) -> None:
        assert not node._retired, "double retire"
        node._retired = True
        self._retire(self._record(), node)

    def on_allocate(self, node: ReclaimableNode) -> None:
        self.allocated.fetch_add(1)

    def flush(self) -> None:
        """Best-effort maintenance: adopt orphans and reclaim whatever is
        already safe.  Used at engine teardown and by benchmarks between
        trials; NOT part of the hot path."""
        self.adopt_orphans()
        self._flush(self._record())

    def _flush(self, rec: ThreadRecord) -> None:
        pass

    # -- stats (reclamation-efficiency benchmark) -----------------------
    def unreclaimed(self) -> int:
        return self.allocated.load() - self.reclaimed.load()

    def stats(self) -> Dict[str, int]:
        return {
            "allocated": self.allocated.load(),
            "reclaimed": self.reclaimed.load(),
            "unreclaimed": self.unreclaimed(),
        }

    # ------------------------------------------------------------------
    # Internal region plumbing (re-entrant regions like the paper's
    # region_guard: nested entries are counted, only the outermost pays).
    # ------------------------------------------------------------------
    def _region_enter(self) -> None:
        rec = self._record()
        if rec.region_depth == 0:
            self._enter_region(rec)
        rec.region_depth += 1

    def _region_leave(self) -> None:
        rec = self._record()
        rec.region_depth -= 1
        assert rec.region_depth >= 0
        if rec.region_depth == 0:
            self._leave_region(rec)

    def in_region(self) -> bool:
        rec = self._record()
        return rec.region_depth > 0

    # ------------------------------------------------------------------
    # Physical deletion
    # ------------------------------------------------------------------
    def _free(self, node: ReclaimableNode) -> None:
        assert not node._reclaimed, "double reclaim"
        node._reclaimed = True
        node._retire_next = None
        self.reclaimed.fetch_add(1)
        if node.finalizer is not None:
            node.finalizer()

    def _free_list(self, head: Optional[ReclaimableNode]) -> int:
        n = 0
        while head is not None:
            nxt = head._retire_next
            self._free(head)
            head = nxt
            n += 1
        return n

    # ------------------------------------------------------------------
    # Scheme hooks
    # ------------------------------------------------------------------
    @abstractmethod
    def _enter_region(self, rec: ThreadRecord) -> None: ...

    @abstractmethod
    def _leave_region(self, rec: ThreadRecord) -> None: ...

    @abstractmethod
    def _retire(self, rec: ThreadRecord, node: ReclaimableNode) -> None: ...

    def _protect(self, rec, cptr, expected):
        """Default protection for region-based schemes: a plain load is safe
        while inside a critical region.  Guards taken outside an explicit
        region enter a region for the lifetime of the guard (the paper's
        'unless the thread is already inside a critical region the guard_ptr
        automatically enters one')."""
        entered = False
        if rec.region_depth == 0:
            self._region_enter()
            entered = True
        value = cptr.load()
        if expected is not None and value != expected:
            if entered:
                self._region_leave()
            return None, None
        return value, ("region" if entered else None)

    def _unprotect(self, rec, value, slot) -> None:
        if slot == "region":
            self._region_leave()
