"""Pluggable reclamation policies for the serving-plane BlockPool.

The paper's central methodological move is putting Stamp-it and its
competitors behind one Robison-style interface so data structures are
written once and parameterized by the reclaimer.  This module gives the
serving plane the same property: :class:`ReclamationPolicy` is the
interface the BlockPool (and therefore the ServingEngine and PrefixCache)
are written against, and every scheme from the paper's comparison is a
concrete policy:

  * native device-plane policies, tuned to the single-issuer dispatch
    loop — ``stamp-it`` (StampLedger), ``epoch`` (ER-analogue), ``scan``
    (HP-analogue), ``refcount`` (LFRC-analogue);
  * native ROBUST policies — ``hyaline`` (per-batch distributed
    reference counts, arXiv:1905.07903) and ``crystalline`` (wait-free
    slot-local limbo lists, arXiv:2108.02763) — whose memory stays
    bounded even when a hold is parked forever (a stalled or dead
    actor), the metric the JAX package's robustness bench measures;
  * :class:`CoreSchemeAdapter`, which wraps ANY
    :class:`repro_torch.core.interface.Reclaimer` — the paper's actual scheme
    implementations — so ``new-epoch``, ``hazard``, ``interval``, ``qsr``,
    ``debra`` and ``lfrc`` (and ``stamp-it-core``) drive the serving
    workload through the exact host-plane code the §4 benchmarks measure.

The adapter's mapping is the one the StampLedger docstring argues for:
every in-flight asynchronous device step is a *thread in a critical
region*.  ``begin_step`` attaches a fresh thread record and enters a
region on it (plus one guard per referenced page for the pointer-based
schemes); ``complete_step`` leaves the region and detaches.  Retired
pages become :class:`ReclaimableNode`s whose ``finalizer`` returns the
page to the pool free list when the scheme physically frees them.

Invariant (asserted across all policies in tests/test_torch_engine.py): a
policy changes POOL PRESSURE, never model outputs.
"""

from __future__ import annotations

import bisect
import threading
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from ..core.atomics import AtomicMarkedRef
from ..core.interface import Guard, ReclaimableNode, Reclaimer
from .stamp_ledger import StampLedger

PageRef = Tuple[int, int]  # (slot, page)


def _group_by_slot(refs: Sequence[PageRef]) -> List[Tuple[int, List[int]]]:
    by_slot: Dict[int, List[int]] = {}
    for slot, page in refs:
        by_slot.setdefault(slot, []).append(page)
    return list(by_slot.items())


class PolicyHold:
    """Handle for a host-actor hold on a policy's stamp domain.

    Semantics (the paper's long-lived critical region, at page
    granularity): pages retired anywhere in the policy's domain while the
    hold is open must NOT be reclaimed until the hold releases — on top
    of whatever the policy's own in-flight-step rules require.  The
    cluster plane composes these per-replica holds into cross-replica
    holds."""

    __slots__ = ("tag", "released", "forced", "_policy")

    def __init__(self, policy: "ReclamationPolicy", tag: str) -> None:
        self.tag = tag
        self.released = False
        #: True iff a third party revoked this hold (heartbeat death)
        self.forced = False
        self._policy = policy
        policy._track_hold(self)

    def release(self) -> None:
        """Cooperative release — IDEMPOTENT: the first call wins (claimed
        atomically under the policy's hold lock), any later call is a
        no-op.  A genuine double cooperative release bumps the policy's
        ``double_release`` diagnostic (it used to corrupt live-hold
        tracking); a late cooperative release after a third-party
        force-expiry is the expected path and is not counted."""
        if not self._policy._claim_release(self):
            return
        self._do_release()
        self._policy._untrack_hold(self)
        self._policy.holds_open -= 1

    def _do_release(self) -> None:
        raise NotImplementedError

    def __enter__(self) -> "PolicyHold":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class _BufferedHold(PolicyHold):
    """Generic hold: the policy buffers retires while any hold is open.

    This is the crutch for schemes that cannot pin *unknown future*
    pages (hazard pointers / LFRC protect only pages they can name, and
    a hold must cover pages retired after it opened) — the exact
    weakness the paper's region-based schemes avoid."""

    def _do_release(self) -> None:
        self._policy._close_buffered_hold(self)


class ReclamationPolicy:
    """Strategy interface between the BlockPool and a reclamation scheme.

    Lifecycle hooks mirror the serving engine's async-dispatch reality:

      * ``begin_step(page_refs)``   — a decode step is dispatched; it may
        read every page in ``page_refs`` until it completes.  Returns an
        opaque handle.
      * ``complete_step(handle)``   — the host observed the step finish.
      * ``retire_pages(slot, pages)`` — pages freed by a request finish or
        a prefix-cache eviction; they must NOT reach the free list while
        any in-flight step (or host-actor hold) may still read them.
      * ``reclaim()``               — best-effort maintenance (drain /
        teardown / benchmark boundaries), never the hot path.
      * ``hold(tag)``               — host-actor pin (checkpoint writer,
        prefix migration): pages retired while the hold is open are not
        reclaimed until it releases (see :class:`PolicyHold`).

    Concrete policies implement ``_retire`` / ``_unreclaimed``; the
    public ``retire_pages`` / ``unreclaimed`` wrappers add the
    hold-buffering layer shared by every scheme that has no native pin.
    The policy returns pages through ``self.release(slot, page)`` which
    :meth:`bind` wires to the owning pool's free lists.
    """

    name = "abstract"

    def __init__(self) -> None:
        self.release: Callable[[int, int], None] = lambda s, p: None
        self._bound_pool = None
        # observability plane: the bound pool's ReclaimTracer (hold
        # lifetimes + CoW fork-park durations); None until bind()
        self._tracer = None
        # host-actor hold state (generic buffered implementation)
        self._hold_lock = threading.Lock()
        self._open_holds: Set[PolicyHold] = set()
        self._held: List[Tuple[int, List[int]]] = []
        self._held_pages = 0
        # every not-yet-released hold on this domain, regardless of
        # mechanism (stamp / region / buffered) — what force_quiesce
        # revokes when the domain's owner is declared dead
        self._live_holds: Set[PolicyHold] = set()
        self.holds_issued = 0
        self.holds_open = 0
        self.force_released = 0
        #: cooperative release() calls that found the hold already
        #: cooperatively released (see PolicyHold.release)
        self.double_release = 0
        # copy-on-write fork references: a forked page is shared by N
        # branches; it must not enter the scheme's retire path until the
        # LAST branch releases it.  Generic implementation: a count table
        # plus a parked set for pages retired while forked (native
        # overrides: RefcountPolicy maps forks onto its per-page
        # counters, the LFRC adapter onto long-lived guards).
        self._fork: Dict[PageRef, int] = {}
        self._fork_parked: Set[PageRef] = set()
        self.forks_taken = 0
        self.forks_released = 0

    def bind(self, pool) -> None:
        # a policy routes reclaimed pages to ONE pool's free lists;
        # rebinding would leak pages from the first pool into the second
        if self._bound_pool is not None and self._bound_pool is not pool:
            raise ValueError(
                f"policy {self.name!r} is already bound to another "
                f"BlockPool; create one policy instance per pool"
            )
        self._bound_pool = pool
        self.release = pool._release_page
        self._tracer = getattr(pool, "trace", None)

    # -- step lifecycle -------------------------------------------------
    def begin_step(self, page_refs: Sequence[PageRef]) -> int:
        raise NotImplementedError

    def complete_step(self, handle: int) -> None:
        raise NotImplementedError

    # -- copy-on-write fork references ----------------------------------
    def fork_refs(self, refs: Sequence[PageRef]) -> None:
        """Take one fork reference per page (a CoW branch now shares it).

        Cold path (branch admission), O(#refs) with no per-step cost:
        the fork table is only consulted again when one of these pages
        is retired.  Counts nest — N branches over the same prefix take
        N-1 references per shared page."""
        refs = list(refs)
        if not refs:
            return
        with self._hold_lock:
            for ref in refs:
                self._fork[ref] = self._fork.get(ref, 0) + 1
        self.forks_taken += len(refs)
        self._note_fork(len(refs))

    def _note_fork(self, n: int) -> None:
        """Hook: stamp-it stamps the fork event in its ledger (O(1))."""

    def release_fork(self, refs: Sequence[PageRef]) -> None:
        """Drop one fork reference per page (a branch finished or was
        killed).  Pages whose count hits zero AND were retired while
        forked enter the scheme's retire path now, as ONE batch —
        for stamp-it a single stamped ring append."""
        refs = list(refs)
        if not refs:
            return
        newly_free: List[PageRef] = []
        with self._hold_lock:
            for ref in refs:
                c = self._fork.get(ref, 0)
                if c <= 0:
                    raise AssertionError(
                        f"release_fork without matching fork_refs: {ref}"
                    )
                if c == 1:
                    del self._fork[ref]
                    if ref in self._fork_parked:
                        self._fork_parked.discard(ref)
                        newly_free.append(ref)
                else:
                    self._fork[ref] = c - 1
        self.forks_released += len(refs)
        if newly_free:
            if self._tracer is not None:
                for ref in newly_free:
                    self._tracer.on_fork_unpark(ref)
            self.retire_many(newly_free)

    def fork_count(self, ref: PageRef) -> int:
        with self._hold_lock:
            return self._fork.get(ref, 0)

    def _clear_forks(self) -> List[PageRef]:
        """Drop every fork reference (dead-replica quiesce); returns the
        parked refs that must now retire.  Native overrides clear their
        own structures and free directly."""
        with self._hold_lock:
            self._fork.clear()
            parked = list(self._fork_parked)
            self._fork_parked.clear()
        if self._tracer is not None:
            for ref in parked:
                self._tracer.on_fork_unpark(ref)
        return parked

    def _intercept_forked(
        self, refs: Sequence[PageRef]
    ) -> List[PageRef]:
        """Park retired-while-forked refs; return the passthrough rest."""
        with self._hold_lock:
            if not self._fork:
                return list(refs)
            passthrough = []
            parked = []
            for ref in refs:
                if self._fork.get(ref, 0) > 0:
                    self._fork_parked.add(ref)
                    parked.append(ref)
                else:
                    passthrough.append(ref)
        if parked and self._tracer is not None:
            for ref in parked:
                self._tracer.on_fork_park(ref)
        return passthrough

    # -- allocation births ----------------------------------------------
    def note_alloc(self, slot: int, pages: Sequence[int]) -> None:
        """Hook: the pool just allocated ``pages`` to ``slot``.  Most
        schemes ignore births; the robust policies (hyaline,
        crystalline) stamp a birth era per page so a stalled entry pins
        only pages that already existed when it was created — the
        bounded-memory predicate.  Called by the pool OUTSIDE its own
        lock (the established order is policy-lock -> pool-lock)."""

    # -- retire / reclaim ----------------------------------------------
    def retire_pages(self, slot: int, pages: Sequence[int]) -> None:
        """Retire; while any buffered hold is open, pages park in the
        hold buffer and only enter the scheme's own retire path once the
        last hold releases (local in-flight rules still apply after).
        Fork-held pages park in the fork table FIRST — a page shared by
        a live CoW branch never reaches the scheme (or the hold buffer)
        until its last fork releases."""
        refs = self._intercept_forked([(slot, p) for p in pages])
        if not refs:
            return
        pages = [p for _, p in refs]
        with self._hold_lock:
            if self._open_holds:
                self._held.append((slot, pages))
                self._held_pages += len(pages)
                return
        self._retire(slot, pages)

    def retire_many(self, refs: Sequence[PageRef]) -> None:
        """Chunk-batched retire across slots: ONE hold-buffer check (and,
        for stamp-it, one ledger stamping event) for the whole batch —
        the serving-layer analogue of ``StampLedger.retire_many``.  Used
        by batch-shaped retirers (prefix-cache eviction sweeps, cluster
        migration drops) so per-chunk page churn stays amortized O(1)
        under the stamp ledger instead of one bookkeeping event per
        page."""
        refs = self._intercept_forked(list(refs))
        if not refs:
            return
        with self._hold_lock:
            if self._open_holds:
                self._held.extend(_group_by_slot(refs))
                self._held_pages += len(refs)
                return
        self._retire_refs(refs)

    def _retire_refs(self, refs: Sequence[PageRef]) -> None:
        """Batch retire body; default groups by slot.  Policies with a
        native batch primitive override (StampItPolicy: one stamped ring
        append for the whole batch)."""
        for slot, pages in _group_by_slot(refs):
            self._retire(slot, pages)

    def _retire(self, slot: int, pages: Sequence[int]) -> None:
        raise NotImplementedError

    def reclaim(self) -> None:
        pass

    # -- host-actor holds ----------------------------------------------
    def hold(self, tag: str = "hold") -> PolicyHold:
        """Open a hold on this policy's stamp domain (generic buffered
        implementation; stamp-it and the region-based core schemes
        override with native pins)."""
        h = _BufferedHold(self, tag)
        with self._hold_lock:
            self._open_holds.add(h)
        self.holds_issued += 1
        self.holds_open += 1
        return h

    def _close_buffered_hold(self, h: PolicyHold) -> None:
        with self._hold_lock:
            self._open_holds.discard(h)
            if self._open_holds:
                return
            buffered, self._held = self._held, []
            self._held_pages = 0
        for slot, pages in buffered:
            self._retire(slot, pages)
        self.reclaim()

    def _track_hold(self, h: PolicyHold) -> None:
        with self._hold_lock:
            self._live_holds.add(h)
        if self._tracer is not None:
            self._tracer.on_hold_open(h)

    def _untrack_hold(self, h: PolicyHold) -> None:
        # reached through _claim_release exactly once per hold
        # (cooperative OR forced), so the lifetime histogram cannot
        # double-count a force-released hold
        with self._hold_lock:
            self._live_holds.discard(h)
        if self._tracer is not None:
            self._tracer.on_hold_close(h)

    def _claim_release(self, h: PolicyHold, forced: bool = False) -> bool:
        """Atomically claim the single permitted release of ``h``.

        Returns False when the hold was already released — the caller
        must then do NOTHING (no ``_do_release``, no hold accounting).
        This is what makes both ``release()`` and ``force_release()``
        idempotent and race-free against each other: exactly one caller
        ever runs the release body."""
        with self._hold_lock:
            if h.released:
                if not forced and not h.forced:
                    self.double_release += 1
                return False
            h.released = True
            if forced:
                h.forced = True
            return True

    # -- forced expiry (lifecycle plane) --------------------------------
    def force_release(self, hold: PolicyHold) -> None:
        """Revoke ``hold`` WITHOUT its owner's cooperation — the paper's
        forced stamp expiry at the serving layer.  The cluster lifecycle
        plane calls this once a hold's owner misses its heartbeat
        deadline; the hold object becomes inert (a late cooperative
        ``release()`` is a no-op).  Mechanism per scheme: native stamp
        ``force_expire`` for stamp-it, region force-exit for the core
        region schemes, buffered-flush for hazard/LFRC."""
        if not self._claim_release(hold, forced=True):
            return
        self.force_released += 1
        self._force_release_impl(hold)
        self._untrack_hold(hold)
        self.holds_open -= 1

    def _force_release_impl(self, hold: PolicyHold) -> None:
        # buffered-flush default (hazard/LFRC and the native analogues):
        # drop the hold from the open set; the last one out un-parks the
        # whole hold buffer into the scheme's own retire path
        self._close_buffered_hold(hold)

    def force_quiesce(self) -> Dict[str, int]:
        """Expire this whole stamp domain: force-release every open hold
        and abandon every in-flight step handle (the issuer is presumed
        dead — nothing will ever complete them), then reclaim.  Called by
        the lifecycle plane when the replica owning this domain is
        declared dead or drained out of the group."""
        holds = 0
        with self._hold_lock:
            live = list(self._live_holds)
        for h in live:
            if not h.released:
                self.force_release(h)
                holds += 1
        # forked branches of a dead replica will never release: drop all
        # fork references and retire whatever they parked (one batch)
        parked = self._clear_forks()
        if parked:
            self.retire_many(parked)
        steps = self._abandon_steps()
        self.reclaim()
        return {"holds": holds, "steps": steps}

    def _abandon_steps(self) -> int:
        """Drop every in-flight step handle of a dead issuer; returns the
        number abandoned.  Policies with step state override."""
        return 0

    # -- observability --------------------------------------------------
    def unreclaimed(self) -> int:
        with self._hold_lock:
            held = self._held_pages + len(self._fork_parked)
        return held + self._unreclaimed()

    def _unreclaimed(self) -> int:
        raise NotImplementedError

    @property
    def scan_steps(self) -> int:
        """Bookkeeping work: cross-step scans + retire-list probes."""
        return 0

    @property
    def ledger_scan_steps(self) -> int:
        return 0


# ---------------------------------------------------------------------------
# Native device-plane policies (single-issuer tuned)
# ---------------------------------------------------------------------------
class _StampHold(PolicyHold):
    """Native stamp-it hold: a stamp in the ledger's critical-region set.

    Pages retired while it is open are tagged with stamps >= the hold's,
    so ``reclaim`` skips them until the hold completes — no buffering, no
    extra scan work (the hold costs O(1) to open and close, the paper's
    headline property)."""

    __slots__ = ("stamp",)

    def __init__(self, policy: "StampItPolicy", tag: str) -> None:
        super().__init__(policy, tag)
        self.stamp = policy.ledger.issue(tag)

    def _do_release(self) -> None:
        self._policy.ledger.complete(self.stamp)


class StampItPolicy(ReclamationPolicy):
    """The paper's scheme at the serving layer: retired pages are tagged
    with the highest stamp and parked on a stamp-sorted ring; reclamation
    pops a prefix once ``lowest_active`` passes — O(#reclaimable)."""

    name = "stamp-it"

    def __init__(self, ledger: Optional[StampLedger] = None) -> None:
        super().__init__()
        self.ledger = ledger or StampLedger()

    def begin_step(self, page_refs: Sequence[PageRef]) -> int:
        return self.ledger.issue("engine-step")

    def complete_step(self, handle: int) -> None:
        self.ledger.complete(handle)

    def _retire(self, slot: int, pages: Sequence[int]) -> None:
        # one ledger lock acquisition for the whole batch
        self.ledger.retire_many(
            [lambda s=slot, p=p: self.release(s, p) for p in pages]
        )
        self.ledger.reclaim()

    def _retire_refs(self, refs: Sequence[PageRef]) -> None:
        # native batch: the whole cross-slot batch is ONE stamped ledger
        # event (single lock acquisition, single ring append run, single
        # reclaim probe) — not one per slot group
        self.ledger.retire_many(
            [lambda s=s, p=p: self.release(s, p) for s, p in refs]
        )
        self.ledger.reclaim()

    def reclaim(self) -> None:
        self.ledger.reclaim()

    def _note_fork(self, n: int) -> None:
        # the whole fork batch is ONE stamped point event in the ledger —
        # no per-page counter traffic, the paper's O(1) bookkeeping story
        # carried over to CoW branch admission
        self.ledger.note_event("fork")

    def hold(self, tag: str = "hold") -> PolicyHold:
        h = _StampHold(self, tag)
        self.holds_issued += 1
        self.holds_open += 1
        return h

    def _force_release_impl(self, hold: PolicyHold) -> None:
        # native forced expiry: drop the hold's stamp from the active
        # set without a cooperative complete — the paper's mitigation
        # for a stalled/crashed thread, verbatim
        self.ledger.force_expire(hold.stamp)

    def _abandon_steps(self) -> int:
        # a dead issuer's step stamps would pin lowest_active forever;
        # expire the whole active set (holds were force-released first,
        # so what remains is step stamps)
        return self.ledger.force_expire_all()

    def _unreclaimed(self) -> int:
        return self.ledger.unreclaimed()

    @property
    def ledger_scan_steps(self) -> int:
        return self.ledger.scan_steps


class EpochPolicy(ReclamationPolicy):
    """ER-analogue: pages freed in epoch e are reusable two epoch advances
    later; advancing scans ALL in-flight steps (O(P), grace-period lag)."""

    name = "epoch"

    def __init__(self) -> None:
        super().__init__()
        self._lock = threading.Lock()
        self._next = 1
        self._epoch = 0
        self._inflight_epoch: Dict[int, int] = {}
        self._limbo: List[List[PageRef]] = [[], [], []]
        self._scans = 0

    def begin_step(self, page_refs: Sequence[PageRef]) -> int:
        with self._lock:
            h = self._next
            self._next += 1
            self._inflight_epoch[h] = self._epoch
            return h

    def complete_step(self, handle: int) -> None:
        with self._lock:
            self._inflight_epoch.pop(handle, None)
        self._try_advance()

    def _retire(self, slot: int, pages: Sequence[int]) -> None:
        with self._lock:
            self._limbo[self._epoch % 3].extend((slot, p) for p in pages)

    def _try_advance(self) -> None:
        """Advance once no in-flight step observed an older epoch; the
        check SCANS all in-flight steps (the O(P) cost)."""
        with self._lock:
            self._scans += max(len(self._inflight_epoch), 1)
            if any(e < self._epoch for e in self._inflight_epoch.values()):
                return
            self._epoch += 1
            bag = self._limbo[(self._epoch - 2) % 3]
            self._limbo[(self._epoch - 2) % 3] = []
        for slot, p in bag:
            self.release(slot, p)

    def reclaim(self) -> None:
        self._try_advance()

    def _abandon_steps(self) -> int:
        with self._lock:
            n = len(self._inflight_epoch)
            self._inflight_epoch.clear()
        for _ in range(3):  # drain all three limbo generations
            self._try_advance()
        return n

    def _unreclaimed(self) -> int:
        return sum(len(b) for b in self._limbo)

    @property
    def scan_steps(self) -> int:
        return self._scans


class ScanPolicy(ReclamationPolicy):
    """HP-analogue: reclaim scans every in-flight step's page-reference
    set; a page is reusable iff no step references it (O(P x refs))."""

    name = "scan"

    def __init__(self) -> None:
        super().__init__()
        self._lock = threading.Lock()
        self._next = 1
        self._inflight: Dict[int, Set[PageRef]] = {}
        self._pending: List[PageRef] = []
        self._scans = 0

    def begin_step(self, page_refs: Sequence[PageRef]) -> int:
        with self._lock:
            h = self._next
            self._next += 1
            self._inflight[h] = set(page_refs)
            return h

    def complete_step(self, handle: int) -> None:
        with self._lock:
            self._inflight.pop(handle, None)
        self._scan_reclaim()

    def _retire(self, slot: int, pages: Sequence[int]) -> None:
        with self._lock:
            self._pending.extend((slot, p) for p in pages)
        self._scan_reclaim()

    def _scan_reclaim(self) -> None:
        with self._lock:
            if not self._pending:
                return
            referenced: Set[PageRef] = set()
            for refs in self._inflight.values():
                self._scans += len(refs)
                referenced |= refs
            keep, free = [], []
            for ref in self._pending:
                (keep if ref in referenced else free).append(ref)
            self._pending = keep
        for slot, p in free:
            self.release(slot, p)

    def reclaim(self) -> None:
        self._scan_reclaim()

    def _abandon_steps(self) -> int:
        with self._lock:
            n = len(self._inflight)
            self._inflight.clear()
        self._scan_reclaim()
        return n

    def _unreclaimed(self) -> int:
        return len(self._pending)

    @property
    def scan_steps(self) -> int:
        return self._scans


class RefcountPolicy(ReclamationPolicy):
    """LFRC-analogue: per-page counters maintained on every dispatch and
    completion (immediate reuse, per-step counter overhead)."""

    name = "refcount"

    def __init__(self) -> None:
        super().__init__()
        self._lock = threading.Lock()
        self._next = 1
        self._inflight: Dict[int, Set[PageRef]] = {}
        self._rc: Dict[PageRef, int] = {}
        self._fork_rc: Dict[PageRef, int] = {}  # fork share of _rc
        self._pending: Set[PageRef] = set()

    def begin_step(self, page_refs: Sequence[PageRef]) -> int:
        with self._lock:
            h = self._next
            self._next += 1
            refs = set(page_refs)
            self._inflight[h] = refs
            for ref in refs:
                self._rc[ref] = self._rc.get(ref, 0) + 1
            return h

    def complete_step(self, handle: int) -> None:
        free = []
        with self._lock:
            for ref in self._inflight.pop(handle, set()):
                self._rc[ref] -= 1
                if self._rc[ref] == 0:
                    del self._rc[ref]
                    if ref in self._pending:
                        self._pending.discard(ref)
                        free.append(ref)
        for slot, p in free:
            self.release(slot, p)

    def _retire(self, slot: int, pages: Sequence[int]) -> None:
        free = []
        with self._lock:
            for p in pages:
                ref = (slot, p)
                if self._rc.get(ref, 0) == 0:
                    free.append(ref)
                else:
                    self._pending.add(ref)
        for slot, p in free:
            self.release(slot, p)

    # -- native fork path: a fork IS a refcount here ----------------------
    # (base `_fork` stays empty, so the generic retire interception is a
    # no-op and forked retires park in `_pending` like any pinned page)
    def fork_refs(self, refs: Sequence[PageRef]) -> None:
        refs = list(refs)
        with self._lock:
            for ref in refs:
                self._rc[ref] = self._rc.get(ref, 0) + 1
                self._fork_rc[ref] = self._fork_rc.get(ref, 0) + 1
        self.forks_taken += len(refs)

    def release_fork(self, refs: Sequence[PageRef]) -> None:
        free = []
        refs = list(refs)
        with self._lock:
            for ref in refs:
                assert self._fork_rc.get(ref, 0) > 0, (
                    f"release_fork without matching fork_refs: {ref}"
                )
                self._fork_rc[ref] -= 1
                if self._fork_rc[ref] == 0:
                    del self._fork_rc[ref]
                self._rc[ref] -= 1
                if self._rc[ref] == 0:
                    del self._rc[ref]
                    if ref in self._pending:
                        self._pending.discard(ref)
                        free.append(ref)
        self.forks_released += len(refs)
        for slot, p in free:
            self.release(slot, p)

    def fork_count(self, ref: PageRef) -> int:
        with self._lock:
            return self._fork_rc.get(ref, 0)

    def _clear_forks(self) -> List[PageRef]:
        free = []
        with self._lock:
            for ref, n in self._fork_rc.items():
                c = self._rc.get(ref, 0) - n
                if c <= 0:
                    self._rc.pop(ref, None)
                    if ref in self._pending:
                        self._pending.discard(ref)
                        free.append(ref)
                else:
                    self._rc[ref] = c
            self._fork_rc.clear()
        for slot, p in free:
            self.release(slot, p)
        return []

    def _abandon_steps(self) -> int:
        # reap dead steps through the normal completion path: their
        # counters decrement and zero-count pending pages free
        with self._lock:
            handles = list(self._inflight)
        for h in handles:
            self.complete_step(h)
        return len(handles)

    def _unreclaimed(self) -> int:
        return len(self._pending)


# ---------------------------------------------------------------------------
# Robust native policies: bounded memory under stalled actors
# ---------------------------------------------------------------------------
# Shared machinery: a global ERA advanced once per retire batch, a birth
# era stamped on every page at allocation (``note_alloc``), and an
# active-entry set (in-flight steps + open holds) whose members carry
# the era current when they were created.  Protection predicate: an
# entry with reservation era E protects a retired batch iff
# ``min_birth(batch) <= E`` — the entry could have observed those pages.
# Pages born after E (post-stall recycles: a freed page re-allocated
# gets a FRESH birth era) are invisible to it and flow freely, so a
# hold that is never released pins at most the pool's footprint at
# stall time — O(slots x pages_per_slot) — instead of every future
# retire.  That is the stalled-thread memory bound Hyaline and
# Crystalline are built around, and what ``robustness_bench.py`` gates.


class _RobustHold(PolicyHold):
    """Native hold for the robust policies: one entry in the active-era
    set, reservation era fixed at open time."""

    __slots__ = ("handle",)

    def __init__(self, policy, tag: str) -> None:
        super().__init__(policy, tag)
        with policy._lock:
            self.handle = policy._register_entry()

    def _do_release(self) -> None:
        self._policy._drop_entry(self.handle)


class _HyBatch:
    """One retired batch with its distributed reference count."""

    __slots__ = ("refs", "nrefs")

    def __init__(self, refs: List[PageRef], nrefs: int) -> None:
        self.refs = refs
        self.nrefs = nrefs


class HyalinePolicy(ReclamationPolicy):
    """Hyaline-analogue (arXiv:1905.07903): snapshot-free reclamation by
    per-batch DISTRIBUTED reference counts.

    At retire time the whole batch takes one reference per covering
    active entry (in-flight step or open hold whose reservation era is
    >= the batch's oldest birth) and is appended to each such entry's
    decrement list; with no coverer it frees immediately.  When an entry
    retires — step completes, hold releases cooperatively or by force —
    it walks its decrement list; a count hitting zero frees the whole
    batch.  No scanning and no global snapshot: reclamation work is one
    decrement per (entry, batch) pair, counted in ``scan_steps``."""

    name = "hyaline"

    def __init__(self) -> None:
        super().__init__()
        self._lock = threading.Lock()
        self._era = 0
        self._birth: Dict[PageRef, int] = {}
        self._entry_era: Dict[int, int] = {}
        self._entry_batches: Dict[int, List[_HyBatch]] = {}
        self._step_handles: Set[int] = set()
        self._next = 1
        self._limbo_pages = 0
        self._scans = 0

    def note_alloc(self, slot: int, pages: Sequence[int]) -> None:
        with self._lock:
            era = self._era
            for p in pages:
                self._birth[(slot, p)] = era

    def _register_entry(self) -> int:  # caller holds self._lock
        h = self._next
        self._next += 1
        self._entry_era[h] = self._era
        self._entry_batches[h] = []
        return h

    def begin_step(self, page_refs: Sequence[PageRef]) -> int:
        with self._lock:
            h = self._register_entry()
            self._step_handles.add(h)
            return h

    def complete_step(self, handle: int) -> None:
        self._drop_entry(handle)

    def _drop_entry(self, handle: int) -> None:
        free: List[PageRef] = []
        with self._lock:
            self._entry_era.pop(handle, None)
            self._step_handles.discard(handle)
            batches = self._entry_batches.pop(handle, [])
            self._scans += len(batches)
            for b in batches:
                b.nrefs -= 1
                if b.nrefs == 0:
                    free.extend(b.refs)
                    self._limbo_pages -= len(b.refs)
        for slot, p in free:
            self.release(slot, p)

    def _retire(self, slot: int, pages: Sequence[int]) -> None:
        self._retire_refs([(slot, p) for p in pages])

    def _retire_refs(self, refs: Sequence[PageRef]) -> None:
        refs = list(refs)
        if not refs:
            return
        with self._lock:
            min_birth = min(
                (self._birth.pop(ref, 0) for ref in refs), default=0)
            covering = [h for h, e in self._entry_era.items()
                        if min_birth <= e]
            self._era += 1
            if covering:
                batch = _HyBatch(refs, len(covering))
                for h in covering:
                    self._entry_batches[h].append(batch)
                self._limbo_pages += len(refs)
                refs = []
        for slot, p in refs:
            self.release(slot, p)

    def hold(self, tag: str = "hold") -> PolicyHold:
        h = _RobustHold(self, tag)
        self.holds_issued += 1
        self.holds_open += 1
        return h

    def _force_release_impl(self, hold: PolicyHold) -> None:
        self._drop_entry(hold.handle)

    def _abandon_steps(self) -> int:
        with self._lock:
            handles = list(self._step_handles)
        for h in handles:
            self._drop_entry(h)
        return len(handles)

    def _unreclaimed(self) -> int:
        with self._lock:
            return self._limbo_pages

    @property
    def scan_steps(self) -> int:
        return self._scans


class _CrBatch:
    """One limbo batch: coverage interval [min_birth, retire_era]."""

    __slots__ = ("min_birth", "retire_era", "refs")

    def __init__(self, min_birth: int, retire_era: int,
                 refs: List[PageRef]) -> None:
        self.min_birth = min_birth
        self.retire_era = retire_era
        self.refs = refs


class CrystallinePolicy(ReclamationPolicy):
    """Crystalline-analogue (arXiv:2108.02763): wait-free bounded-memory
    reclamation via slot-local limbo lists and lazy interval checks.

    Retired batches park on the RETIRING slot's limbo list tagged with
    the interval ``[min_birth, retire_era]``; an active entry with
    reservation era E covers a batch iff ``min_birth <= E <=
    retire_era`` — the batch's pages already existed when the entry was
    created AND the entry was already active when they retired (entries
    created later can never resurrect an old batch).  Probes — on step
    completion, hold release and ``reclaim()`` — sweep the limbo lists
    against the sorted active era set and free every uncovered batch;
    sweep work is counted in ``scan_steps``."""

    name = "crystalline"

    def __init__(self) -> None:
        super().__init__()
        self._lock = threading.Lock()
        self._era = 0
        self._birth: Dict[PageRef, int] = {}
        self._entry_era: Dict[int, int] = {}
        self._step_handles: Set[int] = set()
        self._next = 1
        self._limbo: Dict[int, List[_CrBatch]] = {}
        self._limbo_pages = 0
        self._scans = 0

    def note_alloc(self, slot: int, pages: Sequence[int]) -> None:
        with self._lock:
            era = self._era
            for p in pages:
                self._birth[(slot, p)] = era

    def _register_entry(self) -> int:  # caller holds self._lock
        h = self._next
        self._next += 1
        self._entry_era[h] = self._era
        return h

    def begin_step(self, page_refs: Sequence[PageRef]) -> int:
        with self._lock:
            h = self._register_entry()
            self._step_handles.add(h)
            return h

    def complete_step(self, handle: int) -> None:
        self._drop_entry(handle)

    def _drop_entry(self, handle: int) -> None:
        with self._lock:
            self._entry_era.pop(handle, None)
            self._step_handles.discard(handle)
        self._probe()

    def _park(self, slot: int, refs: List[PageRef]) -> None:
        # caller holds self._lock; one era bump per parked batch keeps
        # post-stall allocations strictly younger than the stall
        b = _CrBatch(
            min((self._birth.pop(r, 0) for r in refs), default=0),
            self._era, refs)
        self._era += 1
        self._limbo.setdefault(slot, []).append(b)
        self._limbo_pages += len(refs)

    def _retire(self, slot: int, pages: Sequence[int]) -> None:
        with self._lock:
            self._park(slot, [(slot, p) for p in pages])
        self._probe()

    def _retire_refs(self, refs: Sequence[PageRef]) -> None:
        refs = list(refs)
        if not refs:
            return
        with self._lock:
            for slot, pages in _group_by_slot(refs):
                self._park(slot, [(slot, p) for p in pages])
        self._probe()

    def _probe(self) -> None:
        free: List[PageRef] = []
        with self._lock:
            if self._limbo_pages:
                eras = sorted(self._entry_era.values())
                for slot in list(self._limbo):
                    keep = []
                    for b in self._limbo[slot]:
                        self._scans += 1
                        i = bisect.bisect_left(eras, b.min_birth)
                        if i < len(eras) and eras[i] <= b.retire_era:
                            keep.append(b)  # some active entry covers it
                        else:
                            free.extend(b.refs)
                            self._limbo_pages -= len(b.refs)
                    if keep:
                        self._limbo[slot] = keep
                    else:
                        del self._limbo[slot]
        for slot, p in free:
            self.release(slot, p)

    def reclaim(self) -> None:
        self._probe()

    def hold(self, tag: str = "hold") -> PolicyHold:
        h = _RobustHold(self, tag)
        self.holds_issued += 1
        self.holds_open += 1
        return h

    def _force_release_impl(self, hold: PolicyHold) -> None:
        self._drop_entry(hold.handle)

    def _abandon_steps(self) -> int:
        with self._lock:
            handles = list(self._step_handles)
            self._step_handles.clear()
            for h in handles:
                self._entry_era.pop(h, None)
        self._probe()
        return len(handles)

    def _unreclaimed(self) -> int:
        with self._lock:
            return self._limbo_pages

    @property
    def scan_steps(self) -> int:
        return self._scans


# ---------------------------------------------------------------------------
# Adapter over the paper's host-plane schemes
# ---------------------------------------------------------------------------
class _PageNode(ReclaimableNode):
    """A ReclaimableNode standing for one (slot, page) of HBM."""

    __slots__ = ("ref",)

    def __init__(self, ref: PageRef) -> None:
        super().__init__()
        self.ref = ref


class _RegionHold(PolicyHold):
    """Native adapter hold: a paper thread parked inside a critical
    region, blocking the scheme's grace periods until released."""

    __slots__ = ("_rec",)

    def __init__(self, policy: "CoreSchemeAdapter", tag: str, rec) -> None:
        super().__init__(policy, tag)
        self._rec = rec

    def _do_release(self) -> None:
        self._policy._close_region_hold(self._rec)


class CoreSchemeAdapter(ReclamationPolicy):
    """Run the serving workload through any ``core.schemes`` Reclaimer.

    Mapping (see module docstring): each in-flight engine step is a paper
    *thread* inside a critical region.  ``begin_step`` attaches a fresh
    ThreadRecord and enters a region on it; for pointer-based schemes
    (``protect_implies_safe == False``: hazard pointers, LFRC) it
    additionally acquires one guard per referenced page, because a region
    alone protects nothing under those schemes.  Pages are intrusive
    :class:`ReclaimableNode`s living behind per-page ``AtomicMarkedRef``
    cells; retiring a page unlinks its cell and retires the node from the
    engine thread's own record, and the node's ``finalizer`` returns the
    page to the pool when the scheme frees it.

    ``complete_step`` is the single-issuer quiescent point: the step's
    guards reset, its record leaves the region and detaches, and the
    engine record runs the scheme's own maintenance (``flush``) — the
    scheme's scan/advance cost is therefore ITS cost, measured by its own
    ``scan_steps`` counter, exactly as in the §4 benchmarks.
    """

    def __init__(self, reclaimer: Reclaimer) -> None:
        super().__init__()
        self.reclaimer = reclaimer
        self.name = getattr(reclaimer, "name", "core")
        # RLock: host actors (prefix-cache drain, checkpoint DMA) may
        # retire concurrently with the engine thread's step lifecycle,
        # and a reclaim inside the lock runs finalizers that touch
        # released_pages re-entrantly.
        self._lock = threading.RLock()
        self._nodes: Dict[PageRef, Tuple[_PageNode, AtomicMarkedRef]] = {}
        self._steps: Dict[int, Tuple[object, list]] = {}
        self._next = 1
        self._use_guards = not reclaimer.protect_implies_safe
        self.retired_pages = 0
        self.released_pages = 0
        # LFRC-native CoW forks: one long-lived paper-thread whose guards
        # ARE the fork references (each guard acquisition is a Valois
        # rc increment on the page node; the last reset drops rc to 0 and
        # the scheme frees through the node finalizer).  Other guarded
        # schemes (hazard) cannot hold per-branch long-lived protections
        # without pinning a slot per page forever, and region schemes
        # would pin EVERY page retired meanwhile — both use the generic
        # fork park-table instead.
        self._fork_guards: Dict[PageRef, List[Guard]] = {}
        self._fork_rec = None

    # -- page cells -----------------------------------------------------
    def _cell_for(self, ref: PageRef) -> Tuple[_PageNode, AtomicMarkedRef]:
        entry = self._nodes.get(ref)
        if entry is None:
            node = _PageNode(ref)
            node.finalizer = self._make_finalizer(ref)
            self.reclaimer.on_allocate(node)  # birth era for IBR
            entry = (node, AtomicMarkedRef(node))
            self._nodes[ref] = entry
        return entry

    def _make_finalizer(self, ref: PageRef) -> Callable[[], None]:
        def _release() -> None:
            with self._lock:
                self.released_pages += 1
            self.release(ref[0], ref[1])

        return _release

    # -- step lifecycle -------------------------------------------------
    def begin_step(self, page_refs: Sequence[PageRef]) -> int:
        r = self.reclaimer
        with self._lock:
            rec = r._acquire_record()  # a fresh paper-thread per step
            rec.region_depth = 1
            r._enter_region(rec)
            guards = []
            if self._use_guards:
                for ref in page_refs:
                    _, cell = self._cell_for(ref)
                    g = Guard(r, rec)
                    g.acquire(cell)
                    guards.append(g)
            h = self._next
            self._next += 1
            self._steps[h] = (rec, guards)
            return h

    def complete_step(self, handle: int) -> None:
        with self._lock:
            rec, guards = self._steps.pop(handle)
            for g in guards:
                g.reset()
            rec.region_depth = 0
            self.reclaimer._leave_region(rec)
            self.reclaimer._on_thread_detach(rec)
            rec.in_use.store(0)
            # single-issuer maintenance point: the scheme reclaims what
            # its own rules now allow (epoch advance, hazard scan, ...)
            self.reclaimer.flush()

    # -- copy-on-write forks --------------------------------------------
    @property
    def _native_fork(self) -> bool:
        return getattr(self.reclaimer, "name", "") == "lfrc"

    def fork_refs(self, refs: Sequence[PageRef]) -> None:
        if not self._native_fork:
            return super().fork_refs(refs)
        refs = list(refs)
        if not refs:
            return
        with self._lock:
            if self._fork_rec is None:
                rec = self.reclaimer._acquire_record()
                rec.region_depth = 1
                self.reclaimer._enter_region(rec)
                self._fork_rec = rec
            for ref in refs:
                _, cell = self._cell_for(ref)
                g = Guard(self.reclaimer, self._fork_rec)
                g.acquire(cell)  # LFRC: Valois safe-read, rc += 1
                assert g.get() is not None, (
                    f"fork_refs on a retired page: {ref}"
                )
                self._fork_guards.setdefault(ref, []).append(g)
        self.forks_taken += len(refs)

    def release_fork(self, refs: Sequence[PageRef]) -> None:
        if not self._native_fork:
            return super().release_fork(refs)
        refs = list(refs)
        if not refs:
            return
        with self._lock:
            for ref in refs:
                guards = self._fork_guards.get(ref)
                assert guards, (
                    f"release_fork without matching fork_refs: {ref}"
                )
                guards.pop().reset()  # rc -= 1; frees at 0 if retired
                if not guards:
                    del self._fork_guards[ref]
            if not self._fork_guards and self._fork_rec is not None:
                rec, self._fork_rec = self._fork_rec, None
                rec.region_depth = 0
                self.reclaimer._leave_region(rec)
                self.reclaimer._on_thread_detach(rec)
                rec.in_use.store(0)
            self.reclaimer.flush()
        self.forks_released += len(refs)

    def fork_count(self, ref: PageRef) -> int:
        if not self._native_fork:
            return super().fork_count(ref)
        with self._lock:
            return len(self._fork_guards.get(ref, ()))

    def _clear_forks(self) -> List[PageRef]:
        if not self._native_fork:
            return super()._clear_forks()
        with self._lock:
            for guards in self._fork_guards.values():
                for g in guards:
                    g.reset()
            self._fork_guards.clear()
            if self._fork_rec is not None:
                rec, self._fork_rec = self._fork_rec, None
                rec.region_depth = 0
                self.reclaimer._leave_region(rec)
                self.reclaimer._on_thread_detach(rec)
                rec.in_use.store(0)
            self.reclaimer.flush()
        return []

    # -- allocation births ----------------------------------------------
    def note_alloc(self, slot: int, pages: Sequence[int]) -> None:
        """IBR is the one core scheme whose safety predicate reads a
        birth era; stamp it at true allocation time (not lazily when the
        cell first materialises at retire) so a region hold opened after
        the allocation covers the page's whole lifetime interval.  The
        other core schemes ignore births — skip the eager cell creation
        on their alloc hot path."""
        if getattr(self.reclaimer, "name", "") != "ibr":
            return
        with self._lock:
            for p in pages:
                self._cell_for((slot, p))

    # -- retire / reclaim ----------------------------------------------
    def _retire(self, slot: int, pages: Sequence[int]) -> None:
        with self._lock:
            for p in pages:
                ref = (slot, p)
                node, cell = self._cell_for(ref)
                del self._nodes[ref]  # re-allocation gets a fresh node
                cell.store(None)  # unlink: no new protector finds it
                self.retired_pages += 1
                self.reclaimer.retire(node)

    def reclaim(self) -> None:
        with self._lock:
            self.reclaimer.flush()

    # -- host-actor holds ----------------------------------------------
    def hold(self, tag: str = "hold") -> PolicyHold:
        """Region-based schemes (``protect_implies_safe``: epochs, QSR,
        DEBRA, IBR, stamp-it-core) pin natively — a fresh paper-thread
        enters a critical region and simply never quiesces until release,
        which blocks grace periods for every page retired meanwhile.
        Pointer-based schemes (hazard, LFRC) CANNOT name pages retired in
        the future, so they fall back to the generic buffered hold — the
        exact asymmetry the paper's long-lived-region scenario probes."""
        if not self.reclaimer.protect_implies_safe:
            return super().hold(tag)
        with self._lock:
            rec = self.reclaimer._acquire_record()
            rec.region_depth = 1
            self.reclaimer._enter_region(rec)
        h = _RegionHold(self, tag, rec)
        self.holds_issued += 1
        self.holds_open += 1
        return h

    def _close_region_hold(self, rec) -> None:
        with self._lock:
            rec.region_depth = 0
            self.reclaimer._leave_region(rec)
            self.reclaimer._on_thread_detach(rec)
            rec.in_use.store(0)
            self.reclaimer.flush()

    def _force_release_impl(self, hold: PolicyHold) -> None:
        if isinstance(hold, _RegionHold):
            # region force-exit: the parked paper-thread is reaped by a
            # third party — its record leaves the region and detaches,
            # un-blocking the scheme's grace periods
            self._close_region_hold(hold._rec)
        else:  # pointer-based schemes hold via the buffered fallback
            super()._force_release_impl(hold)

    def _abandon_steps(self) -> int:
        # reap each dead step's paper-thread: guards reset, record
        # leaves its region and detaches — the reclaimer then advances
        # under its own rules as if the thread had exited cleanly
        with self._lock:
            handles = list(self._steps)
        for h in handles:
            self.complete_step(h)
        return len(handles)

    def _unreclaimed(self) -> int:
        with self._lock:
            return self.retired_pages - self.released_pages

    @property
    def scan_steps(self) -> int:
        counter = getattr(self.reclaimer, "scan_steps", None)
        return counter.load() if counter is not None else 0


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
def _core(scheme_name: str) -> Callable[[], ReclamationPolicy]:
    def factory() -> ReclamationPolicy:
        from ..core import make_reclaimer

        # 64 records bound the O(max_threads) record-acquisition scan;
        # pipeline_depth + the engine thread is all we ever attach.
        return CoreSchemeAdapter(make_reclaimer(scheme_name, max_threads=64))

    return factory


#: serving-plane policy registry — the paper's seven schemes, the native
#: single-issuer analogues, and the two robust bounded-memory schemes
#: from PAPERS.md (hyaline, crystalline)
POLICIES: Dict[str, Callable[[], ReclamationPolicy]] = {
    "stamp-it": StampItPolicy,
    "epoch": EpochPolicy,
    "scan": ScanPolicy,
    "refcount": RefcountPolicy,
    "hyaline": HyalinePolicy,
    "crystalline": CrystallinePolicy,
    "stamp-it-core": _core("stamp-it"),
    "new-epoch": _core("ner"),
    "hazard": _core("hpr"),
    "interval": _core("ibr"),
    "qsr": _core("qsr"),
    "debra": _core("debra"),
    "lfrc": _core("lfrc"),
}

#: the cross-policy comparison set at serving scale: the paper's
#: seven-scheme set plus the two robust schemes — TEN policies, every
#: serving/cluster/fault/disagg matrix runs across all of them
PAPER_POLICIES = (
    "stamp-it", "epoch", "new-epoch", "hazard", "interval", "qsr",
    "debra", "lfrc", "hyaline", "crystalline",
)

#: schemes whose unreclaimed memory stays bounded by the pool footprint
#: AT STALL TIME under a hold that is never released — the other
#: schemes pin every subsequent retire until the pool itself runs dry
#: (the JAX package's docs/reclamation_policies.md)
ROBUST_POLICIES = ("hyaline", "crystalline")


def make_policy(policy, ledger: Optional[StampLedger] = None):
    """Resolve a policy name (or pass through an instance).

    ``ledger`` lets host actors share a StampLedger with the pool (their
    ``hold()`` pins page reclamation); only the ledger-backed policy can
    honor it, so anything else REJECTS the combination rather than
    silently leaving the caller's holds unconnected (use-after-free)."""
    if isinstance(policy, ReclamationPolicy):
        if ledger is not None and getattr(policy, "ledger", None) is not ledger:
            raise ValueError(
                f"policy {policy.name!r} does not use the supplied ledger; "
                f"holds taken on it would not pin reclamation"
            )
        return policy
    if policy == "stamp-it":
        return StampItPolicy(ledger)
    if ledger is not None:
        raise ValueError(
            f"policy {policy!r} is not ledger-backed; a shared-ledger "
            f"hold() would not pin reclamation — use policy='stamp-it'"
        )
    try:
        return POLICIES[policy]()
    except KeyError:
        raise ValueError(
            f"unknown reclamation policy {policy!r}; "
            f"available: {sorted(POLICIES)}"
        ) from None
