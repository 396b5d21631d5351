"""Pluggable reclamation policies for the serving-plane BlockPool.

The paper's central methodological move is putting Stamp-it and its
competitors behind one Robison-style interface so data structures are
written once and parameterized by the reclaimer.  This module gives the
serving plane the same property: :class:`ReclamationPolicy` is the
interface the BlockPool (and therefore the ServingEngine and PrefixCache)
are written against, and each scheme is a concrete policy.

This package carries two of them, tuned to the single-issuer dispatch
loop: ``stamp-it`` (StampLedger) and ``epoch`` (ER-analogue).  Every
in-flight asynchronous device step is a *thread in a critical region*:
``begin_step`` enters, ``complete_step`` leaves, and a retired page
returns to the pool free list only once no step that could read it is
still in flight.

Invariant (asserted in tests/test_torch_engine.py): a policy changes
POOL PRESSURE, never model outputs.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

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


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
#: serving-plane policy registry of the PyTorch package: the paper's
#: scheme and the epoch baseline.  The other schemes of the JAX package
#: (and the adapter over its core Reclaimer implementations) are not
#: ported yet.
POLICIES: Dict[str, Callable[[], ReclamationPolicy]] = {
    "stamp-it": StampItPolicy,
    "epoch": EpochPolicy,
}


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
