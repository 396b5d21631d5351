"""Paged HBM block pool, written once against the ReclamationPolicy plane.

The pool hands out page ids for the per-slot paged KV arrays
(``(B_slots, n_pool, block, Hkv, D)``).  Freed pages cannot be reused
immediately: an in-flight asynchronous device step (or a prefix-cache pin,
or a checkpoint DMA) may still read them.  WHICH pages are safe to reuse
WHEN is entirely the policy's business — the pool only owns the free
lists and exposes the step/retire lifecycle, exactly as the paper's data
structures are written once against the Robison interface and
parameterized by the reclaimer (see :mod:`repro_torch.memory.policy`
for the full registry: stamp-it, epoch, new-epoch, hazard, interval, qsr,
debra, lfrc, the robust hyaline/crystalline pair, plus the native
scan/refcount analogues).
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Union

from ..obs.metrics import Registry
from ..obs.reclaim_trace import ReclaimTracer
from .policy import PolicyHold, ReclamationPolicy, make_policy
from .stamp_ledger import StampLedger


class PoolExhausted(RuntimeError):
    pass


class ShardedPoolSet:
    """Cluster-level view of a logical pool sharded one-BlockPool-per-
    replica.

    Hyaline-style locality (arXiv:1905.07903): retirement lists, free
    lists and stamp domains all stay *per shard*, so reclamation work
    never crosses a replica boundary; the set only aggregates capacity
    and pressure signals for the router (least-loaded-by-free-pages) and
    the cluster ledger's observability.  Each shard is a full
    :class:`BlockPool` backed by its replica's own device arrays."""

    def __init__(self, n_shards: int) -> None:
        if n_shards < 1:
            raise ValueError("need at least one shard")
        self.n_shards = n_shards
        self.pools: List[Optional["BlockPool"]] = [None] * n_shards

    def register(self, pool: "BlockPool") -> None:
        sid = pool.shard_id
        if not 0 <= sid < self.n_shards:
            raise ValueError(
                f"shard_id {sid} out of range for {self.n_shards} shards"
            )
        if self.pools[sid] is not None:
            raise ValueError(f"shard {sid} already registered")
        self.pools[sid] = pool

    def grow(self) -> int:
        """Append a fresh shard slot for a replica added to a LIVE group
        (``ReplicaGroup.add_replica``); returns the new shard id, which
        the new replica's BlockPool registers under."""
        self.pools.append(None)
        self.n_shards += 1
        return self.n_shards - 1

    def retire_shard(self, shard_id: int) -> None:
        """Drop a drained (or dead) replica's shard: its pages leave the
        aggregate capacity/pressure signals entirely.  The slot stays
        allocated so surviving shard ids are stable."""
        if not 0 <= shard_id < self.n_shards:
            raise ValueError(
                f"shard_id {shard_id} out of range for "
                f"{self.n_shards} shards"
            )
        if self.pools[shard_id] is None:
            raise ValueError(f"shard {shard_id} is not registered")
        self.pools[shard_id] = None

    def _live(self) -> List["BlockPool"]:
        return [p for p in self.pools if p is not None]

    # -- aggregate observability / routing signals ----------------------
    def free_pages(self) -> int:
        return sum(p.free_pages_total() for p in self._live())

    def pages_total(self) -> int:
        return sum(p.n_slots * p.pages_per_slot for p in self._live())

    def unreclaimed(self) -> int:
        return sum(p.unreclaimed() for p in self._live())

    def scan_steps(self) -> int:
        return sum(p.scan_steps for p in self._live())

    def ledger_scan_steps(self) -> int:
        return sum(p.ledger_scan_steps for p in self._live())


class BlockPool:
    def __init__(
        self,
        n_slots: int,
        pages_per_slot: int,
        *,
        policy: Union[str, ReclamationPolicy] = "stamp-it",
        ledger: Optional[StampLedger] = None,
        shard_id: int = 0,
        shard_set: Optional[ShardedPoolSet] = None,
        registry: Optional[Registry] = None,
    ) -> None:
        self.n_slots = n_slots
        self.pages_per_slot = pages_per_slot
        self.policy = make_policy(policy, ledger)
        self.policy_name = self.policy.name
        # observability plane: retire->reclaim / hold-lifetime /
        # fork-park tracing, labeled by policy and shard (replica)
        self.trace = ReclaimTracer(registry, self.policy_name,
                                   replica=shard_id)
        # cluster plane: which replica's slice of the logical pool this is
        self.shard_id = shard_id
        self.shard_set = shard_set
        self._lock = threading.Lock()
        # ascending allocation order (pop from the end of a reversed list)
        self._free: List[List[int]] = [
            list(range(pages_per_slot - 1, -1, -1)) for _ in range(n_slots)
        ]
        self.freed_total = 0
        self.reused_total = 0
        self.forks_taken = 0
        self.forks_released = 0
        self.policy.bind(self)
        if shard_set is not None:
            shard_set.register(self)

    # ------------------------------------------------------------------
    # allocation
    # ------------------------------------------------------------------
    def alloc(self, slot: int, n: int) -> List[int]:
        with self._lock:
            free = self._free[slot]
            if len(free) >= n:
                pages = [free.pop() for _ in range(n)]
                self.reused_total += n
            else:
                pages = None
                shortfall = len(free)
        # both policy probes below take the POLICY's lock — do them
        # outside the pool lock (a concurrent retire runs policy-lock ->
        # pool-lock via the release callback; nesting the other way
        # would deadlock)
        if pages is not None:
            # birth-era stamp for the robust policies (no-op elsewhere)
            self.policy.note_alloc(slot, pages)
            return pages
        raise PoolExhausted(
            f"slot {slot}: need {n} pages, {shortfall} free "
            f"({self.unreclaimed()} awaiting reclamation)"
        )

    def free_slot_pages(self, slot: int) -> int:
        with self._lock:
            return len(self._free[slot])

    def free_pages_total(self) -> int:
        """Router load signal: free pages across all slots of this shard."""
        with self._lock:
            return sum(len(f) for f in self._free)

    def _release_page(self, slot: int, page: int) -> None:
        """Policy callback: the page is safe — back on the free list.
        EVERY policy's reclaims funnel through here (wired by
        ``policy.bind``), which is what makes the retire->reclaim
        latency histogram uniform across all ten schemes."""
        with self._lock:
            self._free[slot].append(page)
            self.freed_total += 1
        self.trace.on_reclaim(slot, page)

    # ------------------------------------------------------------------
    # step lifecycle (async dispatch) — delegated to the policy
    # ------------------------------------------------------------------
    def begin_step(self, page_refs: Sequence[tuple]) -> int:
        """Dispatch: returns an opaque step handle; page_refs = pages this
        step may read ((slot, page) tuples)."""
        self.trace.on_step()
        return self.policy.begin_step(page_refs)

    def complete_step(self, handle: int) -> None:
        self.policy.complete_step(handle)

    def free(self, slot: int, pages: Sequence[int]) -> None:
        """Retire pages through the policy (NEVER straight to the free
        list — an in-flight step may still read them)."""
        self.trace.on_retire((slot, p) for p in pages)
        self.policy.retire_pages(slot, pages)

    def free_refs(self, refs: Sequence[tuple]) -> None:
        """Batch retire across slots ((slot, page) tuples) — one policy
        bookkeeping event for the whole batch (chunk-batched stamping;
        see ReclamationPolicy.retire_many)."""
        refs = list(refs)
        self.trace.on_retire(refs)
        self.policy.retire_many(refs)

    # ------------------------------------------------------------------
    # copy-on-write fork references
    # ------------------------------------------------------------------
    def fork_refs(self, refs: Sequence[tuple]) -> None:
        """A CoW branch now shares these pages: take one fork reference
        each.  A forked page retired by its owner stays out of the free
        list until the LAST branch releases it (then the whole deferred
        set retires as one policy batch)."""
        self.policy.fork_refs(refs)
        self.forks_taken += len(list(refs))

    def release_fork(self, refs: Sequence[tuple]) -> None:
        """A branch is done with these shared pages (finished or killed)."""
        refs = list(refs)
        self.policy.release_fork(refs)
        self.forks_released += len(refs)

    def fork_count(self, ref: tuple) -> int:
        """Live fork references on one (slot, page) — observability."""
        return self.policy.fork_count(ref)

    def reclaim(self) -> None:
        """Best-effort maintenance (drain / teardown), not the hot path."""
        self.policy.reclaim()

    def hold(self, tag: str = "hold") -> PolicyHold:
        """Host-actor hold on this shard's stamp domain: pages retired
        while it is open are not reclaimed until it releases."""
        return self.policy.hold(tag)

    def force_quiesce(self) -> dict:
        """Lifecycle plane: forcibly expire this shard's whole stamp
        domain (its replica was declared dead or drained) — every open
        hold force-released, every in-flight step handle abandoned."""
        return self.policy.force_quiesce()

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    def unreclaimed(self) -> int:
        return self.policy.unreclaimed()

    @property
    def scan_steps(self) -> int:
        return self.policy.scan_steps

    @property
    def ledger_scan_steps(self) -> int:
        return self.policy.ledger_scan_steps

    def publish(self) -> None:
        """Mirror this pool's always-on counters into the registry
        (pull-style sync: the hot paths keep plain attributes, the
        registry gets them at collection time)."""
        reg = self.trace.registry
        if not reg.enabled:
            return
        lab = dict(policy=self.policy_name, replica=self.shard_id)
        reg.gauge("pool_free_pages", **lab).set(self.free_pages_total())
        reg.gauge("pool_pages_total", **lab).set(
            self.n_slots * self.pages_per_slot)
        reg.gauge("unreclaimed_pages", **lab).set(self.unreclaimed())
        reg.gauge("pages_freed", **lab).set(self.freed_total)
        reg.gauge("pages_reused", **lab).set(self.reused_total)
        reg.gauge("scan_steps", **lab).set(
            self.scan_steps + self.ledger_scan_steps)
        p = self.policy
        reg.gauge("holds_issued", **lab).set(p.holds_issued)
        reg.gauge("holds_open", **lab).set(p.holds_open)
        reg.gauge("holds_force_released", **lab).set(p.force_released)
        reg.gauge("forks_taken", **lab).set(p.forks_taken)
        reg.gauge("forks_released", **lab).set(p.forks_released)
        led = self.ledger
        if led is not None:
            reg.gauge("ledger_retired_total", **lab).set(
                led.retired_total)
            reg.gauge("ledger_reclaimed_total", **lab).set(
                led.reclaimed_total)
            reg.gauge("ledger_scan_steps", **lab).set(led.scan_steps)
            for ev, n in led.events.items():
                reg.gauge("ledger_events", event=ev, **lab).set(n)

    @property
    def ledger(self) -> Optional[StampLedger]:
        """The stamp ledger for ledger-backed policies (stamp-it), else
        None — host actors needing epoch pins (checkpoint writer,
        detokenizer) hold through this when available."""
        return getattr(self.policy, "ledger", None)
