"""Retire->reclaim latency tracing — the paper's "reclaims earlier" claim.

Stamp-it's headline over the epoch family (arXiv:1805.08639 §5) is that
free nodes come back *earlier*: a retired node waits only for the steps
that were in flight when it retired, not for a global epoch to advance
twice.  This module measures exactly that, uniformly for all ten
policies, by hooking the two points every scheme already funnels
through:

* ``BlockPool.free``/``free_refs`` — every retire enters the policy
  here; the tracer stamps each (slot, page) ref with the pool's step
  clock (advanced in ``begin_step``).
* ``BlockPool._release_page`` — every reclaim exits the policy here
  (wired via ``policy.bind``); the step delta is observed into the
  per-policy ``reclaim_latency_steps`` histogram.

Two companion distributions ride the same tracer via the
``ReclamationPolicy`` base-class hold/fork hooks:

* ``hold_lifetime_steps`` — opened at ``_track_hold`` (every
  ``PolicyHold`` construction: buffered, stamp, region and robust holds
  alike), closed at ``_untrack_hold``.  Because ``_claim_release`` lets
  exactly one of ``release``/``force_release`` run the release body, a
  force-released hold is observed ONCE — the no-double-count property
  ``tests/test_obs.py`` asserts under ``force_quiesce``.
* ``fork_park_steps`` — a CoW page retired while forked parks in
  ``_fork_parked`` until its last branch releases; the park duration
  for the generic park-table policies (natives with their own fork
  counters — refcount, lfrc — retire through those instead and record
  nothing here).

Every method guards on ``enabled`` first: with a disabled registry the
tracer is a handful of predictable branches per step — the <= 5%
overhead budget the bench gate asserts.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional, Tuple

from .metrics import Registry, get_registry

PageRef = Tuple[int, int]


class ReclaimTracer:
    """Per-pool tracer; one instance per BlockPool, labeled by policy
    and replica (shard) so cluster registries aggregate cleanly."""

    def __init__(self, registry: Optional[Registry], policy: str,
                 replica: int = 0) -> None:
        self.registry = registry or get_registry()
        self.enabled = self.registry.enabled
        self.step = 0
        self.reclaim_hist = self.registry.histogram(
            "reclaim_latency_steps", policy=policy, replica=replica)
        self.hold_hist = self.registry.histogram(
            "hold_lifetime_steps", policy=policy, replica=replica)
        self.fork_hist = self.registry.histogram(
            "fork_park_steps", policy=policy, replica=replica)
        # leaf lock: hooks fire from pool- and policy-lock contexts
        self._lock = threading.Lock()
        self._retired_at: Dict[PageRef, int] = {}
        self._hold_opened: Dict[int, int] = {}       # id(hold) -> step
        self._fork_parked_at: Dict[PageRef, int] = {}

    # -- pool step clock ------------------------------------------------
    def on_step(self) -> None:
        self.step += 1

    # -- retire -> reclaim ----------------------------------------------
    def on_retire(self, refs: Iterable[PageRef]) -> None:
        if not self.enabled:
            return
        t = self.step
        with self._lock:
            for ref in refs:
                self._retired_at[ref] = t

    def on_reclaim(self, slot: int, page: int) -> None:
        if not self.enabled:
            return
        with self._lock:
            t0 = self._retired_at.pop((slot, page), None)
            if t0 is not None:
                self.reclaim_hist.observe(self.step - t0)

    # -- hold lifetimes -------------------------------------------------
    def on_hold_open(self, hold) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._hold_opened[id(hold)] = self.step

    def on_hold_close(self, hold) -> None:
        if not self.enabled:
            return
        with self._lock:
            t0 = self._hold_opened.pop(id(hold), None)
            if t0 is not None:
                self.hold_hist.observe(self.step - t0)

    # -- CoW fork parking -----------------------------------------------
    def on_fork_park(self, ref: PageRef) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._fork_parked_at.setdefault(ref, self.step)

    def on_fork_unpark(self, ref: PageRef) -> None:
        if not self.enabled:
            return
        with self._lock:
            t0 = self._fork_parked_at.pop(ref, None)
            if t0 is not None:
                self.fork_hist.observe(self.step - t0)

    # -- summaries ------------------------------------------------------
    def summary(self) -> dict:
        """Percentile summary of the three distributions (bench rows)."""
        out = {}
        for key, h in (("reclaim_latency", self.reclaim_hist),
                       ("hold_lifetime", self.hold_hist),
                       ("fork_park", self.fork_hist)):
            out[key] = {
                "count": h.count, "mean": h.mean,
                "p50": h.percentile(50), "p90": h.percentile(90),
                "p99": h.percentile(99), "max": h.max,
            }
        out["pending_retired"] = len(self._retired_at)
        return out
