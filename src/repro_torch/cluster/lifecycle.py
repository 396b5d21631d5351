"""Lifecycle control plane: heartbeats, shared-fate hold expiry, replay.

The paper's known weakness — one stalled thread blocks reclamation for
everyone — reappears in this cluster verbatim, at replica granularity: a
crashed replica's :class:`~repro_torch.cluster.ledger.ClusterHold` parts pin
pages in EVERY replica's stamp domain, and nothing will ever release
them cooperatively.  Stamp-it's mitigation is *forced stamp expiry*;
robust schemes (Hyaline, Crystalline) make stall-robustness the headline
property.  The :class:`LifecycleManager` is that mitigation as a control
plane:

  * **heartbeats** — every live replica publishes its monotone engine
    step counter once per cluster step (publication itself is the
    liveness signal: a crashed replica goes silent).  ``heartbeat_
    timeout`` missed cluster steps mark the replica **dead**.
  * **shared-fate expiry** — on death, every cluster hold owned by the
    dead replica's actors is revoked through each scheme's native
    forced path (:meth:`ReclamationPolicy.force_release`: stamp
    force-expire / region force-exit / buffered-flush), its own domain
    is wholesale-expired (``force_quiesce``: abandoned step handles,
    chunk holds), and its shard retires from the aggregates.  The
    ``reclamation_blocked_steps`` counter observes the window in which
    a silent replica's holds actually pinned retired pages — the proof
    that pages stayed unreclaimed *until* expiry, not merely that
    expiry ran.
  * **request replay** — the dead replica's journal
    (:class:`~repro_torch.cluster.journal.RequestJournal`) re-admits its
    unfinished requests on survivors through the group's router.
    *Resumable* entries — greedy, or sampled with a journaled
    ``sample_key`` (counter sampling: the u for sequence index ``pos``
    is ``counter_uniform(key, pos)``, replica-independent) — resume
    token-for-token: the survivor teacher-forces ``prompt + emitted``
    and generates only the remaining budget, so the stitched stream is
    bit-identical to a no-fault run.  Only keyless sampled requests
    restart from scratch.

The manager never reads fault-injection state (``engine.crashed``) to
*detect* anything — detection is purely missed heartbeats, exactly as a
remote cluster manager would see it.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from ..serving.scheduler import Request
from .journal import JournalEntry


class HoldWatchdog:
    """Hold-AGE escalation: deadline -> warn -> force-expire.

    Heartbeat death catches a replica that stops *stepping*; it cannot
    catch a replica that keeps beating while an actor on it sits wedged
    inside a hold — the live-but-stalled thread of the paper's weakness,
    which pins pages in every domain the hold entered.  The watchdog
    sweeps a set of open holds each tick, tracks each hold's age, WARNS
    once past ``warn_after`` ticks (``hold_warnings``) and force-expires
    past ``expire_after`` (``hold_expired_by_watchdog``) through the
    hold's native forced path — so a wedged actor degrades to a revoked
    pin instead of unbounded unreclaimed growth.

    Works over :class:`~repro_torch.cluster.ledger.ClusterHold` objects (which
    force-release themselves) and bare
    :class:`~repro_torch.memory.policy.PolicyHold` parts (forced through their
    policy); the caller supplies the open-hold snapshot each tick, so
    the same watchdog serves the cluster ledger, a single pool, or the
    robustness bench's stall injector."""

    def __init__(self, *, expire_after: int, warn_after: Optional[int] =
                 None, exempt_tags: Sequence[str] = ()) -> None:
        if expire_after < 1:
            raise ValueError("expire_after must be >= 1 tick")
        self.expire_after = expire_after
        self.warn_after = (max(1, expire_after // 2)
                           if warn_after is None else warn_after)
        if not 1 <= self.warn_after <= expire_after:
            raise ValueError("need 1 <= warn_after <= expire_after")
        self._exempt = set(exempt_tags)
        self.ticks = 0
        self.hold_warnings = 0
        self.hold_expired_by_watchdog = 0
        #: (tag, age) at each warning — observability for the report
        self.warnings: List[Tuple[str, int]] = []
        self._first_seen: Dict[Any, int] = {}  # hold -> tick first seen
        self._warned: Set[Any] = set()

    @staticmethod
    def _force(hold) -> None:
        if hasattr(hold, "force_release"):  # ClusterHold
            hold.force_release()
        else:  # bare PolicyHold: forced through its owning policy
            hold._policy.force_release(hold)

    def tick(self, open_holds) -> int:
        """Sweep one tick over ``open_holds``; returns #holds expired."""
        self.ticks += 1
        expired = 0
        for h in open_holds:
            if h.released or h.tag in self._exempt:
                continue
            first = self._first_seen.setdefault(h, self.ticks)
            age = self.ticks - first
            if age >= self.warn_after and h not in self._warned:
                self._warned.add(h)
                self.hold_warnings += 1
                self.warnings.append((h.tag, age))
            if age >= self.expire_after:
                self._force(h)
                self.hold_expired_by_watchdog += 1
                expired += 1
        # drop tracking for holds that closed (any path)
        for h in [h for h in self._first_seen if h.released]:
            del self._first_seen[h]
            self._warned.discard(h)
        return expired

    def stats(self) -> Dict[str, Any]:
        return {
            "ticks": self.ticks,
            "warn_after": self.warn_after,
            "expire_after": self.expire_after,
            "hold_warnings": self.hold_warnings,
            "hold_expired_by_watchdog": self.hold_expired_by_watchdog,
            "tracked": len(self._first_seen),
        }


class LifecycleManager:
    def __init__(self, group, *, heartbeat_timeout: int = 4,
                 replay: bool = True,
                 hold_deadline: Optional[int] = None,
                 hold_warn_after: Optional[int] = None) -> None:
        if heartbeat_timeout < 1:
            raise ValueError("heartbeat_timeout must be >= 1 cluster step")
        self.group = group
        self.timeout = heartbeat_timeout
        self.replay_enabled = replay
        self.ticks = 0
        #: replica -> tick of last received heartbeat
        self.last_beat: Dict[int, int] = {}
        #: replica -> last published step counter (must be monotone)
        self.beats: Dict[int, int] = {}
        self._beat_now: Set[int] = set()
        self._watched: Set[int] = set()
        self.dead: Set[int] = set()
        # unreclaimed level when the current silent-pin window opened
        self._silence_baseline: Optional[int] = None
        #: (orig request, replay request, journal entry) triples
        self.replays: List[Tuple[Request, Request, JournalEntry]] = []
        # observability
        self.reclamation_blocked_steps = 0
        self.holds_force_expired = 0
        self.domains_expired = 0
        self.replays_submitted = 0
        self.replays_finished = 0
        #: entries fully served pre-crash (only the finish notification
        #: was lost) — recovered from the journal with NO re-admission
        self.replays_recovered = 0
        self.deaths: List[Tuple[int, int]] = []  # (tick, replica)
        #: optional hold-AGE escalation over the group's cluster ledger
        #: (heartbeats catch a replica that stops stepping; the watchdog
        #: catches one that keeps beating with a wedged hold open)
        self.watchdog: Optional[HoldWatchdog] = (
            None if hold_deadline is None
            else HoldWatchdog(expire_after=hold_deadline,
                              warn_after=hold_warn_after))
        for i in group.live_ids():
            self.watch(i)
        group.lifecycle = self

    # ------------------------------------------------------------------
    # heartbeat plane
    # ------------------------------------------------------------------
    def watch(self, replica: int) -> None:
        """Start monitoring a replica (fresh ones start in good
        standing: a full timeout window before the deadline can fire)."""
        self._watched.add(replica)
        self.last_beat[replica] = self.ticks
        self.beats.setdefault(replica, 0)

    def unwatch(self, replica: int) -> None:
        """Stop monitoring (cooperative drain — retirement, not death)."""
        self._watched.discard(replica)

    def beat(self, replica: int, steps: int) -> None:
        """A replica publishes its monotone step counter.  Called by the
        group's step loop on behalf of every replica that is actually
        running — a crashed replica simply stops calling this."""
        if replica in self.dead:
            return  # late beat from a declared-dead replica: ignored
        if steps < self.beats.get(replica, 0):
            raise ValueError(
                f"replica {replica} heartbeat went backwards "
                f"({self.beats[replica]} -> {steps})"
            )
        self.beats[replica] = steps
        self._beat_now.add(replica)

    def stale(self, replica: int) -> int:
        """Cluster steps since the replica's last heartbeat."""
        return self.ticks - self.last_beat.get(replica, self.ticks)

    def pending(self) -> bool:
        """Business the cluster still owes progress on even when every
        live engine is idle: a silent replica that will be declared dead
        (it has work or holds the survivors wait on), or replays not yet
        finished.  Keeps ``run_until_done`` stepping through the
        heartbeat-timeout window."""
        g = self.group
        for i in self._watched - self.dead:
            eng = g.engines[i]
            if eng.retired:
                continue
            # un-served work on a watched replica always counts — if the
            # replica is live, the group's own has_work already said so;
            # if it went silent, the loop must keep ticking so the
            # deadline can fire at all.  Holds additionally need one
            # observed silent step (stale >= 1): a LIVE owner beats on
            # every step, so without that requirement a cooperatively-
            # managed long-lived hold would keep the loop alive forever.
            if eng.sched.has_work():
                return True
            if self.stale(i) >= 1 and g.ledger.open_holds_of(i):
                return True
        return any(not orig.done for orig, _, _ in self.replays)

    def suspect_holds(self) -> bool:
        """True while any watched, not-yet-dead replica owns an open
        cluster hold.  ``run_until_done`` grants a bounded number of
        grace ticks on this signal, so a replica that crashed while
        IDLE (no work, stale still 0 at loop exit) is still declared
        dead and expired — while a live owner, which beats on every
        grace tick, simply keeps its hold and the loop terminates."""
        g = self.group
        return any(
            bool(g.ledger.open_holds_of(i))
            for i in self._watched - self.dead
            if not g.engines[i].retired
        )

    # ------------------------------------------------------------------
    # the control loop (one tick per cluster step)
    # ------------------------------------------------------------------
    def tick(self) -> None:
        self.ticks += 1
        for i in self._beat_now:
            self.last_beat[i] = self.ticks
        self._beat_now.clear()
        # blocked-reclamation accounting BEFORE the deadline fires: a
        # tick counts iff some silent replica's cluster holds pin pages
        # beyond the level seen when the silence began — evidence the
        # weakness is real (normal in-flight churn, which pins a few
        # pages on every pipelined tick, is baselined out), accrued
        # right up to the expiry tick
        g = self.group
        silent_pins = any(
            self.stale(i) >= 1 and g.ledger.open_holds_of(i)
            for i in self._watched - self.dead
        )
        if silent_pins:
            if self._silence_baseline is None:
                self._silence_baseline = g.shards.unreclaimed()
            if g.shards.unreclaimed() > self._silence_baseline:
                self.reclamation_blocked_steps += 1
        else:
            self._silence_baseline = None
        for i in sorted(self._watched - self.dead):
            if self.stale(i) >= self.timeout:
                self.on_death(i)
        if self.watchdog is not None:
            if self.watchdog.tick(g.ledger.iter_open()):
                g.reclaim()  # expired pins: freed pages land now
        self._stitch()

    # ------------------------------------------------------------------
    # death: shared-fate expiry + replay
    # ------------------------------------------------------------------
    def on_death(self, replica: int) -> None:
        """Deadline missed: declare the replica dead and unblock the
        cluster.  Order matters — holds first (they pin EVERY domain),
        then the dead domain itself, then shard retirement, then replay
        (survivors need the reclaimed pages to admit the replays)."""
        g = self.group
        eng = g.engines[replica]
        self.dead.add(replica)
        self._watched.discard(replica)
        self.deaths.append((self.ticks, replica))
        eng.crashed = True  # it was silent; make the husk un-steppable
        self.holds_force_expired += g.ledger.force_expire_owner(replica)
        eng.force_quiesce()
        self.domains_expired += 1
        g.ledger.remove_domain(eng.pool.policy)
        g.shards.retire_shard(replica)
        eng.retired = True
        eng.free_device_state()  # a dead machine's memory is gone anyway
        g.reclaim()  # survivors' local maintenance: freed pages land now
        if self.replay_enabled:
            self._replay(replica)

    def _replay(self, replica: int) -> None:
        journal = self.group.engines[replica].journal
        if journal is None or not self.group.live_ids():
            return  # nothing recorded, or no survivors to re-admit on
        for e in sorted(journal.open_entries(), key=lambda e: e.rid):
            orig = self._find_request(replica, e.rid)
            if orig is None:
                continue
            if e.remaining() == 0:
                # everything was served before the crash (greedy or
                # sampled — the journal only records host-OBSERVED
                # tokens); only the finish notification was lost
                orig.generated = list(e.emitted)
                orig.done = True
                orig.finished_at = time.time()
                self.replays_recovered += 1
                continue
            if e.resumable:
                # greedy OR sampled-with-journaled-key: the emitted
                # prefix is reproducible anywhere, so teacher-force it
                # and generate only the remainder
                prompt, budget = e.resume_prompt(), e.remaining()
            else:
                prompt, budget = list(e.prompt), e.max_new_tokens
            r = self.group.submit_replay(prompt, budget, e.eos_id,
                                         sample_key=e.sample_key)
            self.replays.append((orig, r, e))
            self.replays_submitted += 1

    def _find_request(self, replica: int, rid: int) -> Optional[Request]:
        """The request a journal entry describes: a client submission
        (group.requests) or an in-flight REPLAY hosted on the dead
        replica (untracked — found via the replay list).  The latter is
        what re-chains a double fault: replaying the replay and
        stitching it completes the original on the next tick."""
        candidates = self.group.requests + [r for _, r, _ in self.replays]
        for req in candidates:
            if req.replica == replica and req.rid == rid and not req.done:
                return req
        return None

    def _stitch(self) -> None:
        """Completed replays finish their original requests: resumable
        streams (greedy, or sampled with a journaled key) stitch as
        emitted + replayed (token-for-token equal to a no-fault run);
        only keyless sampled streams replace wholesale."""
        for orig, r, e in self.replays:
            if orig.done or not r.done:
                continue
            orig.generated = ((list(e.emitted) + list(r.generated))
                              if e.resumable else list(r.generated))
            orig.done = True
            orig.finished_at = r.finished_at
            orig.resumed_on = r.replica  # type: ignore[attr-defined]
            self.replays_finished += 1

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        return {
            "ticks": self.ticks,
            "heartbeat_timeout": self.timeout,
            "watched": sorted(self._watched),
            "dead": sorted(self.dead),
            "deaths": list(self.deaths),
            "reclamation_blocked_steps": self.reclamation_blocked_steps,
            "holds_force_expired": self.holds_force_expired,
            "domains_expired": self.domains_expired,
            "replays_submitted": self.replays_submitted,
            "replays_finished": self.replays_finished,
            "replays_recovered": self.replays_recovered,
            "hold_warnings": (
                0 if self.watchdog is None
                else self.watchdog.hold_warnings),
            "hold_expired_by_watchdog": (
                0 if self.watchdog is None
                else self.watchdog.hold_expired_by_watchdog),
        }
