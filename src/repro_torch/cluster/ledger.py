"""Cluster ledger: cross-replica holds over per-replica stamp domains.

Each replica runs its own reclamation domain (a StampLedger or scheme
instance behind its BlockPool shard) — reclamation work stays local, the
Hyaline-style per-shard design.  Cross-replica actors (checkpoint
writer, prefix-cache migration) need a guarantee that spans shards: *no
page retired anywhere in the cluster while I am active may be
reclaimed*.  The ClusterLedger provides it the way the paper provides
long-lived critical regions: a :class:`ClusterHold` **enters every
replica's stamp domain** (one :class:`~repro_torch.memory.policy.PolicyHold`
per replica), so a page retired on replica A reclaims only once

  1. replica A's own lowest-active stamp passes it (local in-flight
     steps), AND
  2. every cluster hold open at retire time has released.

For stamp-it this costs O(1) per replica to open and close and adds ZERO
scan work while open — which is exactly what the cluster benchmark's
flat scan-steps/step curve measures.  Scheme asymmetry carries over from
the policy plane: region-based schemes pin natively, hazard/LFRC fall
back to buffered retires (they cannot name future pages).

**Shared fate.**  A cluster hold is the cluster-scale version of the
paper's reclamation-blocking weakness: if the actor that opened it
crashes, its parts pin pages in EVERY replica's domain forever.  Holds
therefore carry an ``owner`` (the replica id the actor runs on, or
``None`` for external actors), and the lifecycle plane
(:mod:`repro_torch.cluster.lifecycle`) revokes a dead owner's holds via
:meth:`ClusterLedger.force_expire_owner` — each part force-released
through its policy's native mechanism
(:meth:`~repro_torch.memory.policy.ReclamationPolicy.force_release`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set

from ..memory.policy import PolicyHold, ReclamationPolicy


class ClusterHold:
    """A hold spanning every replica's stamp domain.

    Composite of per-replica :class:`PolicyHold` parts; releasing
    releases all of them (idempotent).  Context-manager friendly — the
    checkpoint writer and migration open holds with ``with`` so an
    exception mid-actor cannot leak a cluster-wide pin.
    """

    __slots__ = ("tag", "owner", "parts", "released", "forced", "_ledger")

    def __init__(self, ledger: "ClusterLedger", parts: List[PolicyHold],
                 tag: str, owner: Optional[int] = None) -> None:
        self.tag = tag
        #: replica id of the actor that opened the hold (None: external)
        self.owner = owner
        self.parts = parts
        self.released = False
        self.forced = False
        self._ledger = ledger

    def release(self) -> None:
        if self.released:
            return
        self.released = True
        for p in self.parts:
            p.release()
        self._ledger._close(self)

    def force_release(self) -> None:
        """Revoke the hold without its owner's cooperation: every part
        expires through its policy's native forced path (stamp
        force-expire / region force-exit / buffered-flush)."""
        if self.released:
            return
        self.released = True
        self.forced = True
        for p in self.parts:
            p._policy.force_release(p)
        self._ledger._close(self, forced=True)

    def __enter__(self) -> "ClusterHold":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class ClusterLedger:
    """Issues cross-replica holds by entering every replica's domain.

    Membership is dynamic: :meth:`remove_domain` (drain / death) stops
    NEW holds from entering a retired replica's domain — holds already
    open keep their parts, which stay releasable (release on a retired
    domain is harmless).  :meth:`add_domain` admits a fresh replica's
    policy (``add_replica`` on a live group).
    """

    def __init__(self, policies: Sequence[ReclamationPolicy]) -> None:
        if not policies:
            raise ValueError("ClusterLedger needs at least one replica")
        self.policies = list(policies)
        self.holds_issued = 0
        self.force_expired = 0
        self._open: Set[ClusterHold] = set()

    @property
    def n_replicas(self) -> int:
        return len(self.policies)

    @property
    def open_holds(self) -> int:
        return len(self._open)

    def hold(self, tag: str = "cluster-hold",
             owner: Optional[int] = None) -> ClusterHold:
        """Open a hold in EVERY replica's stamp domain.

        Open order is replica order and release order matches; holds are
        independent pins (not locks), so no ordering hazard exists —
        a retire on any replica between part-opens is still covered by
        that replica's own part once opened, and pages retired before
        the hold opened were never the hold's to protect.

        ``owner`` names the replica the holding actor runs on; if that
        replica is later declared dead, the lifecycle plane revokes the
        hold (:meth:`force_expire_owner`) — without an owner the hold
        can only be released cooperatively.
        """
        parts = [p.hold(tag) for p in self.policies]
        self.holds_issued += 1
        h = ClusterHold(self, parts, tag, owner)
        self._open.add(h)
        return h

    def _close(self, h: ClusterHold, *, forced: bool = False) -> None:
        self._open.discard(h)
        if forced:
            self.force_expired += 1

    # ------------------------------------------------------------------
    # lifecycle plane
    # ------------------------------------------------------------------
    def open_holds_of(self, owner: Optional[int]) -> List[ClusterHold]:
        return [h for h in self._open if h.owner == owner]

    def iter_open(self) -> List[ClusterHold]:
        """Snapshot of every open hold, any owner — what the lifecycle
        plane's hold-age watchdog sweeps each tick."""
        return list(self._open)

    def force_expire_owner(self, owner: int) -> int:
        """Shared-fate expiry: revoke every open hold owned by a dead
        replica's actors, unblocking reclamation in EVERY domain the
        holds had entered.  Returns the number of holds expired."""
        doomed = self.open_holds_of(owner)
        for h in doomed:
            h.force_release()
        return len(doomed)

    def release_all(self) -> int:
        """Cooperatively release every open hold (group teardown: a live
        hold at drain time would leave ``unreclaimed > 0`` forever)."""
        n = 0
        for h in list(self._open):
            h.release()
            n += 1
        return n

    def remove_domain(self, policy: ReclamationPolicy) -> None:
        """Retire a replica's domain from NEW holds (drain / death)."""
        self.policies = [p for p in self.policies if p is not policy]

    def add_domain(self, policy: ReclamationPolicy) -> None:
        """Admit a fresh replica's domain (live scale-up).  Holds open
        at admission time do not cover it — by the open-order argument
        above they never needed to: pages retired on the new replica
        were allocated after those holds opened, from a shard none of
        their actors can reference."""
        self.policies.append(policy)
