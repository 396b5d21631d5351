"""Cluster plane: multi-replica serving over per-replica stamp domains
(a copy of the JAX package's ``repro/cluster``; every replica runs on
the same card, as the JAX group keeps its replicas on one device).
Composition:

  * :class:`ReplicaGroup`  — N ServingEngine replicas, sharded BlockPool,
    shared params, one router, dynamic membership (group.py);
  * :class:`ClusterLedger` / :class:`ClusterHold` — cross-replica holds
    entering every replica's stamp domain, with owner attribution and
    forced expiry (ledger.py);
  * :class:`LifecycleManager` — heartbeats, shared-fate hold expiry for
    dead replicas, request replay, plus the optional
    :class:`HoldWatchdog` hold-age escalation (lifecycle.py);
  * :class:`RequestJournal` — the per-replica replay log (journal.py);
  * routers — round-robin / least-loaded / prefix-affinity over the
    live replicas (router.py);
  * :func:`migrate_prefix` — hold-protected prefix-cache migration
    (migration.py);
  * :class:`TierManager` — disaggregated prefill/decode tiers with
    hold-protected mid-request KV handoff (tiers.py).
"""

from .group import ReplicaGroup
from .journal import JournalEntry, RequestJournal
from .ledger import ClusterHold, ClusterLedger
from .lifecycle import HoldWatchdog, LifecycleManager
from .migration import migrate_prefix, prefix_keys
from .router import (
    ROUTERS,
    LeastLoadedRouter,
    PrefixAffinityRouter,
    RoundRobinRouter,
    Router,
    make_router,
)
from .tiers import HANDOFF_TAG, HandoffPacket, TierManager

__all__ = [
    "ReplicaGroup", "ClusterLedger", "ClusterHold", "LifecycleManager",
    "HoldWatchdog",
    "RequestJournal", "JournalEntry", "Router",
    "RoundRobinRouter", "LeastLoadedRouter", "PrefixAffinityRouter",
    "ROUTERS", "make_router", "migrate_prefix", "prefix_keys",
    "TierManager", "HandoffPacket", "HANDOFF_TAG",
]
