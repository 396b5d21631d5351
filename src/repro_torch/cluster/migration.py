"""Prefix-cache migration: move cached KV pages between replicas.

The second cross-replica actor (after the checkpoint writer), and the
one that exercises every cluster guarantee at once:

  1. a **cluster hold** opens (enters all replica stamp domains);
  2. the source replica's cached blocks are read to host, pinned against
     eviction while reading;
  3. the destination replica allocates pages from ITS shard, installs
     the KV and inserts the keys into ITS prefix cache;
  4. the source evicts its copies — the pages *retire* on the source's
     domain, but the open hold keeps them unreclaimed (a still-running
     source decode step, or the export read itself, may reference
     them);
  5. the hold releases; the source pages reclaim under the source's own
     local rules.

With a prefix-affinity router the move is visible end-to-end: requests
sharing the migrated prefix route to the destination afterwards.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from ..memory.prefix_cache import prefix_block_keys as prefix_keys

__all__ = ["migrate_prefix", "prefix_keys"]


def migrate_prefix(group, prompt, src: int, dst: int, *,
                   keys: Optional[Sequence[tuple]] = None,
                   evict_src: bool = True,
                   tag: str = "migration") -> Dict[str, int]:
    """Move the cached prefix of ``prompt`` from replica ``src`` to
    ``dst`` under a cluster hold.  Returns a report dict; the
    ``src_unreclaimed_during_hold`` field is the mid-flight safety
    evidence tests assert on (evicted pages retired-but-held).

    ``keys`` overrides the prompt-derived key list (``prompt`` may then
    be None) — the drain path passes the source cache's full key dump
    so replica retirement rides this exact hold-protected sequence."""
    if src == dst:
        raise ValueError("source and destination replica are the same")
    src_eng = group.engines[src]
    dst_eng = group.engines[dst]
    if keys is None:
        keys = prefix_keys(prompt, src_eng.block)
    report = {
        "keys": len(keys), "exported": 0, "imported": 0,
        "already_cached": 0, "evicted": 0,
        "src_unreclaimed_during_hold": 0,
    }
    if not keys:
        return report
    with group.ledger.hold(tag):
        blocks = src_eng.export_prefix(keys)
        report["exported"] = len(blocks)
        report["already_cached"] = sum(
            1 for k, _, _ in blocks
            if dst_eng.prefix_cache.get(k) is not None
        )
        report["imported"] = dst_eng.import_prefix(blocks)
        # only drop source copies that ARE now on dst (imported this
        # call or already cached there) — a partial import (dst pool
        # exhausted) must not lose the remainder cluster-wide
        installed = [
            k for k, _, _ in blocks
            if dst_eng.prefix_cache.get(k) is not None
        ]
        if evict_src and installed:
            report["evicted"] = src_eng.evict_prefix(installed)
        # mid-flight: retired on src, pinned by the open cluster hold
        report["src_unreclaimed_during_hold"] = (
            src_eng.pool.unreclaimed()
        )
    group.reclaim()  # post-hold local maintenance on every shard
    return report
