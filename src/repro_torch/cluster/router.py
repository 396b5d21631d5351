"""Request router: admission strategies over a ReplicaGroup.

A router picks the replica a new request is submitted to.  All three
strategies are deterministic functions of (router state, cluster state,
prompt), so identical request streams route identically — asserted in
tests/test_torch_cluster.py against the JAX package's routers.

  * ``round-robin``     — cyclic, ignores state.  The baseline.
  * ``least-loaded``    — most *effective* free pages in the replica's
    BlockPool shard wins (free minus pages already committed to
    mid-flight chunked prefills and waiting prompts; ties: shallower
    scheduler queue, then lowest replica id).  Balances *memory
    pressure*, which for paged serving is the binding constraint, not
    request count — and a replica mid chunked-prefill reports its TRUE
    load, not the transient free count before its remaining chunks
    allocate.
  * ``prefix-affinity`` — the replica whose PrefixCache holds the
    longest cached run of the prompt's leading blocks wins (ties fall
    through to least-loaded).  Keeps hot shared prefixes local to one
    replica instead of re-prefilling them everywhere, and is what makes
    prefix *migration* (cluster/migration.py) observable: after a move,
    the router follows the pages.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

from ..memory.prefix_cache import prefix_block_keys


class Router:
    """Strategy interface: ``pick`` returns a LIVE replica index.

    Routers only ever see ``group.route_ids()`` — the live replicas, or
    in disaggregated mode the live PREFILL tier (decode replicas never
    admit; they receive work via the mid-request KV handoff).  A crashed
    or retired replica leaves the target set the moment its flag flips,
    which is what makes ``drain_replica``/``add_replica`` re-target
    atomically (no router has partial-membership state to migrate)."""

    name = "abstract"

    def pick(self, group, prompt: Sequence[int]) -> int:
        raise NotImplementedError


class RoundRobinRouter(Router):
    name = "round-robin"

    def __init__(self) -> None:
        self._next = 0

    def pick(self, group, prompt: Sequence[int]) -> int:
        live = group.route_ids()
        r = live[self._next % len(live)]
        self._next += 1
        return r


class LeastLoadedRouter(Router):
    name = "least-loaded"

    def pick(self, group, prompt: Sequence[int]) -> int:
        # max EFFECTIVE free pages (free minus the pages the replica is
        # already committed to: mid-flight chunked prefills allocate
        # incrementally, so raw free counts over-report capacity while a
        # long prompt is only partially admitted); ties -> shallowest
        # queue -> lowest replica id
        return min(
            group.route_ids(),
            key=lambda i: (
                -group.engines[i].effective_free_pages(),
                group.engines[i].sched.queue_depth(),
                i,
            ),
        )


class PrefixAffinityRouter(Router):
    name = "prefix-affinity"

    def __init__(self) -> None:
        self._fallback = LeastLoadedRouter()

    def pick(self, group, prompt: Sequence[int]) -> int:
        live = group.route_ids()
        keys = prefix_block_keys(prompt, group.engines[live[0]].block)
        best_r, best_len = -1, 0
        if keys:
            for i in live:
                n = group.engines[i].prefix_cache.match_len(keys)
                if n > best_len:  # strict: ties keep the earliest replica
                    best_r, best_len = i, n
        if best_r >= 0:
            return best_r
        return self._fallback.pick(group, prompt)


ROUTERS: Dict[str, Callable[[], Router]] = {
    "round-robin": RoundRobinRouter,
    "least-loaded": LeastLoadedRouter,
    "prefix-affinity": PrefixAffinityRouter,
}


def make_router(router) -> Router:
    """Resolve a router name (or pass through an instance)."""
    if isinstance(router, Router):
        return router
    try:
        return ROUTERS[router]()
    except KeyError:
        raise ValueError(
            f"unknown router {router!r}; available: {sorted(ROUTERS)}"
        ) from None
