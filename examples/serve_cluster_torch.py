"""Multi-replica serving cluster, end to end, on the PyTorch port: N
data-parallel engines
(each its own BlockPool shard + reclamation stamp domain), a pluggable
request router, a periodic checkpoint writer taking **cross-replica
holds**, a mid-run prefix-cache migration between replicas, and — with
``--kill-replica`` — the lifecycle plane's shared-fate story: replica 0
crashes mid-traffic with a checkpoint hold open, the LifecycleManager
detects the silence by missed heartbeats, force-expires its holds
(unblocking reclamation cluster-wide) and replays its in-flight
requests on the survivors.  Every replica runs on one device: the card
(``--device cuda``, the default: the paged decode, flash prefill and
block-gather CUDA kernels) or the CPU (``--device cpu``: their plain
PyTorch versions).

    PYTHONPATH=src python examples/serve_cluster_torch.py \
        --replicas 2 --policy stamp-it --router prefix-affinity

    PYTHONPATH=src python examples/serve_cluster_torch.py \
        --replicas 2 --kill-replica

Disaggregated mode — a prefill tier and a decode tier with mid-request
KV handoff (the router admits only to the prefill tier; every decode
token is served by the decode tier):

    PYTHONPATH=src python examples/serve_cluster_torch.py \
        --prefill-replicas 1 --decode-replicas 2 \
        --prefill-chunk-tokens 256
"""

import argparse
import time
from collections import deque

import numpy as np

from repro_torch.cluster import (
    ROUTERS, LifecycleManager, ReplicaGroup, migrate_prefix, prefix_keys,
)
from repro_torch.memory import POLICIES
from repro_torch.models import Model
from repro_torch.configs import ARCHS, smoke_config


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--policy", default="stamp-it",
                    choices=sorted(POLICIES))
    ap.add_argument("--router", default="prefix-affinity",
                    choices=sorted(ROUTERS))
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=6)
    ap.add_argument("--checkpoint-every", type=int, default=5,
                    help="cluster steps between checkpoint-writer holds")
    ap.add_argument("--chunk-tokens", type=int, default=128,
                    help="prefill chunk size in tokens, a multiple of "
                         "the 128-token KV page (default: 128 — chunked "
                         "prefill inside every replica's fused step; "
                         "the least-loaded router counts a replica's "
                         "unprefilled remainder as load); 0 = legacy "
                         "whole-prompt prefill dispatch")
    ap.add_argument("--prefill-replicas", type=int, default=0,
                    help="disaggregated mode: replicas in the prefill "
                         "tier (use with --decode-replicas; overrides "
                         "--replicas)")
    ap.add_argument("--decode-replicas", type=int, default=0,
                    help="disaggregated mode: replicas in the decode "
                         "tier")
    ap.add_argument("--prefill-chunk-tokens", type=int, default=0,
                    help="per-tier chunk size: the prefill tier runs "
                         "this chunk size (a multiple of the 128-token "
                         "page) instead of --chunk-tokens; 0 = same as "
                         "--chunk-tokens")
    ap.add_argument("--kill-replica", action="store_true",
                    help="lifecycle demo: crash replica 0 mid-traffic "
                         "while its checkpoint writer holds a cluster "
                         "hold; heartbeat death detection, forced hold "
                         "expiry and request replay take over")
    ap.add_argument("--kill-step", type=int, default=8)
    ap.add_argument("--heartbeat-timeout", type=int, default=3,
                    help="missed cluster steps before a silent replica "
                         "is declared dead")
    ap.add_argument("--no-migration", action="store_true")
    ap.add_argument("--trace-out", default="", metavar="PATH",
                    help="write the run's request-lifecycle spans "
                         "(submit/admit/chunk/first-token/handoff/"
                         "finish) + final metrics snapshot as Chrome-"
                         "trace JSON (load in chrome://tracing or "
                         "Perfetto)")
    ap.add_argument("--device", default="cuda",
                    help="torch device every replica serves on (default: "
                         "cuda, the CUDA kernels; cpu runs their plain "
                         "versions)")
    args = ap.parse_args(argv)
    tiered = bool(args.prefill_replicas or args.decode_replicas)
    if tiered and not (args.prefill_replicas and args.decode_replicas):
        ap.error("disaggregated mode needs BOTH --prefill-replicas "
                 "and --decode-replicas")
    n_replicas = (args.prefill_replicas + args.decode_replicas
                  if tiered else args.replicas)
    if args.kill_replica and n_replicas < 2:
        ap.error("--kill-replica needs >= 2 replicas "
                 "(survivors run the replay)")

    model = Model(smoke_config(ARCHS["qwen2-0.5b"]), device=args.device)
    kw = dict(
        policy=args.policy, router=args.router,
        max_slots=2, max_seq=512, pipeline_depth=2,
        prefix_cache_entries=16, extra_pages_per_slot=4,
        chunk_tokens=args.chunk_tokens,
    )
    if tiered:
        kw.update(
            prefill_replicas=args.prefill_replicas,
            decode_replicas=args.decode_replicas,
            prefill_chunk_tokens=(args.prefill_chunk_tokens or None),
        )
    group = ReplicaGroup(model, args.replicas, **kw)
    lifecycle = LifecycleManager(
        group, heartbeat_timeout=args.heartbeat_timeout)

    from repro_torch.models.transformer import BLOCK_SIZE

    rs = np.random.RandomState(0)
    # two full KV blocks: the prefix the cache/affinity/migration act on
    shared_prefix = list(rs.randint(1, 500, 2 * BLOCK_SIZE).astype(int))
    prompts = []
    for i in range(args.requests):
        if i % 2 == 0:  # half the traffic shares the prefix
            prompts.append(shared_prefix + list(
                rs.randint(1, 500, rs.randint(5, 40)).astype(int)))
        else:
            prompts.append(list(
                rs.randint(1, 500, rs.randint(30, 150)).astype(int)))

    # continuous traffic (one submission per cluster step, so the
    # prefix-affinity router sees caches as they fill) + a periodic
    # checkpoint writer on replica 0 taking cross-replica holds —
    # group.checkpoint() scopes its cluster hold with `with`, so an
    # exception mid-snapshot cannot leak a cluster-wide pin
    t0 = time.perf_counter()
    pending = deque(prompts)
    killed = False
    while pending or group.has_work():
        if pending:
            group.submit(pending.popleft(), max_new_tokens=args.max_new)
        if (group.steps and group.steps % args.checkpoint_every == 0
                and not killed):
            live = group.live_ids()
            group.checkpoint(owner=0 if 0 in live else live[0])
        if (args.kill_replica and not killed
                and group.steps >= args.kill_step):
            # the writer crashes MID-WRITE: its cluster hold is open and
            # nothing will ever release it cooperatively — the exact
            # scenario forced expiry exists for
            group.hold("checkpoint", owner=0)
            group.kill_replica(0)
            killed = True
            print(f"[step {group.steps}] replica 0 killed "
                  f"(checkpoint hold open, requests in flight)")
        group.step()
    dt = time.perf_counter() - t0

    # migrate the shared prefix to the other replica, then replay: the
    # prefix-affinity router must follow the moved pages
    migrated = {}
    live = group.live_ids()
    if not args.no_migration and len(live) > 1:
        keys = prefix_keys(shared_prefix, group.engines[live[0]].block)
        match = {i: group.engines[i].prefix_cache.match_len(keys)
                 for i in live}
        src = max(live, key=lambda i: match[i])
        if match[src]:
            dst = max((i for i in live if i != src),
                      key=lambda i: group.engines[i].pool.free_pages_total())
            migrated = migrate_prefix(group, shared_prefix, src, dst)
            replay = group.submit(list(shared_prefix),
                                  max_new_tokens=args.max_new)
            group.run_until_done()
            migrated.update(src=src, dst=dst, replayed_on=replay.replica)
    group.drain()
    group.reclaim()

    s = group.stats()
    toks = sum(len(r.generated) for r in group.requests if r.done)
    print(f"replicas={s['replicas']} (live {s['live_replicas']})  "
          f"policy={s['policy']}  router={s['router']}  "
          f"requests={sum(r.done for r in group.requests)}  "
          f"generated={toks} tokens in {dt:.2f}s")
    print(f"cluster steps: {s['cluster_steps']}  engine steps: "
          f"{s['engine_steps']}  scan-steps/step: "
          f"{s['scan_steps_per_step']:.3f}")
    print(f"checkpoints: {s['checkpoints']}  holds issued: "
          f"{s['holds_issued']}  unreclaimed after drain: "
          f"{s['unreclaimed']}")
    if tiered:
        ts = s["tiers"]
        print(f"tiers: prefill={ts['prefill_ids']} "
              f"decode={ts['decode_ids']}  handoffs: "
              f"{ts['handoffs_completed']} completed / "
              f"{ts['handoffs_aborted']} aborted  pages handed off: "
              f"{ts['pages_handed_off']}  mean hold window: "
              f"{ts['mean_hold_ticks']:.1f} ticks")
        decode_served = sum(
            s["per_replica"][i]["tokens_emitted"]
            for i in ts["decode_ids"]
            if i < len(s["per_replica"])
        )
        print(f"decode-tier tokens served: {decode_served}")
        if not args.kill_replica:
            assert ts["handoffs_completed"] > 0, (
                "tiered mode must hand off mid-request"
            )
            assert ts["inflight_handoffs"] == 0
    if killed:
        ls = lifecycle.stats()
        print(f"lifecycle: dead={ls['dead']} (deadline at tick "
              f"{ls['deaths'][0][0]})  holds force-expired: "
              f"{ls['holds_force_expired']}  blocked steps: "
              f"{ls['reclamation_blocked_steps']}  replays: "
              f"{ls['replays_finished']}/{ls['replays_submitted']}")
        assert ls["dead"] == [0] and ls["holds_force_expired"] >= 1
        assert all(r.done for r in group.requests), "replay must finish"
    if migrated:
        print(f"migration: {migrated}")
    per_route = {}
    for _, r in group.route_trace:
        per_route[r] = per_route.get(r, 0) + 1
    print(f"routing spread: {dict(sorted(per_route.items()))}")
    if args.trace_out:
        import json

        from repro_torch.obs import chrome_trace, validate_chrome_trace

        group.metrics()  # publish pull-style gauges into the registry
        trace = chrome_trace(group.spans.spans, registry=group.obs)
        n = validate_chrome_trace(trace)
        with open(args.trace_out, "w") as f:
            json.dump(trace, f)
        print(f"trace: {n} events ({len(group.spans.spans)} spans, "
              f"{len(trace.get('metadata', {}).get('metrics', []))} "
              f"metrics) -> {args.trace_out}")
    for r in group.requests[:3]:
        print(f"  req {r.rid}@replica{r.replica}: "
              f"prompt[{len(r.prompt)}] -> {r.generated}")
    assert s["unreclaimed"] == 0, "drain must fully reclaim"
    return group, lifecycle


if __name__ == "__main__":
    main()
