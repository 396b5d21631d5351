"""ReplicaGroup: N data-parallel ServingEngines as one serving cluster.

The fourth plane of the serving stack (above the policy / device /
scheduler planes): each replica is a full ServingEngine with its own
K/V pools on the card, its own BlockPool **shard** of the cluster's
logical pool and its own reclamation **stamp domain** — a replica is to
the cluster what a thread is to the paper's process.  Every replica runs
on the model's device.  The group composes:

  * a :class:`~repro_torch.cluster.router.Router` that admits requests
    (round-robin / least-loaded-by-free-pages / prefix-affinity) over
    the LIVE replicas;
  * a :class:`~repro_torch.cluster.ledger.ClusterLedger` issuing cross-replica
    holds for actors that span shards (checkpoint writer, prefix
    migration);
  * a per-replica :class:`~repro_torch.cluster.journal.RequestJournal` (the
    replay log the lifecycle plane re-admits a dead replica's requests
    from);
  * aggregate observability: cluster scan-steps/step is the number the
    JAX package's replica-scaling bench tracks — stamp-it stays flat as
    replicas grow because every domain is local and a cluster hold costs
    O(1) per replica.

Membership is dynamic (the lifecycle plane): ``kill_replica`` injects a
crash (the replica goes silent; the attached
:class:`~repro_torch.cluster.lifecycle.LifecycleManager` detects it by missed
heartbeats), ``drain_replica`` cooperatively retires a live replica
(admissions pause, its prefix cache migrates out, its shard retires),
and ``add_replica`` grows a RUNNING group.  Replica ids are stable:
engines are never renumbered, husks stay in ``engines`` with
``crashed``/``retired`` flags and the router only ever picks live ids.

Params are shared: all replicas serve the same model, so ONE param tree
is built, cast once to the compute dtype (``Model.compute_params``), and
passed to every engine, whose own cast then returns the same tensors —
N replicas hold one copy of the weights; the K/V pools stay per
replica.

Disaggregated mode (``prefill_replicas=P, decode_replicas=D``) splits
the replicas into a prefill tier and a decode tier joined by a
:class:`~repro_torch.cluster.tiers.TierManager`: the router admits only to
the prefill tier, chunked prefill parks at completion, and the
request's whole-prompt KV hands off mid-request to a decode replica
under a hold-protected export/import/commit protocol — see tiers.py.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from ..memory.block_pool import ShardedPoolSet
from ..obs.metrics import Registry, apply_aliases
from ..obs.spans import SpanRecorder
from ..serving.engine import ServingEngine
from ..serving.scheduler import ForkGroup, Request
from .journal import RequestJournal
from .ledger import ClusterHold, ClusterLedger
from .router import Router, make_router
from .tiers import TierManager


def _leaves(tree) -> List[Any]:
    """The tensors of a nested-dict param tree, in key order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [tree]


class ReplicaGroup:
    def __init__(
        self,
        model,
        n_replicas: int = 2,
        *,
        policy: str = "stamp-it",
        router: Any = "round-robin",
        max_slots: int = 2,
        max_seq: int = 256,
        pipeline_depth: int = 2,
        prefix_cache_entries: int = 0,
        extra_pages_per_slot: int = 0,
        chunk_tokens: Optional[int] = None,
        seed: int = 0,
        temperature: float = 0.0,
        top_p: float = 1.0,
        sample_seed: int = 0,
        cow: bool = True,
        speculate_k: int = 0,
        draft_layers: Optional[int] = None,
        prefill_replicas: Optional[int] = None,
        decode_replicas: Optional[int] = None,
        prefill_chunk_tokens: Optional[int] = None,
        handoff_import_delay: int = 0,
        registry: Optional[Registry] = None,
    ) -> None:
        # disaggregated mode: replicas 0..P-1 form the prefill tier,
        # P..P+D-1 the decode tier (n_replicas is derived, not taken)
        if (prefill_replicas is None) != (decode_replicas is None):
            raise ValueError(
                "tiered mode needs BOTH prefill_replicas and "
                "decode_replicas (or neither)"
            )
        self._tiered = prefill_replicas is not None
        if self._tiered:
            if prefill_replicas < 1 or decode_replicas < 1:
                raise ValueError("both tiers need at least one replica")
            n_replicas = prefill_replicas + decode_replicas
        if n_replicas < 1:
            raise ValueError("need at least one replica")
        if not isinstance(policy, str):
            # a policy instance binds to ONE pool; replicas each need
            # their own stamp domain, so only names are accepted here
            raise ValueError(
                "ReplicaGroup takes a policy NAME (each replica gets its "
                "own fresh policy instance / stamp domain)"
            )
        self.model = model
        self.policy_name = policy
        # observability plane: ONE registry + span recorder for the
        # whole group — replica-labeled instruments land side by side
        # and a handoff's export/import halves share one trace row
        self.obs = registry if registry is not None else Registry()
        self.spans = SpanRecorder(enabled=self.obs.enabled)
        self.shards = ShardedPoolSet(n_replicas)
        # ONE tree in the compute dtype: each engine's own cast returns
        # these same tensors, so the replicas share the weights' storage
        self._params = model.compute_params(model.init_params(seed))
        self._sample_seed = sample_seed
        # engine kwargs, kept so add_replica() builds IDENTICAL replicas
        self._engine_kw: Dict[str, Any] = dict(
            max_slots=max_slots,
            max_seq=max_seq,
            policy=policy,
            pipeline_depth=pipeline_depth,
            prefix_cache_entries=prefix_cache_entries,
            extra_pages_per_slot=extra_pages_per_slot,
            seed=seed,
            temperature=temperature,
            top_p=top_p,
            cow=cow,
            speculate_k=speculate_k,
            draft_layers=draft_layers,
        )
        # chunked prefill: None = the engine default (chunked, one
        # BLOCK_SIZE chunk per fused step); 0 = legacy whole-prompt
        if chunk_tokens is not None:
            self._engine_kw["chunk_tokens"] = chunk_tokens
        # per-tier chunk size: the prefill tier may run larger chunks
        # than mixed replicas (it never shares a dispatch with decodes)
        self._prefill_chunk_tokens = prefill_chunk_tokens
        if self._tiered:
            resolved = (prefill_chunk_tokens
                        if prefill_chunk_tokens is not None
                        else self._engine_kw.get("chunk_tokens", -1))
            if resolved == 0:
                raise ValueError(
                    "the prefill tier needs chunked prefill (the handoff "
                    "parks at the final chunk); chunk_tokens=0 is the "
                    "legacy whole-prompt path"
                )
        roles = [
            ("prefill" if self._tiered and i < (prefill_replicas or 0)
             else "decode" if self._tiered else "unified")
            for i in range(n_replicas)
        ]
        self.engines: List[ServingEngine] = [
            self._make_engine(i, role=roles[i]) for i in range(n_replicas)
        ]
        self.ledger = ClusterLedger(
            [e.pool.policy for e in self.engines]
        )
        self.tiers: Optional[TierManager] = None
        if self._tiered:
            self.tiers = TierManager(
                self,
                prefill_ids=list(range(prefill_replicas)),
                decode_ids=list(range(prefill_replicas, n_replicas)),
                import_delay=handoff_import_delay,
            )
        self.router: Router = make_router(router)
        self.requests: List[Request] = []
        #: group-level submission counter: sample keys are derived from
        #: it, NOT from routing, so tiered/unified and fault/no-fault
        #: runs over the same request stream sample identically
        self._submits = 0
        #: routing decisions in submit order: [(rid-in-cluster, replica)]
        self.route_trace: List[tuple] = []
        #: lifecycle plane, attached by LifecycleManager(group, ...)
        self.lifecycle = None
        self.steps = 0
        self.checkpoints = 0
        self.replicas_added = 0
        self.replicas_drained = 0

    def _make_engine(self, i: int,
                     role: str = "unified") -> ServingEngine:
        kw = dict(self._engine_kw)
        if role == "prefill" and self._prefill_chunk_tokens is not None:
            kw["chunk_tokens"] = self._prefill_chunk_tokens
        return ServingEngine(
            self.model,
            **kw,
            # decorrelate sampled streams across replicas
            sample_seed=self._sample_seed + i,
            replica_id=i,
            params=self._params,
            shard_set=self.shards,
            journal=RequestJournal(i),
            registry=self.obs,
            spans=self.spans,
            device=self.model.device,
        )

    @property
    def n_replicas(self) -> int:
        return len(self.engines)

    def live_ids(self) -> List[int]:
        """Replicas the router may target and the step loop runs."""
        return [i for i, e in enumerate(self.engines)
                if not (e.crashed or e.retired)]

    def route_ids(self) -> List[int]:
        """Replicas the router ADMITS new requests to: the live prefill
        tier in disaggregated mode (decode replicas never prefill), all
        live replicas otherwise — falling back to all live when the
        prefill tier is entirely down, so requests keep flowing (those
        admissions run unified on their fallback replica)."""
        if self.tiers is None:
            return self.live_ids()
        return self.tiers.live_prefill() or self.live_ids()

    # ------------------------------------------------------------------
    # request plane
    # ------------------------------------------------------------------
    def _next_sample_key(self) -> int:
        key = (self._sample_seed * 1_000_003 + self._submits) & 0x7FFFFFFF
        self._submits += 1
        return key

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16,
               eos_id: Optional[int] = None) -> Request:
        r = self.router.pick(self, prompt)
        req = self.engines[r].submit(prompt, max_new_tokens, eos_id,
                                     sample_key=self._next_sample_key())
        if self.tiers is not None:
            self.tiers.mark(req, r)
        self.route_trace.append((len(self.requests), r))
        self.requests.append(req)
        return req

    def fork_submit(self, prompt: Sequence[int], n: int,
                    max_new_tokens: int = 16,
                    eos_id: Optional[int] = None,
                    suffixes: Optional[Sequence[Sequence[int]]] = None,
                    ) -> ForkGroup:
        """Best-of-N submission: ALL branches route to ONE replica —
        CoW page sharing is an intra-shard mechanism (a branch's block
        table points into the parent's pages of the SAME device pool),
        so a fork group never spans replicas.  The router picks once
        for the whole group; with CoW the group's page charge is ~one
        prompt, which is exactly what ``pending_pages`` reports to the
        least-loaded router."""
        r = self.router.pick(self, prompt)
        group = self.engines[r].fork_submit(
            prompt, n, max_new_tokens, eos_id, suffixes
        )
        for req in group.branches:
            self.route_trace.append((len(self.requests), r))
            self.requests.append(req)
        return group

    def submit_replay(self, prompt: Sequence[int], max_new_tokens: int,
                      eos_id: Optional[int] = None,
                      sample_key: Optional[int] = None) -> Request:
        """Lifecycle-internal admission: routed and journaled like any
        submit, but NOT listed in ``requests``/``route_trace`` — the
        replay's tokens surface on the ORIGINAL request when the
        lifecycle plane stitches, so request- and token-accounting over
        ``group.requests`` counts every served token exactly once.
        ``sample_key`` carries the dead request's journaled RNG state so
        the resumed stream continues bit-identically."""
        r = self.router.pick(self, prompt)
        req = self.engines[r].submit(prompt, max_new_tokens, eos_id,
                                     sample_key=sample_key)
        if self.tiers is not None:
            self.tiers.mark(req, r)
        return req

    def has_work(self) -> bool:
        if any(self.engines[i].sched.has_work() for i in self.live_ids()):
            return True
        # an in-flight handoff packet lives in NO scheduler between
        # export and import — the tier manager must keep ticking
        if self.tiers is not None and self.tiers.pending():
            return True
        # the lifecycle plane may still owe progress (a silent replica
        # inside its heartbeat-timeout window, unfinished replays)
        return self.lifecycle is not None and self.lifecycle.pending()

    def step(self) -> None:
        """One cluster step: every live replica with work advances one
        engine step (data-parallel replicas run independent dispatch
        loops) and publishes its heartbeat; the lifecycle manager then
        ticks (deadline checks, death handling, replay stitching)."""
        self.steps += 1
        for i in self.live_ids():
            eng = self.engines[i]
            if eng.sched.has_work():
                eng.step()
            if self.lifecycle is not None:
                # publication IS the liveness signal: only a replica
                # that is actually running reaches this line — a killed
                # one is skipped by live_ids (crash = silence, exactly
                # what the manager's deadline detects)
                self.lifecycle.beat(i, eng.steps)
        if self.lifecycle is not None:
            self.lifecycle.tick()
        if self.tiers is not None:
            # after lifecycle: a death declared THIS step aborts its
            # packets in the same cluster step (hold already expired)
            self.tiers.tick()

    def run_until_done(self, max_steps: int = 10_000) -> List[Request]:
        start = self.steps  # lifetime counter: bound THIS call's work
        grace = 0
        while True:
            while self.has_work():
                self.step()
                grace = 0
                if self.steps - start > max_steps:  # pragma: no cover
                    raise RuntimeError("cluster did not converge")
            # heartbeat grace window: a replica that crashed while IDLE
            # is invisible to has_work() until the clock advances.  If
            # any watched replica still owns an open hold, tick up to
            # timeout+1 extra steps — a crashed owner goes stale and is
            # declared dead (expiry may enqueue replays, resuming the
            # main loop); a live owner beats every tick and simply
            # keeps its hold, so the window is bounded.
            if (self.lifecycle is None
                    or grace > self.lifecycle.timeout
                    or not self.lifecycle.suspect_holds()):
                break
            self.step()
            grace += 1
            if self.steps - start > max_steps:  # pragma: no cover
                raise RuntimeError("cluster did not converge")
        return [r for r in self.requests if r.done]

    def drain(self) -> None:
        """Teardown: release any still-open cluster holds FIRST — a live
        hold would park retired pages forever and leave ``unreclaimed >
        0`` after the engines drain — then drain every live engine."""
        self.ledger.release_all()
        for i in self.live_ids():
            self.engines[i].drain()
        self.reclaim()

    def reclaim(self) -> None:
        """Best-effort maintenance across all live shards (a few rounds,
        so grace-period policies like native-epoch fully advance)."""
        for _ in range(3):
            for i in self.live_ids():
                self.engines[i].pool.reclaim()

    # ------------------------------------------------------------------
    # lifecycle plane: fault injection, live drain, live scale-up
    # ------------------------------------------------------------------
    def kill_replica(self, i: int) -> None:
        """Fault injection: the replica stops stepping AND stops
        publishing heartbeats, mid-whatever-it-was-doing — in-flight
        requests, open holds and journal state are left exactly as they
        were.  Detection and recovery are entirely the attached
        LifecycleManager's job (missed-deadline path)."""
        eng = self.engines[i]
        if eng.retired:
            raise ValueError(f"replica {i} is already retired")
        eng.crashed = True

    def drain_replica(self, i: int, *, max_steps: int = 10_000) -> Dict[str, int]:
        """Cooperatively retire a LIVE replica from a running group:
        admissions pause (waiting requests re-route to survivors), its
        admitted requests run to completion, its prefix cache migrates
        out under a cluster hold via the standard export/import/evict
        primitives, its stamp domain force-expires and its shard retires
        from the aggregates.  The router re-targets atomically: live_ids
        stops listing the replica the moment it is marked retired."""
        eng = self.engines[i]
        if eng.crashed or eng.retired:
            raise ValueError(f"replica {i} is not live")
        survivors = [j for j in self.live_ids() if j != i]
        if not survivors:
            raise ValueError("cannot drain the last live replica")
        eng.pause_admissions()
        # 1. hand the not-yet-admitted queue back to the router
        requeued = eng.sched.take_waiting()
        # 2. finish what it already admitted (no new admissions); in
        #    tiered mode the tier manager keeps ticking so parked
        #    prefill-done requests hand off to the decode tier and every
        #    packet naming this replica clears before it retires
        n = 0
        while (eng.sched.active or eng.sched.admitting
               or eng.sched.inflight or eng.sched.prefill_done
               or (self.tiers is not None and self.tiers.involves(i))):
            eng.step()
            if self.tiers is not None:
                self.tiers.tick()
            n += 1
            if n > max_steps:  # pragma: no cover
                raise RuntimeError("drain did not converge")
        # 3. migrate its prefix cache out — the standard hold-protected
        #    export/import/evict sequence, on the cache's full key dump
        from .migration import migrate_prefix

        dst = max(survivors,
                  key=lambda j: (self.engines[j].pool.free_pages_total(),
                                 -j))
        keys = eng.prefix_cache.keys()
        migrated = 0
        if keys:
            migrated = migrate_prefix(
                self, None, i, dst, keys=keys, tag="drain-migration",
            )["imported"]
        # 4. retire: domain out of the ledger, shard out of the
        #    aggregates, whatever is still pinned force-expires
        eng.drain()
        self.ledger.remove_domain(eng.pool.policy)
        eng.force_quiesce()
        eng.retired = True
        self.shards.retire_shard(i)
        eng.free_device_state()  # the husk must not hold card memory
        if self.lifecycle is not None:
            self.lifecycle.unwatch(i)
        self.replicas_drained += 1
        # 5. re-route the requeued requests (identity preserved: the
        #    caller's Request handles adopt a survivor's scheduler).
        #    Lifecycle replays are routed but untracked (not in
        #    `requests`), so only tracked requests land in the trace.
        for req in requeued:
            r = self.router.pick(self, req.prompt)
            self.engines[r].adopt(req)
            if self.tiers is not None:
                self.tiers.mark(req, r)  # re-mark for the NEW replica
            if req in self.requests:
                self.route_trace.append((self.requests.index(req), r))
        return {"replica": i, "requeued": len(requeued),
                "prefix_blocks_migrated": migrated, "migrated_to": dst,
                "drain_steps": n}

    def add_replica(self, tier: Optional[str] = None) -> int:
        """Grow a RUNNING group by one replica: fresh shard, fresh stamp
        domain, same shared params.  Returns the new replica id.  The
        router targets it from the next pick; open cluster holds do not
        cover it (they never needed to — see ClusterLedger.add_domain).
        In tiered mode ``tier`` names the tier it joins (default:
        decode — decode capacity is usually the scarce one)."""
        if tier is not None and self.tiers is None:
            raise ValueError("tier= needs a tiered group")
        if self.tiers is not None and tier is None:
            tier = "decode"
        i = self.shards.grow()
        assert i == len(self.engines), "replica ids must stay dense"
        eng = self._make_engine(
            i, role=tier if self.tiers is not None else "unified")
        self.engines.append(eng)
        self.ledger.add_domain(eng.pool.policy)
        if self.tiers is not None:
            self.tiers.register(i, tier)
        if self.lifecycle is not None:
            self.lifecycle.watch(i)
        self.replicas_added += 1
        return i

    def scale_tier(self, tier: str, delta: int) -> List[int]:
        """Re-provision one tier of a RUNNING group: ``delta`` > 0 adds
        fresh replicas to it (live scale-up), ``delta`` < 0 drains its
        highest-id live members one by one (cooperative retirement —
        parked/admitted work hands off or finishes first).  Prefill and
        decode capacity provision independently; a tier never shrinks
        below one live replica.  Returns the affected replica ids."""
        if self.tiers is None:
            raise ValueError("scale_tier needs a tiered group")
        if tier not in ("prefill", "decode"):
            raise ValueError(f"unknown tier {tier!r}")
        changed: List[int] = []
        for _ in range(max(delta, 0)):
            changed.append(self.add_replica(tier=tier))
        for _ in range(max(-delta, 0)):
            ids = (self.tiers.live_prefill() if tier == "prefill"
                   else self.tiers.live_decode())
            if len(ids) <= 1:
                raise ValueError(
                    f"cannot drain the last live {tier} replica"
                )
            i = max(ids)
            self.drain_replica(i)
            changed.append(i)
        return changed

    # ------------------------------------------------------------------
    # cross-replica actors
    # ------------------------------------------------------------------
    def hold(self, tag: str = "cluster-hold",
             owner: Optional[int] = None) -> ClusterHold:
        """Enter every replica's stamp domain (see ClusterLedger).
        ``owner`` names the replica the holding actor runs on — the
        lifecycle plane revokes a dead owner's holds."""
        return self.ledger.hold(tag, owner)

    def checkpoint(self, owner: Optional[int] = None) -> int:
        """Checkpoint writer: snapshot the shared params under a
        cluster-wide hold (the paper's long-lived critical region — the
        writer must see a frozen page set on every replica while it
        reads).  Returns the number of leaves snapshotted."""
        with self.ledger.hold("checkpoint", owner):
            src = self.engines[self.live_ids()[0]]
            leaves = _leaves(src.dev.params)
            for t in leaves:
                # the copy to the host stands in for the write to stable
                # storage
                t.to("cpu")
            n = len(leaves)
        self.checkpoints += 1
        return n

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        live = self.live_ids()
        per = [e.stats() for e in self.engines]
        engine_steps = sum(s["steps"] for s in per)
        scans = sum(
            s["pool_scan_steps"] + s["ledger_scan_steps"] for s in per
        )
        out = apply_aliases({
            "replicas": self.n_replicas,
            "live_replicas": len(live),
            "crashed_replicas": sorted(
                i for i, e in enumerate(self.engines)
                if e.crashed and not e.retired),
            "retired_replicas": sorted(
                i for i, e in enumerate(self.engines) if e.retired),
            "policy": self.policy_name,
            "router": self.router.name,
            "cluster_steps": self.steps,
            "engine_steps": engine_steps,
            "finished": sum(s["finished"] for s in per),
            "scan_steps": scans,
            "scan_steps_per_step": scans / max(engine_steps, 1),
            "unreclaimed": self.shards.unreclaimed(),
            "free_pages": self.shards.free_pages(),
            "pages_total": self.shards.pages_total(),
            "holds_issued": self.ledger.holds_issued,
            "open_holds": self.ledger.open_holds,
            "holds_force_expired": self.ledger.force_expired,
            "checkpoints": self.checkpoints,
            "replicas_added": self.replicas_added,
            "replicas_drained": self.replicas_drained,
            "per_replica": per,
        })
        if self.tiers is not None:
            out["tiers"] = self.tiers.stats()
        if self.lifecycle is not None:
            out["lifecycle"] = self.lifecycle.stats()
        return out

    def metrics(self) -> List[dict]:
        """Cluster-wide registry snapshot: publish every plane's
        counters into the shared registry (engines + pools, cluster
        ledger, tiers, lifecycle, the group itself), then collect.
        Returns the sorted instrument snapshots (see
        the JAX package's docs/observability.md for the catalog)."""
        reg = self.obs
        if not reg.enabled:
            return []
        for e in self.engines:
            e.publish()
        g = reg.gauge
        g("cluster_steps").set(self.steps)
        g("cluster_replicas").set(self.n_replicas)
        g("cluster_live_replicas").set(len(self.live_ids()))
        g("cluster_checkpoints").set(self.checkpoints)
        g("cluster_holds_issued").set(self.ledger.holds_issued)
        g("cluster_holds_open").set(self.ledger.open_holds)
        g("cluster_holds_force_expired").set(self.ledger.force_expired)
        if self.tiers is not None:
            for k, v in self.tiers.stats().items():
                if isinstance(v, (int, float)):
                    g(f"tiers_{k}").set(v)
        if self.lifecycle is not None:
            for k, v in self.lifecycle.stats().items():
                if isinstance(v, (int, float)):
                    g(f"lifecycle_{k}").set(v)
        return reg.collect()
