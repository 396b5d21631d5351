"""Continuous-batching serving engine: a thin composition root over the
three serving planes (the JAX package's ``repro/serving/engine.py``:
chunked or whole-prompt prefill, greedy or sampled, copy-on-write forks
and the speculative lane).

  * **Policy plane** (:mod:`repro_torch.memory.policy`) — the BlockPool is
    written once against :class:`ReclamationPolicy`; every scheme of the
    JAX package's registry (stamp-it, epoch, new-epoch, hazard, interval,
    qsr, debra, lfrc, hyaline, crystalline, scan, refcount,
    stamp-it-core) is selectable via ``ServingEngine(policy=...)``.  The
    policy must never change MODEL OUTPUTS — only pool pressure.
  * **Device plane** (:mod:`repro_torch.serving.device_state`) — all
    decode state lives on the card; one engine step is exactly ONE fused
    step (reset + prefill chunk + admit + teacher-force + device-decided
    page growth + decode + sample), asserted via
    ``stats()["dispatches_per_step"] == 1``.
  * **Scheduler plane** (:mod:`repro_torch.serving.scheduler`) —
    admission, continuous batching, pipeline-lag completion, and the
    deterministic host mirrors that let the pool allocate without ever
    reading device state.

CUDA launches are asynchronous: up to ``pipeline_depth`` steps are in
flight at once, each holding a step handle from the reclamation policy
between dispatch and host-observed completion.  Pages freed by a finished
request (or evicted from the prefix cache) are *retired*, not reused,
until the policy proves no in-flight step can read them.  The host syncs
with the card only where it reads a completed step's tokens.

The engine serves the paged layout: the dense family and the MoE
family without a sliding window (granite-moe-3b-a800m); the rolling,
SSM and hybrid layouts are refused, as in the JAX package, whose engine
serves no encoder-decoder either.  A MoE chunk's expert capacity is
worked out from the chunk's (or the whole-prompt bucket's) length, a
decode step's from one token per slot, so prefill may drop (token,
expert) pairs and decode never does.

Sampled decoding: each request carries a ``sample_key`` and the u that
samples its token at sequence index ``pos`` is ``counter_uniform(key,
pos)``, bit-identical to the JAX package's.  Copy-on-write forks
(``fork_submit``): N branches share one prompt's pages by fork
references; each secondary branch copies only the partial last prompt
page (``DeviceState.copy_pages``, the block-gather kernel) and
``select_winner`` retires the losers.

``chunk_tokens=0`` admits each prompt by one whole-prompt prefill
dispatch (bucketed to a power of two of pages).  ``speculate_k = k > 0``
(greedy only) drafts k tokens with the first ``draft_layers`` layers and
verifies them with the whole model inside the same fused step; the host
reads each slot's accepted count back before the next step.

Cluster plane (:mod:`repro_torch.cluster`): an engine is one replica of
a ``ReplicaGroup`` — ``replica_id`` names it, its ``BlockPool`` is that
replica's shard of the group's ``ShardedPoolSet`` and its policy that
replica's stamp domain, which a ``ClusterHold`` enters.  The ``journal``
(any object with ``record_submit`` / ``record_token`` /
``record_finish``) records every host-observed token so a dead replica's
requests replay elsewhere; ``crashed`` makes ``step()`` refuse to run
and ``retired`` marks a drained or dead husk, whose pools
``free_device_state`` releases.  Prefix migration reads cached pages to
the host (``export_prefix``, through the block-gather kernel) and
installs them in another replica (``import_prefix``).  A request marked
``handoff`` (the prefill tier of a disaggregated group) parks after its
final prefill chunk instead of decoding; ``export_request`` emits its
token 1, reads its whole-prompt K/V to the host and frees its pages, and
``import_request`` on a decode replica installs them and admits it
straight into the decode lane.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..configs.base import ShapeConfig
from ..device import DeviceLike, resolve_device
from ..memory.block_pool import BlockPool, PoolExhausted, ShardedPoolSet
from ..memory.prefix_cache import PrefixCache, block_key, prefix_block_keys
from ..models import Model
from ..models.transformer import BLOCK_SIZE, cache_layout
from ..obs.metrics import Registry, apply_aliases
from ..obs.spans import SpanRecorder
from .device_state import DeviceState
from .scheduler import ForkGroup, Request, Scheduler


def _pow2_bucket(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << (n - 1).bit_length()


class ServingEngine:
    def __init__(
        self,
        model: Model,
        *,
        max_slots: int = 4,
        max_seq: int = 256,
        policy: Any = "stamp-it",
        pipeline_depth: int = 2,
        prefix_cache_entries: int = 0,
        extra_pages_per_slot: int = 0,
        chunk_tokens: int = BLOCK_SIZE,
        seed: int = 0,
        temperature: float = 0.0,
        top_p: float = 1.0,
        sample_seed: int = 0,
        replica_id: int = 0,
        params: Any = None,
        shard_set: Optional[ShardedPoolSet] = None,
        journal: Any = None,
        cow: bool = True,
        speculate_k: int = 0,
        draft_layers: Optional[int] = None,
        registry: Optional[Registry] = None,
        spans: Optional[SpanRecorder] = None,
        device: DeviceLike = "cuda",
        impl: Optional[str] = None,
    ) -> None:
        cfg = model.cfg
        if cache_layout(cfg) != "paged":
            raise ValueError("the engine drives paged-layout archs")
        dev = resolve_device(device)
        if dev != model.device:
            raise ValueError(f"engine device {dev} != model device "
                             f"{model.device}")
        # chunked prefill (the default): prompts are admitted one fixed
        # `chunk_tokens` slice per fused step.  0 selects whole-prompt
        # prefill: its own dispatch per admission, bucketed to a power of
        # two of pages.
        if chunk_tokens < 0 or chunk_tokens % BLOCK_SIZE:
            raise ValueError(
                "chunk_tokens must be 0 (whole-prompt prefill) or a "
                f"positive multiple of BLOCK_SIZE ({BLOCK_SIZE})")
        # speculative lane: greedy only — acceptance compares argmaxes,
        # and the verifier's argmax chain is the non-speculative chain
        if speculate_k and temperature != 0.0:
            raise ValueError("the speculative lane verifies greedy argmax "
                             "chains; sampling would need rejection "
                             "resampling")
        self.model = model
        self.cfg = cfg
        self.device = dev
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.block = BLOCK_SIZE
        self.mb = -(-max_seq // BLOCK_SIZE) + 1
        self.pipeline_depth = pipeline_depth
        self.chunk_tokens = chunk_tokens
        # cluster plane: which replica this engine is; its pool is that
        # replica's shard of the group's logical pool
        self.replica_id = replica_id
        self.temperature = temperature
        self.top_p = top_p
        # sampled mode: requests carry a per-request sample_key and the
        # device derives every uniform as counter_uniform(key, position);
        # sample_seed salts the DEFAULT key of requests submitted without
        # one
        self.sample_seed = sample_seed
        # lifecycle plane: replay journal (duck-typed: the engine never
        # imports the cluster plane), fault-injection and drain state
        self.journal = journal
        self.crashed = False  # fault injection: step() refuses to run
        self.retired = False  # drained out of a live group
        # copy-on-write fork plane: cow=False is the equality baseline
        # (fork branches re-prefill the whole prompt independently)
        self.cow = cow
        self.speculate_k = speculate_k
        self.draft_layers = (draft_layers if draft_layers is not None
                             else max(cfg.num_layers // 2, 1))

        shape = ShapeConfig("engine", "decode", max_seq, max_slots)
        if params is None:
            # replicas of a group share ONE param tree (the group passes
            # it in); a standalone engine builds its own
            params = model.init_params(seed)
        # the steps read weights in the compute dtype: cast once here (a
        # tree already in that dtype comes back as the same tensors)
        params = model.compute_params(params)
        cache = model.init_cache(shape, pool_slack=extra_pages_per_slot)

        # page 0 of each slot is the scratch page: inactive slots keep a
        # zeroed block-table row, so their (discarded) decode writes land
        # in page 0 instead of corrupting allocated pages.  The host pool
        # is sized from the DEVICE pool dim (cache_specs rounds pages up
        # to a TP_WIDTH multiple, as the JAX package does).
        pool_pages = int(cache["layers"]["k_pool"].shape[2])
        self.pool = BlockPool(max_slots, pool_pages, policy=policy,
                              shard_id=replica_id, shard_set=shard_set,
                              registry=registry)
        self.obs = self.pool.trace.registry
        self.spans = (spans if spans is not None
                      else SpanRecorder(enabled=self.obs.enabled))
        for s in range(max_slots):
            got = self.pool.alloc(s, 1)
            if got != [0]:
                raise RuntimeError("page 0 must be the scratch page")
        self.prefix_cache = PrefixCache(self.pool, prefix_cache_entries)

        self.sched = Scheduler(max_slots, self.mb, self.block,
                               pipeline_depth, replica_id=replica_id,
                               n_pool=pool_pages)
        self.dev = DeviceState(
            model, params, cache, max_slots=max_slots, mb=self.mb,
            block=self.block, chunk_tokens=chunk_tokens,
            temperature=temperature, top_p=top_p, speculate_k=speculate_k,
            draft_layers=self.draft_layers, impl=impl,
        )

        # page-ref cache: rebuilt only when the active page set changes
        self._page_refs: List[tuple] = []
        self._refs_dirty = True

        self.steps = 0
        self.decode_steps = 0  # engine steps that dispatched device work
        self.admissions = 0  # requests admitted
        self.prefill_chunks = 0  # chunk-lane rides
        self.host_ns = 0  # host-side bookkeeping time in _dispatch_decode
        self.busy_s = 0.0  # cumulative step() wall time
        self.backpressure_syncs = 0  # PoolExhausted -> force-sync events
        self.chunk_backpressure = 0  # ... of which mid chunked prefill
        # chunk-lane per-step state (consumed by _dispatch_decode)
        self._chunk_rr = 0  # round-robin pointer over admitting slots
        self._chunk_need_pages = 0  # staged chunk's KV-sweep page bound
        self._chunk_finalizing: Optional[Request] = None
        # CoW fork + speculative-lane counters
        self._next_group_id = 0
        self.cow_copies = 0  # partial prompt pages CoW-copied
        self.fork_admissions = 0  # branches admitted by page sharing
        # tier plane: mid-request KV handoffs (prefill -> decode tier)
        self.handoffs_out = 0  # requests exported after prefill here
        self.handoffs_in = 0  # requests imported mid-request
        self.tokens_emitted = 0  # host-observed generated tokens
        self.spec_drafted = 0  # draft tokens offered to the verifier
        self.spec_accepted = 0  # ... accepted (bonus tokens beyond 1)

    # ------------------------------------------------------------------
    # scheduler-plane views
    # ------------------------------------------------------------------
    @property
    def waiting(self):
        return self.sched.waiting

    @property
    def active(self):
        return self.sched.active

    @property
    def finished(self):
        return self.sched.finished

    @property
    def free_slots(self):
        return self.sched.free_slots

    @property
    def _inflight(self):
        return self.sched.inflight

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16,
               eos_id: Optional[int] = None,
               sample_key: Optional[int] = None) -> Request:
        if sample_key is None:
            # deterministic per-request default key, as the JAX engine's
            sample_key = ((self.sample_seed * 1_000_003
                           + self.sched._next_rid) & 0x7FFFFFFF)
        req = self.sched.submit(prompt, max_new_tokens, eos_id,
                                sample_key=sample_key)
        if self.spans.enabled:
            self.spans.begin(self._srid(req), "queue", step=self.steps,
                             replica=self.replica_id,
                             prompt_len=len(req.prompt))
        if self.journal is not None:
            self.journal.record_submit(req, self.temperature, self.top_p)
        return req

    def fork_submit(self, prompt: Sequence[int], n: int,
                    max_new_tokens: int = 16,
                    eos_id: Optional[int] = None,
                    suffixes: Optional[Sequence[Sequence[int]]] = None,
                    ) -> ForkGroup:
        """Submit N branches sharing one prompt prefix.

        With ``cow=True`` (default) branch 0 prefills the prefix ONCE;
        the other branches admit by taking fork references on its pages
        and copying only the partial last prompt page.  ``suffixes``
        optionally extends branch i's prompt with its own teacher-forced
        continuation; without them the branches diverge from the
        primary's first sampled token.  With ``cow=False`` every branch
        is an independent full submit — the token-equality baseline."""
        if n < 1:
            raise ValueError("need at least one branch")
        base = list(map(int, prompt))
        sfx = ([list(map(int, x)) for x in suffixes]
               if suffixes is not None else None)
        if sfx is not None and len(sfx) != n:
            raise ValueError("need one suffix per branch")
        group = ForkGroup(self._next_group_id, len(base), n, sfx)
        self._next_group_id += 1
        for i in range(n):
            branch_prompt = base + (sfx[i] if sfx is not None else [])
            req = self.submit(branch_prompt, max_new_tokens, eos_id)
            if self.cow:
                req.group = group
                req.branch_idx = i
            group.branches.append(req)
        return group

    def select_winner(self, group: ForkGroup, winner_idx: int) -> Request:
        """Best-of-N resolution: keep one branch, kill the rest.  Each
        loser's private pages retire as ONE policy batch (one stamped
        event for stamp-it) and its fork references on the shared prefix
        release — the prefix itself reclaims only when the LAST branch
        (winner included) lets go."""
        primary = group.branches[0]
        if winner_idx != 0 and primary.group is group and not group.ready:
            raise RuntimeError(
                "select_winner before the primary's prefix is on the card "
                "would strand the surviving branches")
        group.winner = winner_idx
        led = self.pool.ledger
        if led is not None:
            led.note_event("branch-kill")
        for i, req in enumerate(group.branches):
            if i != winner_idx:
                self._kill_branch(req)
        return group.branches[winner_idx]

    def _kill_branch(self, req: Request) -> None:
        if req.done:
            return
        req.done = True
        req.finished_at = time.time()
        if self.spans.enabled:
            srid = self._srid(req)
            self.spans.end_open(srid, step=self.steps)
            self.spans.event(srid, "branch-kill", step=self.steps,
                             replica=self.replica_id)
        if req.slot >= 0 and self.sched.active.get(req.slot) is req:
            slot = req.slot
            if self.journal is not None:
                self.journal.record_finish(req)
            self.sched.finished.append(req)
            own, foreign = self._split_refs(
                req, self.sched.release_slot(slot))
            if own:  # loser's private pages: one retire_many batch
                self.pool.free_refs(own)
            if foreign:
                self.pool.release_fork(foreign)
            self._refs_dirty = True
            self.dev.stage_reset(slot)
        elif req in self.sched.waiting:
            # never admitted: give back its pre-taken fork references
            self.sched.waiting.remove(req)
            self.sched.finished.append(req)
            refs = list(getattr(req, "_fork_shared", []))
            partial = getattr(req, "_fork_partial", None)
            if partial is not None:
                refs.append(partial)
                req._fork_partial = None  # type: ignore[attr-defined]
            if refs:
                self.pool.release_fork(refs)

    def _srid(self, req: Request) -> str:
        """Stable span identity: survives the rid reassignment a tier
        handoff performs on import (set once at first submit)."""
        srid = getattr(req, "_span_rid", None)
        if srid is None:
            srid = f"r{self.replica_id}.{req.rid}"
            req._span_rid = srid  # type: ignore[attr-defined]
        return srid

    def _span_admit(self, req: Request) -> None:
        """Close the queue phase, open prefill (all admission paths)."""
        if not self.spans.enabled:
            return
        srid = self._srid(req)
        self.spans.end(srid, "queue", step=self.steps)
        self.spans.begin(srid, "prefill", step=self.steps,
                         replica=self.replica_id)

    def effective_free_pages(self) -> int:
        """Chunk-aware router load signal: free pages minus the pages
        this engine is already committed to allocating (the unprefilled
        remainder of mid-flight chunked admissions and waiting prompts),
        so a replica mid-prefill reports its TRUE load."""
        return (self.pool.free_pages_total()
                - self.sched.pending_prefill_pages())

    def run_until_done(self, max_steps: int = 10_000) -> List[Request]:
        start = self.steps
        while self.sched.has_work():
            self.step()
            if self.steps - start > max_steps:
                raise RuntimeError("engine did not converge")
        return self.sched.finished

    def step(self) -> None:
        if self.crashed:
            raise RuntimeError(
                f"replica {self.replica_id} is crashed (fault injection)")
        self.steps += 1
        _t0 = time.time()
        # 1. retire the oldest in-flight step if the pipeline is full
        while self.sched.pipeline_full():
            self._complete_oldest()
        # 2. admissions (chunked admissions only OCCUPY a slot here; their
        #    prompt tokens ride the fused step one chunk at a time; a
        #    draining replica pauses here and only finishes what it has)
        while (not self.sched.admissions_paused and self.sched.waiting
               and self.sched.free_slots):
            if not self._admit(self.sched.waiting[0]):
                break
            self.sched.waiting.popleft()
        # 3. advance at most one prefill chunk (round-robin over the
        #    admitting slots — the interleaving policy)
        chunk_staged = bool(self.sched.admitting) and self._advance_chunk()
        # 4. one fused step for decode work and/or the staged chunk
        if self.sched.active or chunk_staged:
            self._dispatch_decode()
        elif self.sched.inflight:
            self._complete_oldest()
        self.busy_s += time.time() - _t0

    def drain(self) -> None:
        while self.sched.inflight:
            self._complete_oldest()
        self.prefix_cache.drain()
        self.pool.reclaim()

    # ------------------------------------------------------------------
    # cluster-plane hooks (replica membership, migration, holds)
    # ------------------------------------------------------------------
    def hold(self, tag: str = "hold"):
        """Pin this replica's stamp domain (see ReclamationPolicy.hold);
        the ClusterLedger composes one of these per replica."""
        return self.pool.hold(tag)

    def adopt(self, req: Request) -> Request:
        """Cluster requeue path (drain): take over a request another
        replica accepted but never admitted."""
        self.sched.adopt(req)
        if self.journal is not None:
            self.journal.record_submit(req, self.temperature, self.top_p)
        return req

    def pause_admissions(self) -> None:
        """Live drain, phase 1: stop admitting; requests already in a
        slot (active or mid chunked prefill) run to completion."""
        self.sched.admissions_paused = True

    def force_quiesce(self) -> dict:
        """Dead-replica reaping: abandon the in-flight pipeline (nothing
        will ever complete it) and force-expire every hold and step
        handle in this replica's stamp domain, so the pages it pinned —
        its own and, through cluster holds, other replicas' — can
        reclaim.  The engine survives as a husk and is never stepped
        again."""
        self.sched.inflight.clear()
        return self.pool.force_quiesce()

    def free_device_state(self) -> None:
        """Retired-husk memory release: drop this replica's K/V pools so
        a drained or dead engine does not hold card memory for the life
        of the group.  The params are SHARED with live replicas and stay;
        ``stats()`` keeps working off counters.  The husk must never be
        stepped again."""
        self.dev.cache = None

    def export_prefix(self, keys: Sequence[tuple]) -> List[tuple]:
        """Migration source: read the cached K/V pages of the leading run
        of ``keys`` to the host, pinned against eviction while reading.
        Returns [(key, k, v), ...]; the caller must hold a cluster hold so
        the pages cannot be reclaimed between export and eviction."""
        entries = self.prefix_cache.acquire(keys)
        blocks = []
        try:
            for key, e in zip(keys, entries):
                k, v = self.dev.read_pages(e.slot, [e.page])
                blocks.append((key, k, v))
        finally:
            self.prefix_cache.unpin(entries)
        return blocks

    def import_prefix(self, blocks: Sequence[tuple]) -> int:
        """Migration destination: install exported K/V pages into this
        replica's pool and prefix cache.  Returns the number imported
        (stops early on pool exhaustion; cached keys are skipped)."""
        n = 0
        for key, k, v in blocks:
            if self.prefix_cache.get(key) is not None:
                continue
            slot = max(range(self.max_slots),
                       key=self.pool.free_slot_pages)
            try:
                (page,) = self.pool.alloc(slot, 1)
            except PoolExhausted:
                break
            self.dev.write_pages(slot, [page], k, v)
            if self.prefix_cache.insert(key, slot, page):
                n += 1
            else:  # cache full of pinned entries: give the page back
                self.pool.free(slot, [page])
        return n

    def evict_prefix(self, keys: Sequence[tuple]) -> int:
        """Migration source, after a successful import: drop the moved
        entries (their pages RETIRE through the policy — under an open
        cluster hold they stay unreclaimed until it releases)."""
        return self.prefix_cache.remove(keys)

    def export_request(self, slot: int) -> Optional[dict]:
        """Tier plane, source side of the mid-request K/V handoff: read a
        parked prefill-done request's whole-prompt K/V to the host and
        free its pages HERE.  The caller holds a ClusterLedger hold owned
        by this replica for the whole export -> import window: the pages
        retire now but stay pinned (retire-but-held) until the hold
        releases after import — the paper's long-lived critical region
        at handoff granularity.

        Token 1 (sampled on the card by the final prefill chunk) is
        emitted here, on the SOURCE, so a replay after a source death
        mid-handoff resumes from prompt + [token 1].  A request whose
        budget or eos is met by token 1 alone finishes here and is not
        handed off (returns None)."""
        sched = self.sched
        req = sched.prefill_done[slot]
        first_dev = req._first_dev  # type: ignore[attr-defined]
        if first_dev is None:
            raise RuntimeError("export before the final chunk's step")
        t1 = int(first_dev.item())
        req._first_dev = None  # type: ignore[attr-defined]
        self._emit(req, t1)
        hit_eos = req.eos_id is not None and t1 == req.eos_id
        if hit_eos or req.max_new_tokens <= 1:
            self._finish(slot, req)
            return None
        refs = sched.slot_pages[slot]
        if any(r[0] != slot for r in refs):
            raise RuntimeError("a handoff request never shares CoW pages")
        pages = [p for (_, p) in refs]
        k, v = self.dev.read_pages(slot, pages)
        freed = sched.release_slot(slot)
        self.pool.free_refs(freed)
        self._refs_dirty = True
        self.dev.stage_reset(slot)
        self.handoffs_out += 1
        if self.spans.enabled:
            # close the decode sliver _emit opened for token 1; the tier
            # plane opens the handoff phase around this export
            self.spans.end(self._srid(req), "decode", step=self.steps)
        return {
            "req": req,
            "prompt_len": len(req.prompt),
            "token1": t1,
            "k": k,
            "v": v,
            "n_pages": len(pages),
            "src": self.replica_id,
        }

    def import_request(self, packet: dict) -> bool:
        """Tier plane, destination side: install an exported request's
        K/V into this replica's pool and admit it straight into the
        decode lane (the staged admit sets lengths = prompt_len and
        teacher-forces token 1, so the next fused step decodes token 2).
        The request continues under a fresh LOCAL rid and a NEW journal
        entry carrying its emitted tokens — the adopt() requeue
        bookkeeping, which makes a death mid-handoff replay cleanly.
        Returns False (the caller retries or re-routes) when this replica
        has no free slot or pages."""
        sched = self.sched
        if not sched.free_slots or sched.admissions_paused:
            return False
        req: Request = packet["req"]
        slot = sched.free_slots[-1]
        try:
            pages = self.pool.alloc(slot, packet["n_pages"])
        except PoolExhausted:
            return False
        self.dev.write_pages(slot, pages, packet["k"], packet["v"])
        req.rid = sched._next_rid
        sched._next_rid += 1
        req.replica = self.replica_id
        gen = list(req.generated or [])  # bind_slot resets generated
        sched.bind_slot(req, slot, pages, packet["prompt_len"])
        req.generated = gen
        req._tf_suffix = []  # type: ignore[attr-defined]
        req._first_dev = None  # type: ignore[attr-defined]
        self._refs_dirty = True
        self.dev.stage_admit(slot, packet["prompt_len"],
                             sched.block_table[slot], packet["n_pages"],
                             token=packet["token1"], set_token=True,
                             seed=int(req.sample_key or 0))
        if self.journal is not None:
            # record_submit journals the already-emitted prefix (token 1
            # and any tokens served before a re-import), so a death here
            # later replays from prompt + emitted like any other request
            self.journal.record_submit(req, self.temperature, self.top_p)
        self.admissions += 1
        self.handoffs_in += 1
        if self.spans.enabled:
            self.spans.begin(self._srid(req), "decode", step=self.steps,
                             replica=self.replica_id, imported=True)
        return True

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def _admit(self, req: Request) -> bool:
        if req.is_fork_secondary:
            return self._admit_fork_secondary(req)
        slot = self.sched.free_slots[-1]
        prompt = req.prompt
        n_blocks = max(-(-len(prompt) // self.block), 1)
        # prefix-cache lookup over full prompt blocks
        keys = prefix_block_keys(prompt, self.block)
        hits = self.prefix_cache.lookup(keys) if keys else []

        # keep at least the final prompt token out of the "hit" span so a
        # fully-cached prompt still runs one forced step to emit token 1
        n_hit_tokens = min(len(hits) * self.block, len(prompt) - 1)
        suffix = prompt[n_hit_tokens:]
        # replay only pays off for short suffixes; a long one takes the
        # chunked prefill, which rewrites EVERY page.  Handoff requests
        # must finish prefill in the chunk lane (the tier plane parks
        # them at the final chunk), so they skip the replay path
        if (n_hit_tokens and len(suffix) <= 2 * self.block
                and not req.handoff):
            # short suffix after a cache hit: teacher-force through decode
            try:
                pages = self.pool.alloc(slot, n_blocks)
            except PoolExhausted:
                self.prefix_cache.unpin(hits)
                return False
            self.dev.copy_pages(
                [e.slot for e in hits], [e.page for e in hits],
                slot, pages[: len(hits)],
            )
            self.prefix_cache.unpin(hits)
            self._refs_dirty = True
            req._first_dev = None  # type: ignore[attr-defined]
            self.sched.bind_slot(req, slot, pages, n_hit_tokens)
            req._tf_suffix = list(suffix)  # type: ignore[attr-defined]
            self.dev.stage_admit(slot, n_hit_tokens,
                                 self.sched.block_table[slot], n_blocks,
                                 seed=int(req.sample_key or 0))
            self.admissions += 1
            self._span_admit(req)
            return True
        self.prefix_cache.unpin(hits)

        if self.chunk_tokens:
            # chunked admission: occupy the slot now; pages are allocated
            # incrementally and the prompt rides the fused step one chunk
            # per step (_advance_chunk).  The chunk hold is the paper's
            # long-lived critical region at admission granularity: pages
            # retired anywhere in the domain while this prefill is
            # mid-flight stay unreclaimed until it completes.
            self.sched.bind_admitting(req, slot)
            req._chunk_hold = self.pool.hold(  # type: ignore[attr-defined]
                "chunk-prefill")
            req._first_dev = None  # type: ignore[attr-defined]
            req._tf_suffix = []  # type: ignore[attr-defined]
            self.admissions += 1
            self._span_admit(req)
            return True

        # whole-prompt prefill, bucketed to a power-of-two block count so
        # the prompt shapes stay O(log(max_seq / block)).  Forward pass,
        # first-token sample and the K/V scatter into this slot's pages
        # are ONE (extra) dispatch per admission.
        try:
            pages = self.pool.alloc(slot, n_blocks)
        except PoolExhausted:
            return False
        self._refs_dirty = True
        S = _pow2_bucket(n_blocks) * self.block
        toks = np.asarray(prompt + [0] * (S - len(prompt)), np.int32)[None]
        # token 1 stays on the card (in first_buf, which the fused step
        # reads); the host reads it at the request's first pipeline-lagged
        # completion
        req._first_dev = self.dev.prefill(  # type: ignore[attr-defined]
            toks, len(prompt) - 1, slot, n_blocks, pages,
            seed=int(req.sample_key or 0))
        self.sched.bind_slot(req, slot, pages, len(prompt))
        req._tf_suffix = []  # type: ignore[attr-defined]
        self.dev.stage_admit(slot, len(prompt),
                             self.sched.block_table[slot], n_blocks,
                             token_from_buf=True, set_token=True,
                             seed=int(req.sample_key or 0))
        self.admissions += 1
        self._span_admit(req)
        return True

    # ------------------------------------------------------------------
    # copy-on-write fork admission
    # ------------------------------------------------------------------
    def _record_fork_parent(self, req: Request, group: ForkGroup) -> None:
        """The primary's full prefix KV is enqueued on the card: record
        the shareable refs and take each un-admitted branch's fork
        references NOW, so the prefix outlives the primary even if it
        finishes before its siblings admit.  One ``fork_refs`` batch =
        one stamped event for stamp-it."""
        refs = self.sched.slot_pages[req.slot]
        full = group.prefix_len // self.block
        group.shared_refs = list(refs[:full])
        group.partial_ref = (refs[full] if group.prefix_len % self.block
                             else None)
        take = list(group.shared_refs)
        if group.partial_ref is not None:
            take.append(group.partial_ref)
        n_pending = 0
        for b in group.branches[1:]:
            if b.done:
                continue
            b._fork_shared = list(  # type: ignore[attr-defined]
                group.shared_refs)
            b._fork_partial = group.partial_ref  # type: ignore
            n_pending += 1
        if take and n_pending:
            self.pool.fork_refs(take * n_pending)
        group.ready = True

    def _admit_fork_secondary(self, req: Request) -> bool:
        g = req.group
        if not g.ready:
            return False  # primary's prefix KV not yet on the card
        sfx = (g.suffixes[req.branch_idx]
               if g.suffixes is not None else None)
        if not sfx and g.first_token is None:
            return False  # branch point is the primary's first sample
        slot = self.sched.free_slots[-1]
        refs = list(g.shared_refs)
        partial = getattr(req, "_fork_partial", None)
        if partial is not None:
            # the actual copy-on-write: this branch's own copy of the
            # PARTIAL last prompt page (its decode writes land there);
            # the full prefix pages stay shared read-only
            try:
                (own,) = self.pool.alloc(slot, 1)
            except PoolExhausted:
                return False
            self.dev.copy_pages([partial[0]], [partial[1]], slot, [own])
            self.cow_copies += 1
            refs.append((slot, own))
            # the copy is enqueued on the stream every later step runs
            # on, so it reads the parent page before any later recycler
            # can rewrite it: the PARTIAL-page fork reference drops here
            # (the full-prefix refs hold until this branch finishes)
            self.pool.release_fork([partial])
            req._fork_partial = None  # type: ignore[attr-defined]
        self._refs_dirty = True
        req._first_dev = None  # type: ignore[attr-defined]
        self.sched.bind_slot_refs(req, slot, refs, g.prefix_len)
        if sfx:
            # the whole suffix rides the teacher-forcing lane (replay
            # pattern): the tf override of the admit step consumes
            # sfx[0], later steps the rest
            req._tf_suffix = list(sfx)  # type: ignore[attr-defined]
            self.dev.stage_admit(slot, g.prefix_len,
                                 self.sched.block_table[slot], len(refs),
                                 seed=int(req.sample_key or 0))
        else:
            tok = g.first_token
            req._tf_suffix = []  # type: ignore[attr-defined]
            self.dev.stage_admit(slot, g.prefix_len,
                                 self.sched.block_table[slot], len(refs),
                                 token=tok, set_token=True,
                                 seed=int(req.sample_key or 0))
        self.admissions += 1
        self.fork_admissions += 1
        self._span_admit(req)
        if not sfx:
            # token 1 is the primary's token 1 (shared branch point)
            self._emit(req, g.first_token)
            hit_eos = (req.eos_id is not None
                       and g.first_token == req.eos_id)
            if len(req.generated) >= req.max_new_tokens or hit_eos:
                self._finish(slot, req)
        return True

    # ------------------------------------------------------------------
    # chunked prefill (inside the fused step)
    # ------------------------------------------------------------------
    def _advance_chunk(self) -> bool:
        """Stage the next prefill chunk for ONE admitting slot (round-
        robin interleaving policy); a slot stalled on pool exhaustion
        yields its turn.  Returns True iff a chunk was staged."""
        sched = self.sched
        slots = sorted(sched.admitting)
        order = ([s for s in slots if s >= self._chunk_rr]
                 + [s for s in slots if s < self._chunk_rr])
        for slot in order:
            if self._stage_chunk(slot, sched.admitting[slot]):
                self._chunk_rr = slot + 1
                return True
        return False

    def _stage_chunk(self, slot: int, req: Request) -> bool:
        sched = self.sched
        P = len(req.prompt)
        C = self.chunk_tokens
        start = req.chunk_pos
        end = min(start + C, P)
        # incremental allocation: exactly the pages this chunk's valid
        # tokens land in (the padded tail of the last chunk writes to the
        # scratch page 0, like every other masked lane)
        need = min(-(-end // self.block), req.total_pages(self.block))
        n_new = need - req.n_pages
        if n_new > 0:
            pages = self._alloc_chunk_pages(slot, req, n_new)
            if pages is None:
                return False  # back-pressure: stall, retry next step
            sched.add_chunk_pages(slot, pages)
            self._refs_dirty = True
        toks = np.zeros((C,), np.int32)
        toks[: end - start] = req.prompt[start:end]
        nc = C // self.block
        fb = start // self.block
        spages = sched.slot_pages[slot]
        write_pages = np.asarray(
            [sched.gid(spages[fb + j]) if fb + j < len(spages) else 0
             for j in range(nc)], np.int32)
        is_last = end >= P
        last_index = (P - 1 - start) if is_last else (C - 1)
        self.dev.stage_chunk(slot, toks, start,
                             sched.block_table[slot].copy(), write_pages,
                             is_last, last_index,
                             seed=int(req.sample_key or 0))
        self._chunk_need_pages = need
        req.chunk_pos = end
        self.prefill_chunks += 1
        if self.spans.enabled:
            self.spans.event(self._srid(req), "chunk", step=self.steps,
                             replica=self.replica_id,
                             index=start // max(C, 1), start=start,
                             end=end)
        if is_last:
            self._chunk_finalizing = req
            hold = getattr(req, "_chunk_hold", None)
            if hold is not None:
                hold.release()
                req._chunk_hold = None  # type: ignore[attr-defined]
            if req.handoff:
                # disaggregated prefill: the final chunk still rides this
                # step (token 1 lands in first_buf and _first_dev), but the
                # slot is NOT promoted to the decode lane — it parks in
                # prefill_done until the tier plane exports its K/V pages
                # to a decode replica.  The slot's device lengths and mask
                # stay 0, so the fused step never decodes it here.
                sched.park_prefill_done(slot)
            else:
                # prompt fully staged: promote to the decode lane.  The
                # admit below applies in the SAME step as the final chunk
                # — the chunk lane runs first and leaves token 1 in
                # first_buf, so this step already decodes token 2.
                sched.promote(slot, P)
                self.dev.stage_admit(slot, P, sched.block_table[slot],
                                     req.n_pages, token_from_buf=True,
                                     set_token=True,
                                     seed=int(req.sample_key or 0))
        return True

    def _alloc_chunk_pages(self, slot: int, req: Request,
                           n: int) -> Optional[List[int]]:
        """Allocate one chunk's pages, cycling the chunk holds under
        back-pressure: release them (un-parking every page they pinned),
        force-sync the pipeline, reclaim, re-open, retry."""
        try:
            return self.pool.alloc(slot, n)
        except PoolExhausted:
            pass
        self.backpressure_syncs += 1
        self.chunk_backpressure += 1
        self._cycle_chunk_holds()
        try:
            return self.pool.alloc(slot, n)
        except PoolExhausted:
            return None

    def _cycle_chunk_holds(self) -> None:
        """Back-pressure valve: release every admitting request's chunk
        hold, force-sync the pipeline so no step can still read the pages
        they pinned, reclaim, and re-open fresh holds.  Safe because a
        mid-prefill slot's OWN pages are allocated (never retired), so the
        hold is a domain-wide courtesy pin, not a correctness pin."""
        reqs = [r for r in self.sched.admitting.values()
                if getattr(r, "_chunk_hold", None) is not None]
        for r in reqs:
            r._chunk_hold.release()
        while self.sched.inflight:
            self._complete_oldest()
        self.pool.reclaim()
        for r in reqs:
            r._chunk_hold = self.pool.hold(  # type: ignore[attr-defined]
                "chunk-prefill")

    # ------------------------------------------------------------------
    # decode dispatch (ONE fused device step)
    # ------------------------------------------------------------------
    def _dispatch_decode(self) -> None:
        t0 = time.perf_counter_ns()
        sched = self.sched
        # page growth: the DEVICE decides via its lengths; the host runs
        # the same deterministic rule on its mirror to pop the free-list
        # candidates the device will consume, and to detect exhaustion
        # (back-pressure) BEFORE dispatch
        grow: Dict[int, int] = {}
        # snapshot: the back-pressure force-sync below may _finish (and
        # remove from active) any request, including this one
        for slot, req in list(sched.active.items()):
            # the speculative lane writes K/V up to k positions past the
            # current length inside ONE step, so the page horizon extends
            # by k (still at most one new page: counts <= k + 1 <= block)
            need = min((int(sched.lengths[slot]) + self.speculate_k)
                       // self.block + 1, self.mb)
            if req.done or req.n_pages >= need:
                continue
            if need - req.n_pages != 1:
                raise RuntimeError("host mirror drifted from the device")
            try:
                (page,) = self.pool.alloc(slot, 1)
            except PoolExhausted:
                # back-pressure: force-sync everything — cycling any open
                # chunk holds first, so their parked retires can reclaim —
                # and retry once (device wait: out of the host-ns timer)
                self.backpressure_syncs += 1
                self.host_ns += time.perf_counter_ns() - t0
                self._cycle_chunk_holds()
                t0 = time.perf_counter_ns()
                if req.done:
                    continue  # force-sync finished this very request
                (page,) = self.pool.alloc(slot, 1)
            grow[slot] = sched.append_page(slot, page)
            self._refs_dirty = True
        if not sched.active and not self.dev.has_pending_chunk():
            return  # every active request finished during force-sync

        # teacher-forced suffix tokens (prefix-cache admissions) override
        # the sampled token chain for their slots
        tf: Dict[int, int] = {}
        for slot, req in sched.active.items():
            suffix = getattr(req, "_tf_suffix", [])
            if suffix:
                tf[slot] = suffix.pop(0)

        if self._refs_dirty:
            self._page_refs = sched.page_refs()
            self._refs_dirty = False

        # bucketed bound on the KV sweep: pages any active sequence — or
        # the staged prefill chunk's gather — can touch this step (the
        # power-of-two bucket keeps the chunk gather's shapes few)
        n_need = max(sched.max_need_pages(self.speculate_k),
                     self._chunk_need_pages, 1)
        n_kv = min(max(_pow2_bucket(n_need), 1), self.mb)
        self.host_ns += time.perf_counter_ns() - t0

        stamp = self.pool.begin_step(self._page_refs)
        tokens, chunk_first, spec = self.dev.dispatch(tf, grow, n_kv)
        if self._chunk_finalizing is not None:
            # the final chunk's on-device first token; the host reads it
            # at this request's first pipeline-lagged completion
            self._chunk_finalizing._first_dev = (  # type: ignore
                chunk_first)
            self._chunk_finalizing = None
        self._chunk_need_pages = 0
        self.decode_steps += 1
        # fork plane: once a group primary's mirror length covers the
        # shared prefix, every prefix position's KV write is ENQUEUED
        # (stream order), so siblings may start reading it
        for slot, req in list(sched.active.items()):
            g = req.group
            if (g is not None and req.branch_idx == 0 and not g.ready
                    and int(sched.lengths[slot]) >= g.prefix_len):
                self._record_fork_parent(req, g)
        sched.inflight.append(
            (stamp, tokens, dict(sched.active), sched.lengths.copy(), spec)
        )
        if spec is not None:
            # the speculative lane advances each slot by a data-dependent
            # accepted count; the mirror needs it before the NEXT step, so
            # completion is immediate (pipeline depth 1)
            self._complete_oldest()
        else:
            sched.advance_lengths()

    # ------------------------------------------------------------------
    # completion (the pipeline-lagged sync point)
    # ------------------------------------------------------------------
    def _complete_oldest(self) -> None:
        if not self.sched.inflight:
            return
        stamp, tokens_dev, active, lengths_snap, spec = (
            self.sched.inflight.popleft()
        )
        tokens = tokens_dev.cpu().numpy()  # sync point
        if spec is not None:
            v = spec[0].cpu().numpy()  # the verifier's chain
            counts = spec[1].cpu().numpy()  # accepted + 1
        self.pool.complete_step(stamp)
        if spec is not None:
            # the card advanced each slot by its accepted count; the
            # mirror follows the observed counts (the ONE place the lane
            # syncs host bookkeeping from device data)
            for slot, req in active.items():
                if self.sched.active.get(slot) is req:
                    self.sched.lengths[slot] = (int(lengths_snap[slot])
                                                + int(counts[slot]))
        for slot, req in active.items():
            if req.done:
                continue
            first_dev = getattr(req, "_first_dev", None)
            if first_dev is not None:
                # the step consuming token 1 has completed, so this read
                # returns a ready value — no pipeline stall
                self._emit(req, int(first_dev.item()))
                req._first_dev = None  # type: ignore[attr-defined]
            # this step consumed the token at position lengths_snap[slot];
            # its output is a real sample only past the prompt
            pos = int(lengths_snap[slot])
            if pos + 1 < len(req.prompt):
                continue  # teacher-forcing internal step
            if spec is not None:
                # the verifier's argmax chain IS the greedy chain: emit the
                # accepted run (+1, the verifier's own token)
                c = int(counts[slot])
                self.spec_drafted += self.speculate_k
                self.spec_accepted += c - 1
                for j in range(c):
                    tok = int(v[slot, j])
                    self._emit(req, tok)
                    if (len(req.generated) >= req.max_new_tokens
                            or (req.eos_id is not None
                                and tok == req.eos_id)):
                        self._finish(slot, req)
                        break
                continue
            tok = int(tokens[slot, 0])
            self._emit(req, tok)
            hit_eos = req.eos_id is not None and tok == req.eos_id
            if len(req.generated) >= req.max_new_tokens or hit_eos:
                self._finish(slot, req)

    def _emit(self, req: Request, tok: int) -> None:
        """Host-observed token emission: the ONLY place generated tokens
        appear, so the replay journal can never miss one."""
        req.generated.append(tok)
        req.token_times.append(time.time())
        req.token_busy.append(self.busy_s)
        self.tokens_emitted += 1
        if (req.group is not None and req.branch_idx == 0
                and req.group.first_token is None):
            # the fork group's branch point for suffix-less best-of-N
            req.group.first_token = tok
        if not req.first_token_at:
            req.first_token_at = time.time()
            if self.spans.enabled:
                srid = self._srid(req)
                self.spans.end(srid, "prefill", step=self.steps)
                self.spans.event(srid, "first-token", step=self.steps,
                                 replica=self.replica_id)
                self.spans.begin(srid, "decode", step=self.steps,
                                 replica=self.replica_id)
        if self.journal is not None:
            self.journal.record_token(req, tok)

    @staticmethod
    def _split_refs(req: Request, refs):
        """(own, foreign) refs of a released slot: foreign are the
        group's shared prefix pages a fork secondary holds by fork
        reference, own everything it allocated.  Ownership is read from
        the group, not from the page's slot: a secondary admitted into
        its primary's former slot holds shared pages of its own slot
        number (the JAX engine's ``r[0] == slot`` test retires them a
        second time there and never releases the fork reference)."""
        shared = (set(req.group.shared_refs) if req.is_fork_secondary
                  else set())
        return ([r for r in refs if r not in shared],
                [r for r in refs if r in shared])

    def _finish(self, slot: int, req: Request) -> None:
        req.done = True
        req.finished_at = time.time()
        if self.journal is not None:
            self.journal.record_finish(req)
        self.sched.finished.append(req)
        refs = self.sched.release_slot(slot)
        own, foreign = self._split_refs(req, refs)
        # donate full OWN prompt blocks to the prefix cache; retire the
        # rest as one batch; CoW-shared parent pages are not ours to
        # donate or retire — drop our fork references instead (the LAST
        # branch's release retires them as one batch through the policy)
        donated = set()
        for i in range(len(req.prompt) // self.block):
            if i >= len(refs) or refs[i] in foreign:
                continue
            key = block_key(req.prompt[: (i + 1) * self.block])
            if self.prefix_cache.insert(key, slot, refs[i][1]):
                donated.add(refs[i])
        to_free = [r for r in own if r not in donated]
        if to_free:
            self.pool.free_refs(to_free)
        if foreign:
            self.pool.release_fork(foreign)
        self._refs_dirty = True
        self.dev.stage_reset(slot)
        if self.spans.enabled:
            srid = self._srid(req)
            self.spans.end_open(srid, step=self.steps)
            self.spans.event(srid, "finish", step=self.steps,
                             replica=self.replica_id,
                             tokens=len(req.generated))

    # ------------------------------------------------------------------
    def publish(self) -> None:
        """Mirror this engine's counters into the metrics registry
        (pull-style).  The pool publishes its own memory-plane
        instruments."""
        reg = self.obs
        if not reg.enabled:
            return
        self.pool.publish()
        lab = dict(policy=self.pool.policy_name, replica=self.replica_id)
        g = reg.gauge
        g("engine_steps", **lab).set(self.steps)
        g("requests_finished", **lab).set(len(self.sched.finished))
        g("admissions", **lab).set(self.admissions)
        g("tokens_emitted", **lab).set(self.tokens_emitted)
        g("queue_depth", **lab).set(len(self.sched.waiting))
        g("active_slots", **lab).set(len(self.sched.active))
        g("inflight_steps", **lab).set(len(self.sched.inflight))
        g("prefill_chunks", **lab).set(self.prefill_chunks)
        g("chunk_backpressure", **lab).set(self.chunk_backpressure)
        g("backpressure_syncs", **lab).set(self.backpressure_syncs)
        g("handoffs_out", **lab).set(self.handoffs_out)
        g("handoffs_in", **lab).set(self.handoffs_in)
        g("prefix_hits", **lab).set(self.prefix_cache.hits)
        g("prefix_misses", **lab).set(self.prefix_cache.misses)
        g("cow_copies", **lab).set(self.cow_copies)
        g("fork_admissions", **lab).set(self.fork_admissions)
        g("spec_drafted", **lab).set(self.spec_drafted)
        g("spec_accepted", **lab).set(self.spec_accepted)

    def stats(self) -> Dict[str, Any]:
        return apply_aliases({
            "scan_steps": (self.pool.scan_steps
                           + self.pool.ledger_scan_steps),
            "replica_id": self.replica_id,
            "steps": self.steps,
            "finished": len(self.sched.finished),
            "admissions": self.admissions,
            "free_pages": self.pool.free_pages_total(),
            # includes the device plane's operand-staging time
            "host_us_per_step": (
                (self.host_ns + self.dev.stage_ns) / 1e3
                / max(self.steps, 1)
            ),
            # numerator tracked by the device plane, denominator by the
            # engine: a reintroduced per-step extra launch shows as > 1
            "dispatches_per_step": (
                self.dev.decode_dispatches / max(self.decode_steps, 1)
            ),
            "decode_dispatches": self.dev.decode_dispatches,
            "admission_dispatches": self.dev.admission_dispatches,
            "chunk_tokens": self.chunk_tokens,
            "prefill_chunks": self.prefill_chunks,
            "chunk_backpressure": self.chunk_backpressure,
            "chunk_shapes": sorted(self.dev.chunk_shapes),
            "prefill_jit_shapes": self.dev.prefill_jit_shapes(),
            "backpressure_syncs": self.backpressure_syncs,
            "pool_unreclaimed": self.pool.unreclaimed(),
            "pool_freed": self.pool.freed_total,
            "pool_scan_steps": self.pool.scan_steps,
            "ledger_scan_steps": self.pool.ledger_scan_steps,
            "prefix_hits": self.prefix_cache.hits,
            "prefix_misses": self.prefix_cache.misses,
            "prefix_evictions": self.prefix_cache.evictions,
            "prefix_evicted_while_forked": (
                self.prefix_cache.evicted_while_forked
            ),
            # CoW fork plane
            "cow": self.cow,
            "forks_taken": self.pool.forks_taken,
            "forks_released": self.pool.forks_released,
            "cow_copies": self.cow_copies,
            "fork_admissions": self.fork_admissions,
            # tier plane
            "handoffs_out": self.handoffs_out,
            "handoffs_in": self.handoffs_in,
            "prefill_ready": len(self.sched.prefill_done),
            # speculative-decode lane
            "speculate_k": self.speculate_k,
            "spec_drafted": self.spec_drafted,
            "spec_accepted": self.spec_accepted,
            "spec_acceptance": (
                self.spec_accepted / max(self.spec_drafted, 1)
            ),
            "tokens_emitted": self.tokens_emitted,
            "tokens_per_dispatch": (
                self.tokens_emitted / max(self.dev.decode_dispatches, 1)
            ),
        })
