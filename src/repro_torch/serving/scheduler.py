"""Scheduler plane of the serving engine: admission, continuous batching
and pipeline-lag completion bookkeeping.

The scheduler owns everything request-shaped on the host: the waiting
queue, the slot -> request map, the free-slot stack, the in-flight
pipeline of dispatched-but-unobserved steps, and the deterministic host
mirrors of the device state (lengths, block table, per-slot page lists).
The mirrors are advanced by the same rules the device applies inside the
fused step (+1 per active slot per dispatch; set at admission; zeroed at
finish), so the host NEVER reads device state to make a scheduling or
allocation decision — agreement is by construction, not by syncing.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    # runtime state
    slot: int = -1
    replica: int = -1  # which cluster replica is serving this request
    generated: Optional[List[int]] = None
    n_pages: int = 0
    chunk_pos: int = 0  # prompt tokens prefilled so far (chunked path)
    done: bool = False
    submitted_at: float = 0.0
    first_token_at: float = 0.0  # host observed token 1 (TTFT numerator)
    finished_at: float = 0.0
    # per-token host-observed emit times (ITL = consecutive deltas);
    # spans replicas for a handed-off request
    token_times: List[float] = dataclasses.field(default_factory=list)
    # per-token snapshot of the EMITTING replica's busy clock
    # (engine.busy_s): inter-token deltas on one replica measure its own
    # serving cadence even though the in-process cluster ticks replicas
    # serially — the deployment-faithful ITL for tier comparisons
    token_busy: List[float] = dataclasses.field(default_factory=list)
    # sampled mode: the journaled RNG key — the u that samples the token
    # at sequence index pos is counter_uniform(sample_key, pos), so any
    # replica resumes the stream bit-identically (replay, KV handoff)
    sample_key: Optional[int] = None
    # tier plane: stop at prefill completion and park in prefill_done
    # for the TierManager to hand off to a decode replica
    handoff: bool = False
    # copy-on-write fork state: branches of a ForkGroup share the
    # parent's full prompt pages instead of re-prefilling them
    group: Optional["ForkGroup"] = None
    branch_idx: int = 0

    def total_pages(self, block: int) -> int:
        """Pages this request's full prompt occupies."""
        return max(-(-len(self.prompt) // block), 1)

    @property
    def is_fork_secondary(self) -> bool:
        return self.group is not None and self.branch_idx != 0

    def pending_pages(self, block: int) -> int:
        """Pages this request still needs ALLOCATED (routing signal).
        A CoW fork secondary shares the group's full prompt-prefix pages
        with the parent — they are counted once, on the parent — so its
        own footprint is just the partial-page copy (if any)."""
        if self.is_fork_secondary:
            shared = self.group.prefix_len // block
            return max(self.total_pages(block) - shared, 0) - self.n_pages
        return self.total_pages(block) - self.n_pages


class ForkGroup:
    """N requests sharing one prompt prefix through CoW page forking.

    Branch 0 (the *primary*) prefills the prefix once; the other
    branches admit by referencing the primary's full prefix pages via
    global page ids (one ``fork_refs`` per branch) and copy only the
    partial last prompt page (the actual copy-on-write).  The engine
    records the shareable refs when the primary finishes prefilling and
    every branch releases its fork references when it finishes or is
    killed (``select_winner``)."""

    def __init__(self, gid: int, prefix_len: int, n: int,
                 suffixes: Optional[List[List[int]]] = None) -> None:
        self.gid = gid
        self.prefix_len = prefix_len  # tokens of the SHARED prefix
        self.n = n
        self.suffixes = suffixes  # per-branch teacher-forced extensions
        self.branches: List[Request] = []
        #: parent's full prefix pages, shareable cross-slot (global ids)
        self.shared_refs: List[Tuple[int, int]] = []
        #: parent's partial last prompt page (CoW-copied per branch)
        self.partial_ref: Optional[Tuple[int, int]] = None
        #: primary's prefix KV is on device (its final prefill dispatched)
        self.ready = False
        #: primary's first sampled token (host-observed) — the branch
        #: point for suffix-less best-of-N groups
        self.first_token: Optional[int] = None
        self.winner: Optional[int] = None

    @property
    def primary(self) -> Optional[Request]:
        return self.branches[0] if self.branches else None


class Scheduler:
    def __init__(self, max_slots: int, mb: int, block: int,
                 pipeline_depth: int, *, replica_id: int = 0,
                 n_pool: int = 0) -> None:
        self.max_slots = max_slots
        self.replica_id = replica_id
        self.mb = mb
        self.block = block
        # per-slot pool depth: block-table mirrors hold GLOBAL page ids
        # (gid = owner_slot * n_pool + page), the addressing mode that
        # lets a fork branch's table row point into the parent's pages
        self.n_pool = n_pool
        self.pipeline_depth = pipeline_depth
        self.waiting: Deque[Request] = deque()
        self.active: Dict[int, Request] = {}  # slot -> request
        # slot -> request mid chunked-prefill: the slot is occupied and
        # its pages are referenced by chunk steps, but it takes no part
        # in the decode lane until its final chunk promotes it to active
        self.admitting: Dict[int, Request] = {}
        # slot -> handoff-marked request whose prefill completed: the KV
        # for the whole prompt is on device, token 1 is in first_buf, and
        # the slot never enters the decode lane — it parks here (the
        # group-level ready queue's source) until the TierManager exports
        # it to a decode replica
        self.prefill_done: Dict[int, Request] = {}
        self.finished: List[Request] = []
        self.free_slots: List[int] = list(range(max_slots))
        # lifecycle plane: a draining replica stops admitting (waiting
        # requests requeue onto survivors) but finishes what it has
        self.admissions_paused = False
        # (stamp, tokens_dev, active snapshot, lengths snapshot,
        #  spec = (verify_chain, counts) device pair or None)
        self.inflight: Deque[Tuple[int, Any, Dict[int, Request],
                                   np.ndarray, Any]] = deque()
        # host mirrors (bookkeeping only — never uploaded on the hot path)
        self.lengths = np.zeros((max_slots,), np.int32)
        # block_table holds GLOBAL page ids; slot_pages holds the
        # matching (owner_slot, page) refs — identical order, so entry i
        # of both describes prompt/generation block i
        self.block_table = np.zeros((max_slots, mb), np.int32)
        self.slot_pages: List[List[Tuple[int, int]]] = [
            [] for _ in range(max_slots)
        ]
        self._next_rid = 0

    def gid(self, ref: Tuple[int, int]) -> int:
        """Global page id of a (owner_slot, page) ref."""
        return ref[0] * self.n_pool + ref[1]

    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int,
               eos_id: Optional[int],
               sample_key: Optional[int] = None) -> Request:
        req = Request(self._next_rid, list(map(int, prompt)),
                      max_new_tokens, eos_id)
        req.replica = self.replica_id
        req.sample_key = sample_key
        req.submitted_at = time.time()
        self._next_rid += 1
        self.waiting.append(req)
        return req

    def has_work(self) -> bool:
        return bool(self.waiting or self.active or self.admitting
                    or self.prefill_done or self.inflight)

    def take_waiting(self) -> List[Request]:
        """Drain helper: hand the not-yet-admitted queue back to the
        cluster so those requests re-route to surviving replicas."""
        out = list(self.waiting)
        self.waiting.clear()
        return out

    def adopt(self, req: Request) -> Request:
        """Adopt a request requeued from a draining replica: it joins
        this scheduler's waiting queue under a fresh LOCAL rid (rids are
        per-replica), keeping object identity so the submitter's handle
        stays valid."""
        req.rid = self._next_rid
        self._next_rid += 1
        req.slot = -1
        req.replica = self.replica_id
        self.waiting.append(req)
        return req

    def queue_depth(self) -> int:
        """Router load signal: requests not yet fully served here."""
        return (len(self.waiting) + len(self.active) + len(self.admitting)
                + len(self.prefill_done) + len(self.inflight))

    def pending_prefill_pages(self) -> int:
        """Pages this scheduler is already committed to allocating: the
        unprefilled remainder of every mid-flight chunked admission plus
        every waiting prompt.  Chunk-aware routing subtracts this from
        the pool's free pages so a replica mid-prefill reports its TRUE
        load, not the transiently-rosy free count."""
        pending = sum(
            r.pending_pages(self.block) for r in self.admitting.values()
        )
        # waiting CoW fork secondaries charge only their OWN pages (the
        # shared prefix is already allocated, and counted, on the parent)
        pending += sum(r.pending_pages(self.block) for r in self.waiting)
        return pending

    def pipeline_full(self) -> bool:
        return len(self.inflight) >= self.pipeline_depth

    # ------------------------------------------------------------------
    def bind_slot(self, req: Request, slot: int, pages: List[int],
                  length: int) -> None:
        """Install a request into a slot using its OWN pages."""
        self.bind_slot_refs(req, slot, [(slot, p) for p in pages], length)

    def bind_slot_refs(self, req: Request, slot: int,
                       refs: List[Tuple[int, int]], length: int) -> None:
        """Install a request into a slot: mirrors + runtime state.
        ``refs`` may point into OTHER slots' pages (CoW fork branches);
        the table row stores their global ids."""
        assert self.free_slots and self.free_slots[-1] == slot
        self.free_slots.pop()
        req.slot = slot
        req.generated = []
        req.n_pages = len(refs)
        row = np.zeros((self.mb,), np.int32)
        row[: len(refs)] = [self.gid(r) for r in refs]
        self.block_table[slot] = row
        self.slot_pages[slot] = list(refs)
        self.lengths[slot] = length
        self.active[slot] = req

    def bind_admitting(self, req: Request, slot: int) -> None:
        """Occupy a slot for a chunked admission: no pages yet (they
        arrive per chunk), no decode-lane mirrors (lengths stay 0 until
        the final chunk promotes the slot to active)."""
        assert self.free_slots and self.free_slots[-1] == slot
        self.free_slots.pop()
        req.slot = slot
        req.generated = []
        req.n_pages = 0
        req.chunk_pos = 0
        self.block_table[slot] = 0
        self.slot_pages[slot] = []
        self.lengths[slot] = 0
        self.admitting[slot] = req

    def add_chunk_pages(self, slot: int, pages: List[int]) -> None:
        """Incremental allocation: append one chunk's pages to the slot's
        mirrors (the device sees them via the staged chunk row)."""
        req = self.admitting[slot]
        row = self.block_table[slot]
        for p in pages:
            row[req.n_pages] = self.gid((slot, p))
            self.slot_pages[slot].append((slot, p))
            req.n_pages += 1

    def append_page(self, slot: int, page: int) -> int:
        """Decode-growth mirror: append one own-slot page to an active
        slot; returns the global id the device consumes as its growth
        candidate."""
        req = self.active[slot]
        g = self.gid((slot, page))
        self.block_table[slot, req.n_pages] = g
        self.slot_pages[slot].append((slot, page))
        req.n_pages += 1
        return g

    def promote(self, slot: int, length: int) -> Request:
        """Final chunk staged: the slot joins the decode lane at
        ``length`` (= prompt length), mirroring the admit the device
        applies inside the same fused dispatch."""
        req = self.admitting.pop(slot)
        self.lengths[slot] = length
        self.active[slot] = req
        return req

    def park_prefill_done(self, slot: int) -> Request:
        """Tier plane: final chunk staged for a HANDOFF request — the
        slot leaves the admitting set but never joins the decode lane.
        Its pages (whole-prompt KV) stay referenced until export; lengths
        mirror stays 0, matching the device (no admit was staged)."""
        req = self.admitting.pop(slot)
        self.prefill_done[slot] = req
        return req

    def release_slot(self, slot: int) -> List[Tuple[int, int]]:
        """Finish bookkeeping: returns the (owner_slot, page) refs the
        slot held — own pages AND any CoW-shared parent pages.  Works on
        active slots and on parked prefill-done slots (handoff export)."""
        refs = self.slot_pages[slot]
        self.slot_pages[slot] = []
        self.block_table[slot] = 0
        self.lengths[slot] = 0
        if slot in self.active:
            del self.active[slot]
        else:
            del self.prefill_done[slot]
        self.free_slots.append(slot)
        return refs

    def advance_lengths(self) -> None:
        """Mirror of the device's ``lengths + mask`` (one per dispatch)."""
        for slot in self.active:
            self.lengths[slot] += 1

    def page_refs(self) -> List[tuple]:
        """Pages an in-flight step may read: every active slot's pages
        plus every mid-prefill slot's (chunk steps gather the earlier
        chunks' pages through the staged block-table row).  CoW fork
        branches contribute their PARENT's refs here, so the policy
        protects shared pages for the step's whole in-flight window."""
        return [
            ref
            for slots in (self.active, self.admitting, self.prefill_done)
            for slot in slots
            for ref in self.slot_pages[slot]
        ]

    def max_need_pages(self, lookahead: int = 0) -> int:
        """Pages any active sequence can touch this step (n_kv bound);
        ``lookahead`` extends the horizon by k speculative positions."""
        return max(
            (int(self.lengths[s]) + lookahead) // self.block + 1
            for s in self.active
        ) if self.active else 1
