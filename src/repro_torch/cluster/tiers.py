"""Tier plane: disaggregated prefill/decode replicas with hold-protected
mid-request KV handoff.

A :class:`~repro_torch.cluster.group.ReplicaGroup` built with
``prefill_replicas=P, decode_replicas=D`` partitions its replicas into a
**prefill tier** (admits every new request, runs chunked prefill to
completion, never decodes) and a **decode tier** (receives whole-prompt
KV mid-request, serves every decode token).  The :class:`TierManager` is
the group-level control loop joining them — the cross-replica
continuous-batching scheduler:

  1. **park** — a handoff-marked request's final prefill chunk rides the
     fused step like any other (token 1 sampled on device), but the slot
     is never promoted to the decode lane: it parks in the scheduler's
     ``prefill_done`` map, the distributed *ready queue* the decode tier
     pulls from.
  2. **export** — each tick, every parked request with a viable
     destination is exported: a
     :class:`~repro_torch.cluster.ledger.ClusterHold` opens (owner =
     the SOURCE replica), token 1 is emitted and
     journaled on the source, the whole-prompt KV pages are read to host
     and freed.  The freed pages *retire-but-held*: the open hold pins
     them in every domain until the import lands — the paper's
     long-lived critical region at handoff granularity.  Stamp-it frees
     them within one scan of the hold's release; deferred schemes
     (hazard, DEBRA) lag by their batch amortization — the asymmetry
     the JAX package's disaggregation bench measures.
  3. **import** — after ``import_delay`` ticks (a test seam modelling
     transfer latency; 0 by default) the destination installs the KV
     into its own shard and admits the request straight into its decode
     lane under a fresh local rid and a NEW journal entry carrying the
     emitted prefix — the journal ``adopt()`` bookkeeping, which is what
     makes a death on either side replay cleanly.
  4. **commit** — one tick later the hold releases and the SOURCE
     journal entry prunes (:meth:`RequestJournal.record_handoff`):
     ownership has moved, so a later source death must not replay a
     request that is alive on the destination.

**Fault windows.**  The manager reacts only to *declared* state — a
hold force-expired by the lifecycle plane or a replica in
``lifecycle.dead`` — never to raw fault-injection flags, matching the
cluster's missed-heartbeats-only detection doctrine:

  * source dies **before import**: the hold force-expires (freed pages
    reclaim), the packet aborts, and the lifecycle plane replays the
    request from the source journal (``prompt + [token 1]`` — counter
    sampling resumes the stream bit-identically on any survivor).
  * source dies **after import**: the request is already live on the
    destination (its ``replica`` no longer matches the source journal
    entry, so replay skips it); the commit still prunes and releases.
  * destination dies before import: the packet re-picks a destination.

Destination choice is the continuous-batching admission rule: the live
decode replica with a free slot and the most ``effective_free_pages``;
if the decode tier is entirely unavailable the packet falls back to any
live replica (the source included) so no request strands.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from .ledger import ClusterHold

HANDOFF_TAG = "kv-handoff"


@dataclasses.dataclass
class HandoffPacket:
    """One in-flight mid-request KV handoff (export -> import -> commit)."""

    req: Any  # serving-plane Request (kept duck-typed)
    data: dict  # export_request payload: k/v, token1, prompt_len, ...
    src: int
    dst: int
    src_rid: int  # journal key on the source (req.rid is reassigned)
    hold: ClusterHold
    export_tick: int
    imported_tick: int = -1
    state: str = "exported"  # exported -> imported -> done | aborted


class TierManager:
    def __init__(self, group, prefill_ids: List[int],
                 decode_ids: List[int], *, import_delay: int = 0) -> None:
        if not prefill_ids or not decode_ids:
            raise ValueError("both tiers need at least one replica")
        if set(prefill_ids) & set(decode_ids):
            raise ValueError("a replica cannot be in both tiers")
        if import_delay < 0:
            raise ValueError("import_delay must be >= 0")
        self.group = group
        self.prefill_ids = list(prefill_ids)
        self.decode_ids = list(decode_ids)
        #: ticks between export and import — models transfer latency and
        #: is the fault-test seam: a delay past the heartbeat timeout
        #: forces the death-before-import window
        self.import_delay = import_delay
        self.ticks = 0
        self.packets: List[HandoffPacket] = []
        # observability
        self.handoffs_started = 0
        self.handoffs_completed = 0
        self.handoffs_aborted = 0
        self.import_retries = 0
        self.pages_handed_off = 0
        self.hold_ticks_total = 0  # sum of export->commit hold windows
        self.log: List[Dict[str, int]] = []

    # ------------------------------------------------------------------
    # membership views
    # ------------------------------------------------------------------
    def role(self, i: int) -> str:
        if i in self.prefill_ids:
            return "prefill"
        if i in self.decode_ids:
            return "decode"
        return "unassigned"

    def roles(self) -> Dict[int, str]:
        return {i: self.role(i) for i in range(self.group.n_replicas)}

    def register(self, i: int, tier: str) -> None:
        """A freshly added replica joins a tier (scale_tier / add)."""
        if tier == "prefill":
            self.prefill_ids.append(i)
        elif tier == "decode":
            self.decode_ids.append(i)
        else:
            raise ValueError(f"unknown tier {tier!r}")

    def live_prefill(self) -> List[int]:
        live = set(self.group.live_ids())
        return [i for i in self.prefill_ids if i in live]

    def live_decode(self) -> List[int]:
        live = set(self.group.live_ids())
        return [i for i in self.decode_ids if i in live]

    # ------------------------------------------------------------------
    # request plane
    # ------------------------------------------------------------------
    def mark(self, req, replica: int) -> None:
        """Routing postlude: a request admitted on a prefill replica
        hands off after prefill; one admitted elsewhere (decode-tier
        fallback when the prefill tier is down) runs unified there."""
        req.handoff = replica in self.prefill_ids

    def pending(self) -> bool:
        """In-flight packets keep ``run_until_done`` stepping: between
        export and import the request lives in NO scheduler."""
        return bool(self.packets)

    def involves(self, i: int) -> bool:
        """Drain barrier: replica ``i`` may not retire while a packet
        still names it (its hold or its import target)."""
        return any(p.src == i or p.dst == i for p in self.packets)

    def ready_queue_depth(self) -> int:
        """Parked prefill-done requests across the prefill tier."""
        g = self.group
        return sum(len(g.engines[i].sched.prefill_done)
                   for i in self.live_prefill())

    # ------------------------------------------------------------------
    # the control loop (one tick per cluster step, after lifecycle)
    # ------------------------------------------------------------------
    def tick(self) -> None:
        """Advance every packet at most one phase (commit before import
        before export, so a packet never races export->commit in one
        tick) and export newly parked requests."""
        self.ticks += 1
        self._commit()
        self._import()
        self._export()

    def _src_gone(self, p: HandoffPacket) -> bool:
        lc = self.group.lifecycle
        return (p.hold.forced
                or (lc is not None and p.src in lc.dead)
                or self.group.engines[p.src].retired)

    def _dst_ok(self, dst: int, src: int) -> bool:
        g = self.group
        if dst not in g.live_ids():
            return False
        eng = g.engines[dst]
        return bool(eng.sched.free_slots) and not eng.sched.admissions_paused

    def _pick_dst(self, src: int) -> Optional[int]:
        g = self.group
        cands = [j for j in self.live_decode() if self._dst_ok(j, src)]
        if not cands:
            # decode tier unavailable: any live replica (src included, so
            # a lone surviving prefill replica still serves its parked
            # work unified) rather than stranding the request
            cands = [j for j in g.live_ids() if self._dst_ok(j, src)]
        if not cands:
            return None
        return max(cands, key=lambda j: (
            g.engines[j].effective_free_pages(), -j))

    def _export(self) -> None:
        g = self.group
        for i in self.live_prefill():
            eng = g.engines[i]
            for slot in sorted(eng.sched.prefill_done):
                req = eng.sched.prefill_done[slot]
                dst = self._pick_dst(i)
                if dst is None:
                    return  # no capacity anywhere: retry next tick
                src_rid = req.rid
                # the hold opens BEFORE the export frees the pages: from
                # here to commit they are retire-but-held in every domain
                hold = g.ledger.hold(HANDOFF_TAG, owner=i)
                data = eng.export_request(slot)
                if data is None:
                    # token 1 satisfied eos/budget: finished on source
                    hold.release()
                    continue
                self.packets.append(HandoffPacket(
                    req=req, data=data, src=i, dst=dst, src_rid=src_rid,
                    hold=hold, export_tick=self.ticks,
                ))
                self.handoffs_started += 1
                self.pages_handed_off += data["n_pages"]
                spans = g.spans
                if spans.enabled:
                    srid = getattr(req, "_span_rid", f"r{i}.{src_rid}")
                    spans.begin(srid, "handoff", step=self.ticks,
                                replica=i, src=i,
                                pages=data["n_pages"])
                    spans.event(srid, "handoff-export", step=self.ticks,
                                replica=i)

    def _import(self) -> None:
        g = self.group
        for p in self.packets:
            if p.state != "exported":
                continue
            if self.ticks < p.export_tick + 1 + self.import_delay:
                continue
            if self._src_gone(p):
                # source declared dead mid-window: its journal replays
                # the request (prompt + emitted resumes bit-identically
                # under counter sampling) — importing the packet too
                # would double-serve it
                self._abort(p)
                continue
            if not self._dst_ok(p.dst, p.src):
                nd = self._pick_dst(p.src)
                if nd is None:
                    continue  # wait for capacity
                p.dst = nd
            if g.engines[p.dst].import_request(p.data):
                p.state = "imported"
                p.imported_tick = self.ticks
                if g.spans.enabled:
                    g.spans.event(
                        getattr(p.req, "_span_rid", f"r{p.src}.{p.src_rid}"),
                        "handoff-import", step=self.ticks,
                        replica=p.dst)
            else:
                self.import_retries += 1
        self.packets = [p for p in self.packets if p.state != "aborted"]

    def _commit(self) -> None:
        g = self.group
        done = []
        for p in self.packets:
            if p.state != "imported":
                continue
            if self.ticks < p.imported_tick + 1:
                continue
            # release is idempotent: a source death between import and
            # commit already force-expired the hold, and the request is
            # safely decoding on the destination either way
            p.hold.release()
            journal = g.engines[p.src].journal
            if journal is not None:
                journal.record_handoff(p.src_rid)
            p.state = "done"
            self.handoffs_completed += 1
            self.hold_ticks_total += self.ticks - p.export_tick
            if g.spans.enabled:
                srid = getattr(p.req, "_span_rid",
                               f"r{p.src}.{p.src_rid}")
                g.spans.event(srid, "handoff-commit", step=self.ticks,
                              replica=p.dst)
                g.spans.end(srid, "handoff", step=self.ticks,
                            dst=p.dst,
                            hold_ticks=self.ticks - p.export_tick)
            self.log.append({
                "src": p.src, "dst": p.dst, "pages": p.data["n_pages"],
                "export_tick": p.export_tick,
                "imported_tick": p.imported_tick,
                "commit_tick": self.ticks,
                "forced": int(p.hold.forced),
            })
            done.append(p)
        self.packets = [p for p in self.packets if p not in done]

    def _abort(self, p: HandoffPacket) -> None:
        p.hold.release()
        p.state = "aborted"
        self.handoffs_aborted += 1
        if self.group.spans.enabled:
            self.group.spans.end(
                getattr(p.req, "_span_rid", f"r{p.src}.{p.src_rid}"),
                "handoff", step=self.ticks, aborted=True)
        self.log.append({
            "src": p.src, "dst": p.dst, "pages": p.data["n_pages"],
            "export_tick": p.export_tick, "imported_tick": -1,
            "commit_tick": -1, "forced": int(p.hold.forced),
        })

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        return {
            "prefill_ids": list(self.prefill_ids),
            "decode_ids": list(self.decode_ids),
            "live_prefill": self.live_prefill(),
            "live_decode": self.live_decode(),
            "import_delay": self.import_delay,
            "ready_queue_depth": self.ready_queue_depth(),
            "inflight_handoffs": len(self.packets),
            "handoffs_started": self.handoffs_started,
            "handoffs_completed": self.handoffs_completed,
            "handoffs_aborted": self.handoffs_aborted,
            "import_retries": self.import_retries,
            "pages_handed_off": self.pages_handed_off,
            "hold_ticks_total": self.hold_ticks_total,
            "mean_hold_ticks": (
                self.hold_ticks_total / max(self.handoffs_completed, 1)
            ),
        }
