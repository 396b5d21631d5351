"""Request journal: the replay log behind shared-fate fault tolerance.

A replica's in-flight requests die with it — unless enough is recorded
*outside* the replica to re-admit them elsewhere.  The journal is that
record: one entry per OPEN request holding the prompt, the sampling
parameters it was admitted under, the request's ``sample_key`` (the
journaled RNG state), and every token the host has observed (appended
at pipeline-lagged completion, i.e. only tokens that actually reached
the client); finished entries prune, so the journal stays O(in-flight
requests).  It deliberately records nothing device-resident: KV pages,
in-flight samples and the first-token buffer are all lost on a crash,
exactly as they would be on a real machine.

Replay semantics (:mod:`repro_torch.cluster.lifecycle`):

  * **greedy** requests (temperature 0) resume *token-for-token*: the
    survivor is given ``prompt + emitted`` as its prompt — the already-
    served tokens are teacher-forced, never re-sampled — and generates
    only the remaining budget.  Greedy decoding is a deterministic
    function of (params, token prefix), so the stitched stream
    ``emitted + replayed`` is bit-identical to a no-fault run.
  * **sampled** requests resume the same way whenever the journal holds
    their ``sample_key``: the device derives the uniform that samples
    the token at sequence index ``pos`` as
    ``counter_uniform(sample_key, pos)`` — a pure function of (key,
    position), never of which replica runs the step — so a survivor
    teacher-forcing ``prompt + emitted`` picks the sample stream up at
    exactly the next index, bit-identically.  Only keyless sampled
    requests (no journaled RNG state) restart from scratch.

The engine calls the three ``record_*`` hooks (duck-typed — the serving
plane takes any object with these methods, keeping the layering: the
cluster plane knows the engine, never the reverse).  The tier plane
adds ``record_handoff``: once a mid-request KV handoff COMMITS, the
destination replica's journal owns the request (the engine's
``import_request`` re-records it there), so the source entry prunes —
a source death after commit must not replay a request that is alive
and decoding on the destination.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass
class JournalEntry:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    eos_id: Optional[int]
    temperature: float
    top_p: float
    #: host-observed tokens, in emission order (never device-resident)
    emitted: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    #: journaled RNG state: the per-request counter-sampling key.  With
    #: it, a sampled request resumes token-for-token on any replica;
    #: None (keyless) falls back to restart-from-scratch.
    sample_key: Optional[int] = None

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0

    @property
    def resumable(self) -> bool:
        """True when the emitted prefix is reproducible on a survivor:
        greedy (deterministic in the token prefix) or sampled with a
        journaled key (counter sampling is deterministic in (key, pos))."""
        return self.greedy or self.sample_key is not None

    def remaining(self) -> int:
        return max(self.max_new_tokens - len(self.emitted), 0)

    def resume_prompt(self) -> List[int]:
        """The token prefix a survivor teacher-forces through on a
        resume: original prompt plus everything already served."""
        return list(self.prompt) + list(self.emitted)


class RequestJournal:
    """Per-replica journal of every OPEN request on that replica.

    Bounded by construction: a finished request has nothing left to
    replay, so ``record_finish`` prunes its entry — the journal's size
    is O(in-flight requests), never O(requests ever served)."""

    def __init__(self, replica_id: int) -> None:
        self.replica_id = replica_id
        self.entries: Dict[int, JournalEntry] = {}
        self.tokens_recorded = 0
        self.finished_total = 0
        self.handed_off_total = 0

    def __len__(self) -> int:
        return len(self.entries)

    # -- engine hooks (serving plane calls these, duck-typed) -----------
    def record_submit(self, req, temperature: float,
                      top_p: float) -> None:
        self.entries[req.rid] = JournalEntry(
            req.rid, list(req.prompt), req.max_new_tokens, req.eos_id,
            temperature, top_p,
            emitted=list(req.generated or []),
            sample_key=req.sample_key,
        )

    def record_token(self, req, tok: int) -> None:
        e = self.entries.get(req.rid)
        if e is not None:
            e.emitted.append(int(tok))
            self.tokens_recorded += 1

    def record_finish(self, req) -> None:
        e = self.entries.pop(req.rid, None)
        if e is not None:
            e.done = True
            self.finished_total += 1

    # -- tier plane ------------------------------------------------------
    def record_handoff(self, rid: int) -> None:
        """Handoff COMMITTED: ownership moved to the destination
        replica's journal, so the source entry prunes — exactly like a
        finish, but counted separately.  Keyed by the SOURCE-side rid
        (the request object's rid was reassigned at import)."""
        e = self.entries.pop(rid, None)
        if e is not None:
            self.handed_off_total += 1

    # -- lifecycle plane -------------------------------------------------
    def open_entries(self) -> List[JournalEntry]:
        """Entries the replica died owing.  Finished entries were
        pruned at record_finish, so everything still here is open."""
        return list(self.entries.values())
