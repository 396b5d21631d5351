"""Per-request lifecycle spans: submit -> admit -> chunk(i) ->
first-token -> handoff(export/import/commit) -> finish.

A :class:`SpanRecorder` collects a flat list of :class:`Span` records
(phases with begin/end, plus instantaneous events), each carrying BOTH
a wall-clock timestamp (``perf_counter``, for Chrome-trace export) and
the recorder's step clock (engine steps for single-engine phases,
cluster steps for handoffs) — so a disaggregated request's TTFT
decomposes into queue / prefill / handoff / decode with step
granularity.

Requests migrate across replicas (tier handoff re-submits under a new
rid), so spans key on a *stable* request identity: the engine stamps
``req._span_rid`` at first submit and every later phase reuses it.
The recorder is shared group-wide (one per ReplicaGroup, one per
standalone engine), so the export/import halves of a handoff land in
the same trace row.

Disabled recorders (built from a disabled registry) drop everything at
the method guard — same zero-cost discipline as the tracer.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

#: canonical phase order for TTFT decomposition
PHASES = ("queue", "prefill", "handoff", "decode")


@dataclass
class Span:
    rid: str                      # stable request identity
    name: str                     # phase or event name
    replica: int
    start_step: int
    start_ts: float               # perf_counter seconds
    end_step: Optional[int] = None
    end_ts: Optional[float] = None
    meta: Dict[str, object] = field(default_factory=dict)

    @property
    def open(self) -> bool:
        return self.end_ts is None

    @property
    def duration_steps(self) -> Optional[int]:
        if self.end_step is None:
            return None
        return self.end_step - self.start_step

    @property
    def duration_s(self) -> Optional[float]:
        if self.end_ts is None:
            return None
        return self.end_ts - self.start_ts

    def to_dict(self) -> dict:
        return {
            "rid": self.rid, "name": self.name, "replica": self.replica,
            "start_step": self.start_step, "end_step": self.end_step,
            "start_ts": self.start_ts, "end_ts": self.end_ts,
            "duration_steps": self.duration_steps,
            "duration_s": self.duration_s, "meta": dict(self.meta),
        }


class SpanRecorder:
    """Flat span store with (rid, name)-keyed open phases."""

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self.spans: List[Span] = []
        self._open: Dict[tuple, Span] = {}

    # -- recording ------------------------------------------------------
    def begin(self, rid: str, name: str, *, step: int, replica: int = 0,
              **meta) -> None:
        if not self.enabled:
            return
        key = (rid, name)
        if key in self._open:      # re-entered phase (e.g. re-admit)
            self.end(rid, name, step=step)
        span = Span(rid, name, replica, step, time.perf_counter(),
                    meta=meta)
        self._open[key] = span
        self.spans.append(span)

    def end(self, rid: str, name: str, *, step: int, **meta) -> None:
        if not self.enabled:
            return
        span = self._open.pop((rid, name), None)
        if span is None:
            return
        span.end_step = step
        span.end_ts = time.perf_counter()
        span.meta.update(meta)

    def event(self, rid: str, name: str, *, step: int, replica: int = 0,
              **meta) -> None:
        """Instantaneous point event (chunk staged, token emitted...)."""
        if not self.enabled:
            return
        ts = time.perf_counter()
        self.spans.append(
            Span(rid, name, replica, step, ts, step, ts, meta))

    def end_open(self, rid: str, *, step: int, **meta) -> None:
        """Close every open phase of ``rid`` (finish / branch kill)."""
        if not self.enabled:
            return
        for (r, name) in [k for k in self._open if k[0] == rid]:
            self.end(rid, name, step=step, **meta)

    # -- reads ----------------------------------------------------------
    def for_request(self, rid: str) -> List[Span]:
        return [s for s in self.spans if s.rid == rid]

    def merge(self, other: "SpanRecorder") -> None:
        self.spans.extend(other.spans)

    def ttft_breakdown(self, rid: str) -> Dict[str, float]:
        """Wall-clock seconds per phase up to the first token, from this
        request's closed phase spans.  A phase absent from the request
        (no handoff, say) reports 0.0."""
        out = {p: 0.0 for p in PHASES}
        for s in self.for_request(rid):
            if s.name in out and s.duration_s is not None:
                out[s.name] += s.duration_s
        return out

    def to_dicts(self) -> List[dict]:
        return [s.to_dict() for s in self.spans]
