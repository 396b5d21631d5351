"""Exporters: Chrome-trace JSON, Prometheus text format, span JSONL.

``chrome_trace`` emits the Trace Event Format the ``chrome://tracing``
/ Perfetto UI loads: one complete ("X") event per closed span, one
instant ("i") event per point event, ``pid`` = replica, ``tid`` = the
request's stable span rid — so a cluster run renders as one row per
request with queue/prefill/handoff/decode blocks laid end to end.
``validate_chrome_trace`` is the schema check ``chip_smoke.py`` runs on
the disaggregated run's trace (and ``tests/test_torch_obs_export.py``
holds against the JAX package's exporters).
"""

from __future__ import annotations

import json
from typing import Dict, List, Union

from .metrics import Registry
from .spans import Span, SpanRecorder

_SpanList = Union[SpanRecorder, List[Span]]


def _spans(spans: _SpanList) -> List[Span]:
    return spans.spans if isinstance(spans, SpanRecorder) else list(spans)


def chrome_trace(spans: _SpanList,
                 registry: Registry = None) -> Dict[str, object]:
    """Trace Event Format dict (``json.dump`` it to a ``.json`` file).

    Timestamps are microseconds on the shared ``perf_counter`` axis,
    rebased so the earliest span starts at 0.  Registry counter/gauge
    snapshots ride along under ``metadata.metrics``."""
    evs = []
    all_spans = _spans(spans)
    t0 = min((s.start_ts for s in all_spans), default=0.0)
    for s in all_spans:
        base = {
            "name": s.name,
            "cat": "request",
            "pid": int(s.replica),
            "tid": str(s.rid),
            "ts": (s.start_ts - t0) * 1e6,
            "args": {"start_step": s.start_step, "end_step": s.end_step,
                     **s.meta},
        }
        if s.open:
            continue  # unterminated phase: not renderable as "X"
        if s.end_ts == s.start_ts and s.duration_steps == 0:
            evs.append({**base, "ph": "i", "s": "t"})
        else:
            evs.append({**base, "ph": "X",
                        "dur": (s.end_ts - s.start_ts) * 1e6})
    out: Dict[str, object] = {
        "traceEvents": evs,
        "displayTimeUnit": "ms",
    }
    if registry is not None:
        out["metadata"] = {"metrics": registry.collect()}
    return out


def validate_chrome_trace(obj: object) -> int:
    """Assert ``obj`` is schema-valid Trace Event Format; returns the
    event count.  Raises ``ValueError`` with the first violation."""
    if not isinstance(obj, dict):
        raise ValueError("trace must be a JSON object")
    evs = obj.get("traceEvents")
    if not isinstance(evs, list):
        raise ValueError("trace.traceEvents must be a list")
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            raise ValueError(f"traceEvents[{i}] is not an object")
        for key, types in (("name", str), ("ph", str),
                           ("ts", (int, float)), ("pid", int),
                           ("tid", (str, int))):
            if not isinstance(ev.get(key), types):
                raise ValueError(
                    f"traceEvents[{i}].{key} missing or mistyped: "
                    f"{ev.get(key)!r}")
        if ev["ph"] == "X" and not isinstance(ev.get("dur"),
                                              (int, float)):
            raise ValueError(f"traceEvents[{i}]: X event without dur")
        if ev["ph"] not in ("X", "i", "B", "E", "M"):
            raise ValueError(
                f"traceEvents[{i}]: unsupported phase {ev['ph']!r}")
        if ev["ts"] < 0 or (ev.get("dur") or 0) < 0:
            raise ValueError(f"traceEvents[{i}]: negative time")
    return len(evs)


def spans_jsonl(spans: _SpanList) -> str:
    """One JSON object per line, schema = ``Span.to_dict``."""
    return "\n".join(json.dumps(s.to_dict()) for s in _spans(spans))


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def prometheus_text(registry: Registry) -> str:
    """Prometheus exposition text format (counters as ``_total``,
    histograms as cumulative ``_bucket``/``_sum``/``_count``)."""
    lines: List[str] = []
    seen_types = set()
    for snap in registry.collect():
        name, kind, labels = snap["name"], snap["kind"], snap["labels"]
        if kind == "counter":
            full = f"{name}_total"
            if full not in seen_types:
                lines.append(f"# TYPE {full} counter")
                seen_types.add(full)
            lines.append(f"{full}{_fmt_labels(labels)} {snap['value']}")
        elif kind == "gauge":
            if name not in seen_types:
                lines.append(f"# TYPE {name} gauge")
                seen_types.add(name)
            lines.append(f"{name}{_fmt_labels(labels)} {snap['value']}")
        elif kind == "histogram":
            if name not in seen_types:
                lines.append(f"# TYPE {name} histogram")
                seen_types.add(name)
            cum = 0
            bounds = snap["buckets"]
            counts = snap["bucket_counts"]
            for bound, c in zip(bounds, counts):
                cum += c
                lab = _fmt_labels({**labels, "le": str(bound)})
                lines.append(f"{name}_bucket{lab} {cum}")
            cum += counts[len(bounds)]
            lab = _fmt_labels({**labels, "le": "+Inf"})
            lines.append(f"{name}_bucket{lab} {cum}")
            lines.append(
                f"{name}_sum{_fmt_labels(labels)} {snap['sum']}")
            lines.append(
                f"{name}_count{_fmt_labels(labels)} {snap['count']}")
    return "\n".join(lines) + "\n"
