"""The port's trace exporters against the JAX package's
(``repro/obs/export.py``): the Chrome trace, the spans JSONL and the
Prometheus text of one explicitly built span list and registry are
equal to the JAX exporters' output on the same spans and instruments,
and ``validate_chrome_trace`` counts and refuses as the JAX validator
does.  A disaggregated port group's own spans export to a valid trace
with one row per request across the prefill and decode replicas.
"""

import json

import numpy as np
import pytest
import torch

from repro.obs import Registry as JaxRegistry
from repro.obs import Span as JaxSpan
from repro.obs import SpanRecorder as JaxRecorder
from repro.obs import chrome_trace as jax_chrome_trace
from repro.obs import prometheus_text as jax_prometheus_text
from repro.obs import spans_jsonl as jax_spans_jsonl
from repro.obs import validate_chrome_trace as jax_validate
from repro_torch.cluster import ReplicaGroup
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.models import Model
from repro_torch.obs import (
    Registry,
    Span,
    SpanRecorder,
    chrome_trace,
    prometheus_text,
    spans_jsonl,
    validate_chrome_trace,
)

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

#: (rid, name, replica, start_step, start_ts, end_step, end_ts, meta)
SPAN_LISTS = {
    "one-request": [
        ("r0.0", "queue", 0, 0, 10.0, 1, 10.002, {"prompt_len": 40}),
        ("r0.0", "prefill", 0, 1, 10.002, 3, 10.031, {}),
        ("r0.0", "chunk", 0, 1, 10.002, 1, 10.002,
         {"index": 0, "start": 0, "end": 40}),
        ("r0.0", "first-token", 0, 3, 10.031, 3, 10.031, {}),
        ("r0.0", "decode", 0, 3, 10.031, 7, 10.090, {}),
        ("r0.0", "finish", 0, 7, 10.090, 7, 10.090, {"tokens": 4}),
    ],
    "handoff": [
        ("r0.1", "queue", 0, 0, 5.5, 0, 5.5, {"prompt_len": 300}),
        ("r0.1", "prefill", 0, 0, 5.5, 3, 5.61, {}),
        ("r0.1", "handoff", 0, 3, 5.61, 6, 5.72,
         {"src": 0, "pages": 3, "dst": 2, "hold_ticks": 3}),
        ("r0.1", "handoff-export", 0, 3, 5.61, 3, 5.61, {}),
        ("r0.1", "handoff-import", 2, 5, 5.69, 5, 5.69, {}),
        ("r0.1", "decode", 2, 5, 5.69, 9, 5.80, {"imported": True}),
        ("r1.0", "queue", 1, 0, 5.4, 2, 5.52, {"prompt_len": 12}),
        ("r1.0", "prefill", 1, 2, 5.52, 2, 5.53, {}),
    ],
    "open-spans": [
        ("r0.0", "queue", 0, 0, 2.0, 1, 2.5, {}),
        ("r0.0", "prefill", 0, 1, 2.5, None, None, {}),
        ("r0.2", "branch-kill", 0, 4, 3.0, 4, 3.0, {"replica": 0}),
        ("r0.3", "decode", 3, 4, 3.25, None, None, {"imported": True}),
    ],
}


def _spans(cls, rows):
    return [cls(rid, name, replica, s0, t0, s1, t1, dict(meta))
            for rid, name, replica, s0, t0, s1, t1, meta in rows]


def _registry(cls, kinds):
    reg = cls()
    if "counter" in kinds:
        reg.counter("retires", policy="stamp-it").inc(3)
        reg.counter("retires", policy="hazard").inc(7)
        reg.counter("holds_forced", replica=2).inc()
    if "gauge" in kinds:
        reg.gauge("free_pages", replica=0).set(5)
        reg.gauge("free_pages", replica=1).set(12)
        reg.gauge("cluster_steps").set(41)
    if "histogram" in kinds:
        h = reg.histogram("reclaim_latency_steps", policy="stamp-it")
        for v in (0, 1, 1, 2, 3, 5, 8, 13, 200):
            h.observe(v)
    return reg


REGISTRIES = {"counters": ("counter",), "gauges": ("gauge",),
              "histogram": ("histogram",),
              "all": ("counter", "gauge", "histogram")}


@pytest.mark.parametrize("spans", sorted(SPAN_LISTS))
def test_chrome_trace_matches_jax(spans):
    rows = SPAN_LISTS[spans]
    got = chrome_trace(_spans(Span, rows))
    want = jax_chrome_trace(_spans(JaxSpan, rows))
    assert got == want
    n = validate_chrome_trace(got)
    assert n == jax_validate(want)
    assert n == sum(1 for r in rows if r[6] is not None)  # open: skipped


@pytest.mark.parametrize("spans", sorted(SPAN_LISTS))
def test_spans_jsonl_matches_jax(spans):
    rows = SPAN_LISTS[spans]
    got = spans_jsonl(_spans(Span, rows))
    assert got == jax_spans_jsonl(_spans(JaxSpan, rows))
    assert [json.loads(line)["name"] for line in got.splitlines()] == [
        r[1] for r in rows]


@pytest.mark.parametrize("registry", sorted(REGISTRIES))
def test_prometheus_text_matches_jax(registry):
    kinds = REGISTRIES[registry]
    got = prometheus_text(_registry(Registry, kinds))
    assert got == jax_prometheus_text(_registry(JaxRegistry, kinds))
    assert got.endswith("\n")
    if "histogram" in kinds:
        assert ('reclaim_latency_steps_bucket{le="+Inf",policy="stamp-it"}'
                ' 9') in got


@pytest.mark.parametrize("registry", sorted(REGISTRIES))
def test_chrome_trace_metadata_matches_jax(registry):
    kinds = REGISTRIES[registry]
    rows = SPAN_LISTS["handoff"]
    got = chrome_trace(_spans(Span, rows), registry=_registry(Registry,
                                                              kinds))
    want = jax_chrome_trace(_spans(JaxSpan, rows),
                            registry=_registry(JaxRegistry, kinds))
    assert got == want
    assert got["metadata"]["metrics"]


def test_recorder_input_matches_jax():
    """A SpanRecorder exports as its span list does (timestamps taken
    from the recorder, so each package's own list is the reference)."""
    for rec_cls, export in ((SpanRecorder, chrome_trace),
                            (JaxRecorder, jax_chrome_trace)):
        rec = rec_cls()
        rec.begin("r0.0", "queue", step=0)
        rec.end("r0.0", "queue", step=1)
        rec.event("r0.0", "first-token", step=1)
        rec.begin("r0.0", "decode", step=1)  # left open: skipped
        assert export(rec) == export(rec.spans)
        assert [e["ph"] for e in export(rec)["traceEvents"]] == ["X", "i"]


MALFORMED = [
    ["not an object"],
    {"no": "traceEvents"},
    {"traceEvents": "x"},
    {"traceEvents": [3]},
    {"traceEvents": [{"name": "x", "ph": "X", "ts": 0, "pid": 0,
                      "tid": "a"}]},  # X without dur
    {"traceEvents": [{"name": "x", "ph": "Q", "ts": 0, "pid": 0,
                      "tid": "a"}]},  # unsupported phase
    {"traceEvents": [{"name": "x", "ph": "i", "ts": -1.0, "pid": 0,
                      "tid": 1}]},  # negative time
    {"traceEvents": [{"name": "x", "ph": "i", "ts": 0, "pid": "0",
                      "tid": 1}]},  # pid mistyped
]


@pytest.mark.parametrize("i", range(len(MALFORMED)))
def test_validate_refuses_as_jax(i):
    obj = MALFORMED[i]
    with pytest.raises(ValueError) as got:
        validate_chrome_trace(obj)
    with pytest.raises(ValueError) as want:
        jax_validate(obj)
    assert str(got.value) == str(want.value)


def test_tiered_group_spans_export():
    """The port's own spans: one trace row per request across the
    prefill and decode replicas, a valid trace, the group's metrics in
    the Prometheus text."""
    model = Model(smoke_config(ARCHS["qwen2-0.5b"]), device="cpu")
    group = ReplicaGroup(model, prefill_replicas=1, decode_replicas=1,
                         router="least-loaded", max_slots=2, max_seq=512,
                         extra_pages_per_slot=4)
    rs = np.random.RandomState(4)
    reqs = [group.submit(list(rs.randint(1, 500, n)), max_new_tokens=3)
            for n in (100, 180)]
    group.run_until_done()
    group.drain()
    trace = chrome_trace(group.spans, registry=group.obs)
    assert validate_chrome_trace(trace) > 0
    rows = {e["tid"] for e in trace["traceEvents"]}
    assert rows == {r._span_rid for r in reqs}
    for r in reqs:
        names = {sp.name for sp in group.spans.for_request(r._span_rid)}
        assert {"queue", "prefill", "handoff", "handoff-commit",
                "decode", "finish"} <= names
        assert group.spans.ttft_breakdown(r._span_rid)["handoff"] > 0
        # the import renumbered the request; its span row did not move
        assert r.replica == 1
    pids = {e["pid"] for e in trace["traceEvents"]}
    assert pids == {0, 1}
    assert group.metrics()
    text = prometheus_text(group.obs)
    assert "# TYPE cluster_steps gauge" in text
    assert 'handoffs_in{policy="stamp-it",replica="1"} 2' in text
