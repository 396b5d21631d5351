"""Observability plane: typed metrics registry, retire->reclaim latency
tracing, per-request lifecycle spans and their exporters (Chrome trace,
Prometheus text, spans JSONL) — copies of the JAX package's
framework-free modules."""

from .export import (
    chrome_trace,
    prometheus_text,
    spans_jsonl,
    validate_chrome_trace,
)

from .metrics import (
    NULL_INSTRUMENT,
    STATS_KEY_ALIASES,
    STEP_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    Registry,
    apply_aliases,
    get_registry,
    set_registry,
)
from .reclaim_trace import ReclaimTracer
from .spans import PHASES, Span, SpanRecorder

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "ReclaimTracer",
    "Span", "SpanRecorder", "PHASES",
    "STATS_KEY_ALIASES", "STEP_BUCKETS", "NULL_INSTRUMENT",
    "apply_aliases", "get_registry", "set_registry",
    "chrome_trace", "prometheus_text", "spans_jsonl",
    "validate_chrome_trace",
]
