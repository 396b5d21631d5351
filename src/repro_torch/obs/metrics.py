"""Typed metrics registry: the observability plane's common bus.

Every plane (memory / serving / cluster / tiers / lifecycle) reports
through ad-hoc ``stats()`` dicts; this module gives them one typed
surface — :class:`Counter` / :class:`Gauge` / :class:`Histogram`
instruments keyed by ``(name, labels)`` in a :class:`Registry` — without
touching the hot paths: cheap always-on counters stay plain attributes
on their owning classes and are *published* into the registry when it is
collected (pull-style), while the expensive distribution metrics
(retire->reclaim latency, hold lifetimes, spans) are push-style and
**no-op when the registry is disabled** (``Registry(enabled=False)``
hands out shared null instruments whose methods return immediately).

Label conventions: ``policy`` (reclamation scheme), ``replica`` (engine
index), ``tier`` ("prefill"/"decode"), ``scheme``/``threads`` for the
host-plane benches.  Histograms use explicit step-scale buckets
(:data:`STEP_BUCKETS`): unit increments through 4 steps, then roughly
geometric — retire->reclaim latencies of the paper's schemes land in the
exact low buckets, so percentile reads are exact where the gate looks.

``STATS_KEY_ALIASES`` is the normalization map for the historical key
drift between ``ServingEngine.stats()``, ``ReplicaGroup.stats()`` and
the bench row schemas (``pool_scan_steps``+``ledger_scan_steps`` vs
``scan_steps`` vs ``bookkeeping_scans`` for the same quantity).  The
canonical name is the value; every surface now emits BOTH spellings via
:func:`apply_aliases`, and ``tests/test_obs.py`` asserts the map matches
what the surfaces actually emit.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, Iterable, List, Optional, Tuple

#: step-scale latency buckets (upper bounds, inclusive): exact unit
#: resolution where the paper's retire->reclaim latencies live (0-4
#: steps), ~geometric above.  Values beyond the last bound land in a
#: +Inf overflow bucket.
STEP_BUCKETS: Tuple[float, ...] = (
    0, 1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256,
    384, 512, 768, 1024,
)

#: legacy stats()/bench key -> canonical registry name for the SAME
#: quantity.  Surfaces emit both (apply_aliases); no key is renamed.
STATS_KEY_ALIASES: Dict[str, str] = {
    # total bookkeeping scans: engine emits the two components
    # (pool_scan_steps + ledger_scan_steps); the combined canonical
    # counter is ReplicaGroup's "scan_steps"; serving_bench rows called
    # the same sum "bookkeeping_scans".
    "bookkeeping_scans": "scan_steps",
    # engine spelling vs group/cluster spelling of pages awaiting
    # reclamation on the pool
    "pool_unreclaimed": "unreclaimed",
    # engine "pool_freed" vs bench "pages_recycled": pages returned to
    # the free lists since construction
    "pool_freed": "pages_freed",
    "pages_recycled": "pages_freed",
    # group spelling vs lifecycle/ledger spelling of forced expiries
    "holds_force_expired": "force_released",
}


def apply_aliases(stats: Dict[str, object]) -> Dict[str, object]:
    """Fill in the missing spelling for every aliased key, in place.

    Whichever spelling a surface computed natively wins; the other is
    mirrored so both old and new readers find their key."""
    for legacy, canonical in STATS_KEY_ALIASES.items():
        if legacy in stats and canonical not in stats:
            stats[canonical] = stats[legacy]
        elif canonical in stats and legacy not in stats:
            stats[legacy] = stats[canonical]
    return stats


def _label_key(labels: Dict[str, object]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """Monotone count.  ``inc`` only; never reset while registered."""

    __slots__ = ("name", "labels", "value")
    kind = "counter"

    def __init__(self, name: str, labels: Dict[str, str]) -> None:
        self.name = name
        self.labels = labels
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def snapshot(self) -> dict:
        return {"name": self.name, "kind": self.kind,
                "labels": dict(self.labels), "value": self.value}


class Gauge:
    """Point-in-time value (free pages, open holds, queue depth)."""

    __slots__ = ("name", "labels", "value")
    kind = "gauge"

    def __init__(self, name: str, labels: Dict[str, str]) -> None:
        self.name = name
        self.labels = labels
        self.value = 0

    def set(self, v) -> None:
        self.value = v

    def inc(self, n=1) -> None:
        self.value += n

    def dec(self, n=1) -> None:
        self.value -= n

    def snapshot(self) -> dict:
        return {"name": self.name, "kind": self.kind,
                "labels": dict(self.labels), "value": self.value}


class Histogram:
    """Explicit-bucket histogram with exact sum/count/min/max.

    ``buckets`` are inclusive upper bounds; observations beyond the last
    bound count in an implicit +Inf bucket.  ``percentile`` returns the
    upper bound of the bucket holding the q-th observation — exact for
    integer step latencies in the unit-resolution range of
    :data:`STEP_BUCKETS`, conservative (rounded up) above it."""

    __slots__ = ("name", "labels", "buckets", "counts", "overflow",
                 "sum", "count", "min", "max")
    kind = "histogram"

    def __init__(self, name: str, labels: Dict[str, str],
                 buckets: Optional[Iterable[float]] = None) -> None:
        self.name = name
        self.labels = labels
        self.buckets = tuple(buckets) if buckets is not None \
            else STEP_BUCKETS
        self.counts = [0] * len(self.buckets)
        self.overflow = 0
        self.sum = 0.0
        self.count = 0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v) -> None:
        i = bisect.bisect_left(self.buckets, v)
        if i < len(self.counts):
            self.counts[i] += 1
        else:
            self.overflow += 1
        self.sum += v
        self.count += 1
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def percentile(self, q: float) -> Optional[float]:
        """q in [0, 100]; bucket-upper-bound percentile (see class doc)."""
        if not self.count:
            return None
        rank = max(1, -(-self.count * q // 100))  # ceil, 1-based
        seen = 0
        for bound, c in zip(self.buckets, self.counts):
            seen += c
            if seen >= rank:
                return float(bound)
        return float(self.max)  # landed in the overflow bucket

    def snapshot(self) -> dict:
        return {
            "name": self.name, "kind": self.kind,
            "labels": dict(self.labels),
            "count": self.count, "sum": self.sum,
            "min": self.min, "max": self.max, "mean": self.mean,
            "p50": self.percentile(50), "p90": self.percentile(90),
            "p99": self.percentile(99),
            "buckets": list(self.buckets),
            "bucket_counts": list(self.counts) + [self.overflow],
        }


class _NullInstrument:
    """Shared no-op stand-in handed out by a disabled registry: every
    recording method returns immediately, reads come back empty."""

    __slots__ = ()
    name = "null"
    labels: Dict[str, str] = {}
    kind = "null"
    value = 0
    count = 0
    sum = 0.0
    min = None
    max = None
    mean = None

    def inc(self, n=1) -> None:
        pass

    def dec(self, n=1) -> None:
        pass

    def set(self, v) -> None:
        pass

    def observe(self, v) -> None:
        pass

    def percentile(self, q: float) -> None:
        return None

    def snapshot(self) -> dict:
        return {"name": "null", "kind": "null", "labels": {}}


NULL_INSTRUMENT = _NullInstrument()


class Registry:
    """Get-or-create instrument store, keyed by ``(name, labels)``.

    One registry per observability domain: an engine running standalone
    owns its own; a replica group creates ONE and
    threads it through every replica (replica-labeled instruments land
    side by side, so ``group.metrics()`` is just ``collect()``).
    Disabled registries hand out :data:`NULL_INSTRUMENT` — the zero-cost
    path the obs-overhead bench gate measures against."""

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self._lock = threading.Lock()
        self._instruments: Dict[tuple, object] = {}

    def _get(self, cls, name: str, labels: Dict[str, object],
             **kw) -> object:
        if not self.enabled:
            return NULL_INSTRUMENT
        key = (cls.kind, name, _label_key(labels))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = cls(name, {k: str(v) for k, v in labels.items()},
                           **kw)
                self._instruments[key] = inst
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str,
                  buckets: Optional[Iterable[float]] = None,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, buckets=buckets)

    def find(self, name: str, kind: Optional[str] = None,
             **labels) -> List[object]:
        """All registered instruments matching ``name`` and the given
        label subset (does not create)."""
        want = set(_label_key(labels))
        with self._lock:
            return [
                inst for (k, n, lk), inst in self._instruments.items()
                if n == name and (kind is None or k == kind)
                and want <= set(lk)
            ]

    def collect(self) -> List[dict]:
        """Snapshot every instrument (sorted by name then labels)."""
        with self._lock:
            insts = list(self._instruments.values())
        return sorted(
            (i.snapshot() for i in insts),
            key=lambda s: (s["name"], sorted(s["labels"].items())),
        )


_default_registry = Registry()


def get_registry() -> Registry:
    """The process-default registry (enabled); components that are not
    handed an explicit registry record here."""
    return _default_registry


def set_registry(reg: Registry) -> Registry:
    """Swap the process default (benches use this to isolate runs);
    returns the previous default."""
    global _default_registry
    prev, _default_registry = _default_registry, reg
    return prev
