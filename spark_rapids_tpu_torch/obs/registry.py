"""Process-wide metrics registry: counters, gauges, time histograms.

Copied whole from ``spark_rapids_tpu/obs/registry.py``.

Unifies the engine's three previously-disjoint stat channels —
``exec/base.Metrics.extra`` (per-exec), ``shuffle/faults
.ShuffleFaultStats`` (per-process recovery counters), and the
scan-cache hit/miss counters — behind one namespace that per-query
views are carved out of.

Naming convention: ``<section>.<metric>`` where the section prefix
(``scan``, ``shuffle``, ``semaphore``, ``spill``, ``pyworker``)
groups the metric into its QueryProfile section.  Time-valued metrics
end in ``Ns`` and hold nanoseconds; byte-valued metrics end in
``Bytes``; report-time rendering converts to ``*_s`` explicitly
(the Metrics unit contract — see exec/base.py).

Per-query carving: the registry is process-global (one executor, many
concurrent queries), so a query's view is a **snapshot delta** —
``view = get_registry().view()`` at query start,
``view.delta()`` at the end.  Concurrent queries sharing the process
can see each other's increments in their deltas; that is localization,
not accounting (the ShuffleFaultStats stamping contract).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

# log-spaced millisecond boundaries for SLO bucket histograms (+Inf is
# implicit as the final bucket) — fixed process-wide so windowed deltas
# and Prometheus `_bucket` series are always comparable
DEFAULT_MS_BOUNDS: Tuple[float, ...] = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, 30000.0)


class Histogram:
    """count/sum/min/max summary of observed values (time histograms
    observe nanoseconds)."""

    __slots__ = ("count", "sum", "min", "max")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe_locked(self, v: float) -> None:
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def to_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max,
                "mean": (self.sum / self.count) if self.count else None}


class BucketHistogram:
    """Fixed-boundary bucketed histogram (Prometheus `histogram` type:
    cumulative ``_bucket{le=...}`` series render from it, and windowed
    p50/p95/p99 interpolate from bucket-count deltas).  Boundaries are
    fixed at creation — observations land in the first bucket whose
    upper bound is >= the value; the final slot is +Inf."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: Sequence[float] = DEFAULT_MS_BOUNDS):
        self.bounds: Tuple[float, ...] = tuple(float(b) for b in bounds)
        self.counts: List[int] = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe_locked(self, v: float) -> None:
        self.count += 1
        self.sum += v
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def to_dict(self) -> Dict[str, Any]:
        return {"bounds": list(self.bounds),
                "counts": list(self.counts),
                "sum": self.sum, "count": self.count}


def bucket_quantile(bounds: Sequence[float], counts: Sequence[int],
                    q: float) -> Optional[float]:
    """Quantile estimate from bucket counts (linear interpolation
    inside the containing bucket, the Prometheus histogram_quantile
    rule); None with no observations.  The +Inf bucket clamps to its
    lower bound — an estimate, never an invention."""
    total = sum(counts)
    if total <= 0:
        return None
    rank = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        if c <= 0:
            continue
        if cum + c >= rank:
            hi = bounds[i] if i < len(bounds) else None
            lo = bounds[i - 1] if i > 0 else 0.0
            if hi is None:
                return float(lo)
            frac = (rank - cum) / c
            return float(lo + (hi - lo) * frac)
        cum += c
    return float(bounds[-1]) if bounds else None


class MetricsRegistry:
    """Thread-safe registry; one per process via :func:`get_registry`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, Histogram] = {}
        self._bhists: Dict[str, BucketHistogram] = {}

    # -- counters ----------------------------------------------------------
    def inc(self, name: str, n: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def inc_many(self, *pairs) -> None:
        """Several counter increments under ONE lock acquisition — for
        hot paths that bump multiple counters per event (the device
        semaphore)."""
        with self._lock:
            for name, n in pairs:
                self._counters[name] = self._counters.get(name, 0) + n

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0)

    # -- gauges ------------------------------------------------------------
    def set_gauge(self, name: str, v: float) -> None:
        with self._lock:
            self._gauges[name] = v

    def gauge_max(self, name: str, v: float) -> None:
        """High-water-mark gauge: keeps the max ever set."""
        with self._lock:
            old = self._gauges.get(name)
            if old is None or v > old:
                self._gauges[name] = v

    def gauge(self, name: str) -> Optional[float]:
        with self._lock:
            return self._gauges.get(name)

    # -- histograms --------------------------------------------------------
    def observe(self, name: str, v: float) -> None:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            h.observe_locked(v)

    def observe_bucket(self, name: str, v: float,
                       bounds: Optional[Sequence[float]] = None) -> None:
        """Observe into a fixed-boundary bucketed histogram (created on
        first observation; ``bounds`` applies only then)."""
        with self._lock:
            h = self._bhists.get(name)
            if h is None:
                h = self._bhists[name] = BucketHistogram(
                    bounds if bounds is not None else DEFAULT_MS_BOUNDS)
            h.observe_locked(v)

    # -- snapshots / views -------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {k: h.to_dict()
                               for k, h in self._hists.items()},
                "bucket_histograms": {k: h.to_dict()
                                      for k, h in self._bhists.items()},
            }

    def view(self) -> "RegistryView":
        return RegistryView(self)


class RegistryView:
    """Snapshot-delta carve of the process registry for one query."""

    def __init__(self, registry: MetricsRegistry):
        self._registry = registry
        self._base = registry.snapshot()

    def delta(self) -> Dict[str, Any]:
        """Counters/histograms as *deltas* since the view was taken
        (zero-delta entries dropped); gauges as their CURRENT values
        (high-water marks are process-lifetime by design)."""
        cur = self._registry.snapshot()
        base = self._base
        counters = {}
        for k, v in cur["counters"].items():
            d = v - base["counters"].get(k, 0)
            if d:
                counters[k] = d
        hists = {}
        for k, h in cur["histograms"].items():
            b = base["histograms"].get(k, {"count": 0, "sum": 0.0})
            dc = h["count"] - b["count"]
            if dc:
                hists[k] = {"count": dc, "sum": h["sum"] - b["sum"],
                            "mean": (h["sum"] - b["sum"]) / dc}
        bhists = {}
        for k, h in cur.get("bucket_histograms", {}).items():
            b = base.get("bucket_histograms", {}).get(k)
            dc = h["count"] - (b["count"] if b else 0)
            if dc:
                counts = list(h["counts"]) if b is None else \
                    [c - p for c, p in zip(h["counts"], b["counts"])]
                bhists[k] = {"bounds": h["bounds"], "counts": counts,
                             "count": dc,
                             "sum": h["sum"] - (b["sum"] if b else 0.0)}
        return {"counters": counters, "gauges": dict(cur["gauges"]),
                "histograms": hists, "bucket_histograms": bhists}


_REGISTRY: Optional[MetricsRegistry] = None
_REGISTRY_LOCK = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-wide registry (executor-singleton idiom)."""
    global _REGISTRY
    with _REGISTRY_LOCK:
        if _REGISTRY is None:
            _REGISTRY = MetricsRegistry()
        return _REGISTRY


def reset_registry() -> None:
    """Test hook: fresh registry (counters are process-lifetime
    otherwise)."""
    global _REGISTRY
    with _REGISTRY_LOCK:
        _REGISTRY = MetricsRegistry()
