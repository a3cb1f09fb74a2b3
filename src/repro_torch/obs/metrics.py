"""Labeled counter / gauge / histogram registry with JSON snapshots.

The serving stack's numeric telemetry: counters (monotone totals - tokens
emitted, requests finished), gauges (last-value samples - slot occupancy,
KV block-pool utilization) and histograms (distributions with percentile
snapshots - per-phase step timings, kernel dispatch wall time). Instruments
are memoized per ``(name, labels)`` so hot-path lookups after the first are
one dict get, and a :func:`MetricsRegistry.snapshot` serializes everything
to plain JSON (written next to the benchmark rows / ``--metrics-out``).

Like :mod:`repro_torch.obs.trace` this is dependency-free and disabled-by-default:
:data:`NULL_METRICS` hands back shared no-op instruments (zero allocation
after the singletons exist), so un-instrumented serving pays one attribute
call per would-be observation.
"""
from __future__ import annotations

import json
import threading
from typing import Any, Dict, List, Optional, Tuple


def metric_key(name: str, labels: Dict[str, Any]) -> str:
    """Stable flat key: ``name`` or ``name{a=1,b=x}`` (labels sorted)."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotone total."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-value sample."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)


class Histogram:
    """Exact-value histogram (serving runs observe thousands of samples,
    not millions - storing raw values keeps percentiles exact)."""

    __slots__ = ("values", "_lock")

    def __init__(self):
        self.values: List[float] = []
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self.values.append(float(v))

    @staticmethod
    def _percentile(sorted_vals: List[float], q: float) -> float:
        """Linear-interpolated percentile (numpy's default method), on an
        already-sorted list."""
        n = len(sorted_vals)
        if n == 1:
            return sorted_vals[0]
        pos = q / 100.0 * (n - 1)
        lo = int(pos)
        hi = min(lo + 1, n - 1)
        frac = pos - lo
        return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac

    def summary(self) -> dict:
        with self._lock:
            vals = sorted(self.values)
        if not vals:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "mean": 0.0, "p50": 0.0, "p90": 0.0, "p99": 0.0}
        total = sum(vals)
        return {
            "count": len(vals),
            "sum": total,
            "min": vals[0],
            "max": vals[-1],
            "mean": total / len(vals),
            "p50": self._percentile(vals, 50),
            "p90": self._percentile(vals, 90),
            "p99": self._percentile(vals, 99),
        }


class MetricsRegistry:
    """Instrument factory + JSON snapshot. Thread-safe."""

    recording = True

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def _get(self, store: dict, cls, name: str, labels: dict):
        key = metric_key(name, labels)
        with self._lock:
            inst = store.get(key)
            if inst is None:
                inst = store[key] = cls()
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(self._counters, Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(self._gauges, Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(self._histograms, Histogram, name, labels)

    def clear(self) -> None:
        """Drop every recorded value (e.g. after a warm-up run)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()

    def snapshot(self) -> dict:
        """Plain-JSON view of every instrument (the ``--metrics-out`` /
        ``ServeReport.to_json()['metrics']`` payload)."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._histograms)
        return {
            "counters": {k: c.value for k, c in sorted(counters.items())},
            "gauges": {k: g.value for k, g in sorted(gauges.items())},
            "histograms": {k: h.summary() for k, h in sorted(hists.items())},
        }

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1)
        return path


class _NullInstrument:
    """Shared no-op counter/gauge/histogram."""

    __slots__ = ()
    value = 0.0
    values: tuple = ()

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def summary(self) -> dict:
        return {"count": 0}


_NULL_INSTRUMENT = _NullInstrument()


class NullMetricsRegistry:
    """No-op registry: every factory returns ONE shared instrument."""

    recording = False

    def counter(self, name: str, **labels) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def gauge(self, name: str, **labels) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def histogram(self, name: str, **labels) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def clear(self) -> None:
        pass

    def snapshot(self) -> dict:
        return {}


NULL_METRICS = NullMetricsRegistry()


class ScopedMetrics:
    """A registry view that stamps fixed labels onto every instrument.

    A multi-tenant gateway hands each tenant's ``BatchServer``-style
    plumbing ``ScopedMetrics(registry, tenant="acme")``: every existing
    serve counter/gauge/histogram (slot occupancy, KV-pool utilization,
    prefix hits) then lands under ``name{tenant=acme,...}`` in the SHARED
    registry with no new sinks and no call-site changes. Call-site labels
    win on collision (a call that explicitly passes ``tenant=`` overrides
    the scope). Scoping a scope composes; scoping :data:`NULL_METRICS`
    stays a no-op."""

    def __init__(self, registry, **labels):
        self._registry = registry
        self._labels = labels

    @property
    def recording(self) -> bool:
        return self._registry.recording

    def counter(self, name: str, **labels):
        return self._registry.counter(name, **{**self._labels, **labels})

    def gauge(self, name: str, **labels):
        return self._registry.gauge(name, **{**self._labels, **labels})

    def histogram(self, name: str, **labels):
        return self._registry.histogram(name, **{**self._labels, **labels})

    def clear(self) -> None:
        self._registry.clear()

    def snapshot(self) -> dict:
        return self._registry.snapshot()


# ---------------------------------------------------------------------------
# Snapshot validation (tests and chip_smoke.py check --metrics-out files)
# ---------------------------------------------------------------------------


def validate_metrics_snapshot(obj: Any) -> int:
    """Validate a :func:`MetricsRegistry.snapshot` JSON object; returns the
    instrument count. Raises ``ValueError`` on shape violations."""
    if not isinstance(obj, dict):
        raise ValueError("metrics: snapshot is not an object")
    n = 0
    for section in ("counters", "gauges", "histograms"):
        if section not in obj:
            raise ValueError(f"metrics: missing section {section!r}")
        sec = obj[section]
        if not isinstance(sec, dict):
            raise ValueError(f"metrics: {section!r} is not a mapping")
        for k, v in sec.items():
            n += 1
            if section == "histograms":
                if not isinstance(v, dict) or "count" not in v:
                    raise ValueError(f"metrics: histogram {k!r} malformed")
                if v["count"] > 0 and not all(
                        key in v for key in ("sum", "mean", "p50", "p99")):
                    raise ValueError(
                        f"metrics: histogram {k!r} missing percentiles")
            elif not isinstance(v, (int, float)):
                raise ValueError(f"metrics: {section[:-1]} {k!r} non-numeric")
    return n


def main(argv: Optional[List[str]] = None) -> None:
    """``python -m repro_torch.obs.metrics FILE...`` - validate snapshots."""
    import sys

    paths = argv if argv is not None else sys.argv[1:]
    if not paths:
        raise SystemExit(
            "usage: python -m repro_torch.obs.metrics METRICS.json ...")
    for p in paths:
        with open(p) as f:
            n = validate_metrics_snapshot(json.load(f))
        print(f"ok {p}: {n} instruments")


if __name__ == "__main__":
    main()
