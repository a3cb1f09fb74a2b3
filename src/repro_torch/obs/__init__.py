"""repro_torch.obs - observability for the serving stack.

Two dependency-free cores and the gap tracker:

  * :mod:`trace` - thread-safe span tracer (context-manager spans, instant
    events, counter samples, per-thread tracks) exporting Chrome
    trace-event JSON loadable in Perfetto / ``chrome://tracing``;
  * :mod:`metrics` - labeled counter / gauge / histogram registry with
    JSON snapshots;
  * :mod:`gap` - measured per-phase timings confronted with
    ``core.perf_model`` / the ``repro_torch.sched`` simulator's
    predictions, as the ``sim_vs_measured`` ratio (its heavy imports are
    deferred into its functions).

Both are disabled by default at near-zero cost: :data:`NULL_TRACER` and
:data:`NULL_METRICS` are shared no-op singletons, so an un-instrumented
``BatchServer`` pays only a few attribute calls per step.
``repro_torch.kernels.timing`` is the companion fenced-dispatch hook for
per-(shape, tile, backend) wall times.
"""
from __future__ import annotations

import time

from . import gap, metrics, trace  # noqa: F401
from .metrics import (MetricsRegistry, NullMetricsRegistry,  # noqa: F401
                      NULL_METRICS, ScopedMetrics,
                      validate_metrics_snapshot)
from .trace import (NullTracer, NULL_TRACER, Tracer,  # noqa: F401
                    validate_chrome_trace, validate_chrome_trace_file)


class _PhaseScope:
    """Span + phase-latency histogram in one context manager."""

    __slots__ = ("_tracer", "_metrics", "_name", "_args", "_span", "_t0")

    def __init__(self, tracer, metrics_reg, name, args):
        self._tracer = tracer
        self._metrics = metrics_reg
        self._name = name
        self._args = args

    def __enter__(self) -> "_PhaseScope":
        self._t0 = time.perf_counter()
        self._span = self._tracer.span(self._name, **self._args)
        self._span.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._span.__exit__(*exc)
        self._metrics.histogram("serve_phase_s", phase=self._name).observe(
            time.perf_counter() - self._t0)


def phase_scope(tracer, metrics_reg, name: str, **args):
    """One instrumented phase: a tracer span plus a
    ``serve_phase_s{phase=name}`` histogram observation. With both sinks
    disabled this returns the shared no-op span."""
    if not (tracer.recording or metrics_reg.recording):
        return trace._NULL_SPAN
    return _PhaseScope(tracer, metrics_reg, name, args)


__all__ = [
    "MetricsRegistry", "NullMetricsRegistry", "NULL_METRICS",
    "ScopedMetrics", "NullTracer", "NULL_TRACER", "Tracer", "gap", "metrics",
    "phase_scope", "trace", "validate_chrome_trace",
    "validate_chrome_trace_file", "validate_metrics_snapshot",
]
