"""Thread-safe span tracer exporting Chrome trace-event JSON.

One :class:`Tracer` records *spans* (context-managed, nested, timed with a
monotonic clock), *instant events*, and *counter samples* across any number
of threads, and exports them in the Chrome trace-event format - the JSON
``chrome://tracing`` and Perfetto (https://ui.perfetto.dev) load directly.
Each recording thread gets its own track (``tid``) lazily, so spans opened
on worker threads never interleave with the serve loop's track; named
tracks (``track=``) carry retroactive per-request lifecycle spans.

Design constraints (this is the serving hot path's instrumentation):

  * dependency-free - stdlib only, no torch import;
  * disabled-by-default at near-zero cost: :data:`NULL_TRACER` is a
    module-level singleton whose ``span()`` returns one shared no-op
    context manager - no allocation, no clock read, no lock;
  * thread-safe when enabled: event appends take one lock, span state
    lives on the span object itself (never shared).

Timebase: microseconds since the tracer's construction (``epoch``, a
``time.monotonic()`` stamp). Callers that timestamp on their own monotonic
clock convert with ``(t_monotonic - tracer.epoch)``.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional

PID = 1  # single-process serving: one constant chrome pid
_VALID_PH = {"X", "i", "M", "C"}


class _Span:
    """One in-flight span; emits a chrome 'X' (complete) event on exit."""

    __slots__ = ("_tr", "name", "args", "_t0", "_tid")

    def __init__(self, tr: "Tracer", name: str, args: Dict[str, Any]):
        self._tr = tr
        self.name = name
        self.args = args

    def __enter__(self) -> "_Span":
        self._tid = self._tr._thread_tid()
        self._t0 = self._tr._now_us()
        return self

    def __exit__(self, *exc) -> None:
        tr = self._tr
        t1 = tr._now_us()
        tr._emit({"name": self.name, "cat": "serve", "ph": "X",
                  "ts": self._t0, "dur": t1 - self._t0, "pid": PID,
                  "tid": self._tid, "args": self.args})


class _NullSpan:
    """Shared no-op span: entering/exiting records nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN = _NullSpan()


class Tracer:
    """Span/instant/counter recorder with Chrome trace-event export."""

    recording = True

    def __init__(self, process_name: str = "repro_torch.serve"):
        self.process_name = process_name
        self.epoch = time.monotonic()
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._tids: Dict[Any, int] = {}
        self._track_names: Dict[int, str] = {}

    # -- clocks & tracks -----------------------------------------------------

    def _now_us(self) -> float:
        return (time.monotonic() - self.epoch) * 1e6

    def _tid_for(self, key: Any, name: str) -> int:
        with self._lock:
            tid = self._tids.get(key)
            if tid is None:
                tid = len(self._tids)
                self._tids[key] = tid
                self._track_names[tid] = name
            return tid

    def _thread_tid(self) -> int:
        # keyed by (ident, name): the OS reuses idents once a thread exits,
        # and a recycled ident must not inherit the dead thread's track
        t = threading.current_thread()
        return self._tid_for(("thread", t.ident, t.name), t.name)

    def track(self, name: str) -> int:
        """tid of a named (non-thread) track, created on first use."""
        return self._tid_for(("track", name), name)

    def _emit(self, ev: dict) -> None:
        with self._lock:
            self._events.append(ev)

    # -- recording API -------------------------------------------------------

    def span(self, name: str, **args):
        """Context manager timing one phase on the calling thread's track."""
        return _Span(self, name, args)

    def instant(self, name: str, **args) -> None:
        self._emit({"name": name, "cat": "serve", "ph": "i", "s": "t",
                    "ts": self._now_us(), "pid": PID,
                    "tid": self._thread_tid(), "args": args})

    def counter(self, name: str, **series) -> None:
        """One sample of a chrome counter track (gauges over time)."""
        self._emit({"name": name, "cat": "serve", "ph": "C",
                    "ts": self._now_us(), "pid": PID,
                    "tid": self._thread_tid(), "args": series})

    def complete(self, name: str, t_begin_s: float, t_end_s: float,
                 track: Optional[str] = None, **args) -> None:
        """Retroactive span: explicit [begin, end] in tracer-relative
        SECONDS, optionally on a named track (per-request lifecycle spans
        are emitted at finish time, when their bounds are known)."""
        tid = self.track(track) if track is not None else self._thread_tid()
        self._emit({"name": name, "cat": "serve", "ph": "X",
                    "ts": t_begin_s * 1e6,
                    "dur": max(0.0, (t_end_s - t_begin_s) * 1e6),
                    "pid": PID, "tid": tid, "args": args})

    # -- export --------------------------------------------------------------

    @property
    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        """Drop recorded events (e.g. after a warm-up run) but keep the
        epoch and track assignments, so later spans stay comparable."""
        with self._lock:
            self._events.clear()

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON object (Perfetto/chrome://tracing)."""
        with self._lock:
            meta = [{"name": "process_name", "ph": "M", "pid": PID, "tid": 0,
                     "args": {"name": self.process_name}}]
            for tid, name in sorted(self._track_names.items()):
                meta.append({"name": "thread_name", "ph": "M", "pid": PID,
                             "tid": tid, "args": {"name": name}})
            return {"traceEvents": meta + list(self._events),
                    "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path


class NullTracer:
    """No-op tracer: every recording call is a constant-time no-op and
    ``span()`` hands back ONE shared context manager (no allocation)."""

    recording = False
    epoch = 0.0

    def span(self, name: str, **args) -> _NullSpan:
        return _NULL_SPAN

    def instant(self, name: str, **args) -> None:
        pass

    def counter(self, name: str, **series) -> None:
        pass

    def complete(self, name: str, t_begin_s: float, t_end_s: float,
                 track: Optional[str] = None, **args) -> None:
        pass

    @property
    def events(self) -> tuple:
        return ()

    def clear(self) -> None:
        pass

    def to_chrome(self) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}


NULL_TRACER = NullTracer()


# ---------------------------------------------------------------------------
# Schema validation (tests and chip_smoke.py validate emitted traces)
# ---------------------------------------------------------------------------


def validate_chrome_trace(obj: Any) -> int:
    """Validate a Chrome trace-event JSON object; returns the event count.

    The checked contract is what Perfetto/chrome://tracing require to load
    the file: a ``traceEvents`` list whose entries carry ``name``/``ph``/
    ``pid``/``tid``, complete ('X') events with numeric ``ts`` and
    non-negative ``dur``, instants with ``ts``, counters with a numeric
    ``args`` mapping. Raises ``ValueError`` on the first violation."""
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("trace: missing top-level 'traceEvents'")
    evs = obj["traceEvents"]
    if not isinstance(evs, list):
        raise ValueError("trace: 'traceEvents' is not a list")
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            raise ValueError(f"trace[{i}]: event is not an object")
        for key in ("name", "ph", "pid", "tid"):
            if key not in ev:
                raise ValueError(f"trace[{i}]: missing {key!r}")
        ph = ev["ph"]
        if ph not in _VALID_PH:
            raise ValueError(f"trace[{i}]: unknown phase {ph!r}")
        if ph in ("X", "i", "C"):
            if not isinstance(ev.get("ts"), (int, float)):
                raise ValueError(f"trace[{i}]: {ph!r} event needs numeric ts")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(
                    f"trace[{i}]: 'X' event needs non-negative dur, got {dur!r}")
        if ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args or not all(
                    isinstance(v, (int, float)) for v in args.values()):
                raise ValueError(
                    f"trace[{i}]: 'C' event needs a numeric args mapping")
    return len(evs)


def validate_chrome_trace_file(path: str) -> int:
    with open(path) as f:
        return validate_chrome_trace(json.load(f))


def main(argv: Optional[List[str]] = None) -> None:
    """``python -m repro_torch.obs.trace FILE...`` - validate emitted
    traces."""
    import sys

    paths = argv if argv is not None else sys.argv[1:]
    if not paths:
        raise SystemExit(
            "usage: python -m repro_torch.obs.trace TRACE.json ...")
    for p in paths:
        n = validate_chrome_trace_file(p)
        print(f"ok {p}: {n} trace events")


if __name__ == "__main__":
    main()
