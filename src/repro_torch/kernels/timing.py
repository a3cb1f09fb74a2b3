"""Fenced kernel-dispatch timing hook.

CUDA launches are asynchronous: a wall clock around a kernel wrapper
measures the enqueue, not the device work. Call the kernel (or a whole
decode step) through :meth:`DispatchTimer.timed` instead: the elapsed time
spans the call PLUS ``torch.cuda.synchronize`` on the output's device,
labeled with ``(name, shape, tile, backend)`` so per-(shape, tile, backend)
costs are separable in the report.

A disabled timer (the default ``TIMER``) forwards the call untouched: no
fence, no clock, no allocation - tracing off must not serialize the
stream.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

import torch


@dataclasses.dataclass(frozen=True)
class DispatchRecord:
    """One fenced kernel call."""

    name: str
    shape: Optional[tuple]  # activation/problem shape, caller-defined
    tile: Optional[tuple]  # (bk, bn) packing tile, None for dense dispatch
    backend: str
    seconds: float

    @property
    def key(self) -> tuple:
        return (self.name, self.shape, self.tile, self.backend)


def _dim_label(dims: Optional[tuple]) -> str:
    """``(16, 16)`` -> ``"16x16"``; None -> ``"none"`` (metric label form)."""
    if dims is None:
        return "none"
    return "x".join(str(int(d)) for d in dims)


def _first_tensor(out) -> Optional[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, (tuple, list)):
        for o in out:
            t = _first_tensor(o)
            if t is not None:
                return t
    if isinstance(out, dict):
        return _first_tensor(list(out.values()))
    return None


def _backend(out) -> str:
    """``"cuda"`` when the call's output lives on a GPU, else ``"cpu"``."""
    t = _first_tensor(out)
    return "cuda" if t is not None and t.is_cuda else "cpu"


def _fence(out) -> None:
    """Wait for the work that produced ``out``: a device synchronize on the
    output's GPU (the CPU's ops have finished when they return)."""
    t = _first_tensor(out)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


class DispatchTimer:
    """Thread-safe fenced wall-time recorder for kernel dispatches.

    When constructed with a recording ``repro_torch.obs.metrics`` registry,
    every record is also observed into the ``kernel_dispatch_s`` histogram
    labeled (kernel, shape, tile, backend), so the ServeReport metrics
    snapshot carries per-dispatch p50/p99 without a side table."""

    def __init__(self, enabled: bool = True, metrics=None):
        self.enabled = enabled
        self.metrics = metrics
        self._lock = threading.Lock()
        self.records: List[DispatchRecord] = []

    def record(self, name: str, seconds: float, shape=None, tile=None,
               backend: Optional[str] = None) -> None:
        rec = DispatchRecord(
            name, tuple(shape) if shape is not None else None,
            tuple(tile) if tile is not None else None,
            backend if backend is not None else (
                "cuda" if torch.cuda.is_available() else "cpu"),
            float(seconds))
        with self._lock:
            self.records.append(rec)
        if self.metrics is not None and getattr(self.metrics, "recording",
                                                False):
            # label key is ``kernel`` (not ``name``): the registry's
            # instrument name is the positional ``name`` argument
            self.metrics.histogram(
                "kernel_dispatch_s", kernel=rec.name,
                shape=_dim_label(rec.shape), tile=_dim_label(rec.tile),
                backend=rec.backend).observe(rec.seconds)

    def timed(self, name: str, shape, tile, fn, *args, **kw):
        """Call ``fn(*args, **kw)``; when enabled, fence the output's device
        and record the wall time under ``(name, shape, tile, backend)``.
        Disabled: a plain call."""
        if not self.enabled:
            return fn(*args, **kw)
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        _fence(out)
        self.record(name, time.perf_counter() - t0, shape=shape, tile=tile,
                    backend=_backend(out))
        return out

    def clear(self) -> None:
        with self._lock:
            self.records.clear()

    def summary(self) -> List[dict]:
        """Per-(name, shape, tile, backend) aggregate rows, JSON-ready."""
        with self._lock:
            recs = list(self.records)
        groups: Dict[tuple, List[float]] = {}
        for r in recs:
            groups.setdefault(r.key, []).append(r.seconds)
        rows = []
        for (name, shape, tile, backend), secs in sorted(
                groups.items(), key=lambda kv: repr(kv[0])):
            secs = sorted(secs)
            rows.append({
                "name": name,
                "shape": list(shape) if shape is not None else None,
                "tile": list(tile) if tile is not None else None,
                "backend": backend,
                "calls": len(secs),
                "total_s": round(sum(secs), 6),
                "min_ms": round(secs[0] * 1e3, 4),
                "p50_ms": round(secs[len(secs) // 2] * 1e3, 4),
                "max_ms": round(secs[-1] * 1e3, 4),
            })
        return rows


# module-level default, DISABLED: importing this hook never slows a caller
# that does not opt in
TIMER = DispatchTimer(enabled=False)
