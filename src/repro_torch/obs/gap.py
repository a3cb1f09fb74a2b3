"""Sim-vs-measured gap tracking: confront the model with the stopwatch.

CIMinus argues sparse-CIM systems live or die by faithful workload modeling
and CIM-Tuner closes the loop between the mapping search and measured
hardware. This module is that loop for this repo: the analytic model
(``core.perf_model``) and the event-driven simulator (``repro_torch.sched``)
predict where a step's cycles go (reload / compute / feature-map / ctrl);
the tracer and metrics registry measure where its wall time actually went.
The comparator turns both into one regression-trackable number plus a
per-phase share table for a bench row.

Reading the ratio: ``sim_vs_measured = measured_s / predicted_s``. The
prediction is CIM cycles at ``hw.cim_freq`` on the modeled MARS fabric;
the measurement is host wall time on whatever device served the run (the
GPU, or the plain PyTorch versions on the CPU), so the ratio is NOT
expected to be ~1 - it
is expected to be FINITE, POSITIVE and STABLE. A drifting ratio means
either the runtime regressed or the model lies; that drift, not the
absolute value, is the tracked signal. Per-phase SHARES, by contrast, are
directly comparable: if the simulator says reload dominates and the trace
says all-gather does, the model is missing the collective - exactly the
7x sharded-row diagnosis this exists for.

Heavy imports (perf_model, sched) are deferred into the functions so the
obs core (trace/metrics) stays dependency-free.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence


# Floor for fenced wall-clock samples: a coarse monotonic clock can return
# an exact 0.0 for a sub-resolution dispatch; clamping (instead of dividing)
# keeps gap rows finite without hiding that the sample was degenerate.
MIN_MEASURED_S = 1e-9


def _shares(d: Dict[str, float]) -> Dict[str, float]:
    """Normalize phase totals to shares, dropping non-finite entries (an
    inf phase would turn every share into NaN via inf/inf)."""
    clean = {k: v for k, v in d.items()
             if isinstance(v, (int, float)) and math.isfinite(v)}
    total = sum(v for v in clean.values() if v > 0)
    if total <= 0:
        return {k: 0.0 for k in clean}
    return {k: round(max(v, 0.0) / total, 4) for k, v in clean.items()}


def clamp_measured(samples: Sequence[float]) -> float:
    """Min over finite positive fenced samples, floored at
    :data:`MIN_MEASURED_S`. Raises ``ValueError`` when every sample is
    non-finite or negative (an empty/broken measurement table) - the loud
    failure belongs here, not as an inf ratio in a bench row."""
    usable = [float(s) for s in samples if math.isfinite(float(s)) and s >= 0]
    if not usable:
        raise ValueError(
            f"gap: no usable measured samples in {list(samples)!r} "
            "(empty phase table or non-finite timings)")
    return max(min(usable), MIN_MEASURED_S)


def gap_report(predicted_s: float, measured_s: float,
               predicted_phases: Optional[Dict[str, float]] = None,
               measured_phases: Optional[Dict[str, float]] = None,
               **extra) -> dict:
    """The first-class gap metric: measured wall time over simulated time.

    ``predicted_phases`` / ``measured_phases`` are per-phase totals in any
    consistent unit (cycles and seconds respectively are fine) - only
    their normalized SHARES are reported, which is what makes them
    comparable across the cycle/wall-clock divide."""
    if predicted_s <= 0 or not math.isfinite(predicted_s):
        raise ValueError(f"gap: predicted_s must be finite > 0, got {predicted_s}")
    if measured_s <= 0 or not math.isfinite(measured_s):
        raise ValueError(f"gap: measured_s must be finite > 0, got {measured_s}")
    out = {
        "predicted_s": predicted_s,
        "measured_s": measured_s,
        "sim_vs_measured": round(measured_s / predicted_s, 4),
        **extra,
    }
    if predicted_phases:
        out["predicted_phase_shares"] = _shares(predicted_phases)
    if measured_phases:
        out["measured_phase_shares"] = _shares(measured_phases)
    return out


def measured_phase_shares(snapshot: dict,
                          metric: str = "serve_phase_s") -> Dict[str, float]:
    """Per-phase wall-time totals out of a ``MetricsRegistry.snapshot()``:
    every ``serve_phase_s{phase=X}`` histogram's sum, keyed by X."""
    out: Dict[str, float] = {}
    for key, h in snapshot.get("histograms", {}).items():
        if not key.startswith(metric + "{") or not isinstance(h, dict):
            continue
        labels = key[len(metric) + 1:-1]
        phase = dict(part.split("=", 1) for part in labels.split(",")
                     if "=" in part).get("phase")
        if phase is None:
            continue
        try:
            total = float(h.get("sum", 0.0))
        except (TypeError, ValueError):
            continue
        if math.isfinite(total):
            out[phase] = out.get(phase, 0.0) + total
    return out


# ---------------------------------------------------------------------------
# Predictions: decode-step cost from the simulator / analytic model
# ---------------------------------------------------------------------------


def predicted_serve_step(cfg, sparsity_gs: float, seq_len: int = 1,
                         hw=None, n_devices: int = 1) -> dict:
    """Simulated cost of ONE decode step (all CIM projections at
    ``seq_len`` rows) on the modeled fabric, with the event-driven
    simulator's per-phase cycle breakdown.

    ``sparsity_gs`` is the zero-group-set fraction of the served packing
    (the pruning target is the honest proxy when the per-layer profile is
    not tracked). With ``n_devices > 1`` the macro-mesh sharded path is
    modeled: every column-sharded projection ends in a ring all-gather of
    its output activations (``hw.allgather_cycles``), reported as a
    ``collective`` phase - without it a sharded row's gap would blame the
    kernels for the interconnect. Returns
    predicted cycles, seconds at ``hw.cim_freq`` and the
    compute/reload/fm/stall[/collective] phase cycles."""
    from ..core.perf_model import DEFAULT_HW
    from ..sched import lm_graph, simulate

    hw = hw or DEFAULT_HW
    graph = lm_graph(cfg, seq_len=seq_len, sparsity_gs=sparsity_gs)
    sim = simulate(graph, hw=hw, w_bits=cfg.w_bits, a_bits=cfg.a_bits,
                   keep_events=False)
    phases = {
        "compute": sum(l.compute_cycles for l in sim.layers),
        "reload": sum(l.reload_cycles for l in sim.layers),
        "fm": sum(l.fm_cycles for l in sim.layers),
        "stall": sum(l.stall_cycles for l in sim.layers),
    }
    cycles = sim.cycles
    if n_devices > 1:
        # fp32 output activations of each sharded projection go around the
        # ring once; the kernels shard every projection on the macro axis
        collective = sum(
            hw.allgather_cycles(l.out_h * l.out_w * l.cout * 4, n_devices)
            for l in graph.layers())
        phases["collective"] = collective
        cycles += collective
    return {"cycles": cycles, "predicted_s": cycles / hw.cim_freq,
            "phases": phases}


def serve_gap(cfg, measured_step_s: float, sparsity_gs: float,
              measured_phases: Optional[Dict[str, float]] = None,
              hw=None, n_devices: int = 1) -> dict:
    """A serve bench's gap row: measured decode-step wall time (fenced, from
    the instrumented server) against the simulator's predicted one-token
    step on the modeled fabric (all-gather included when sharded)."""
    measured_step_s = clamp_measured([measured_step_s])
    pred = predicted_serve_step(cfg, sparsity_gs, seq_len=1, hw=hw,
                                n_devices=n_devices)
    return gap_report(
        pred["predicted_s"], measured_step_s,
        predicted_phases=pred["phases"], measured_phases=measured_phases,
        predicted_cycles=round(pred["cycles"], 1),
        sparsity_gs=sparsity_gs, n_devices=n_devices,
    )


def kernel_gap(m: int, k: int, n: int, tile, sparsity: float,
               w_bits: int = 8, a_bits: int = 8, repeats: int = 3,
               hw=None, device=None) -> dict:
    """A sched bench's gap row: ONE block-sparse kernel dispatch on
    ``device`` (default: the GPU), fenced and timed through the
    :mod:`repro_torch.kernels.timing` hook, against the analytic model's
    cycles for the same (m, k) @ (k, n) matmul at the same tile and
    sparsity. On a CUDA device the kernel launches or raises; the plain
    version is timed only on the CPU, when asked for.

    This is the CIM-Tuner loop in miniature: the mapping search trusts
    ``perf_model``; this row records what the searched tile's kernel
    actually costs on the current device so the constants can be re-fit
    and regressions in either side show up as ratio drift."""
    import numpy as np
    import torch

    from ..core import perf_model as PM
    from ..core.sparsity import prune_mask_2d
    from ..device import resolve_device
    from ..kernels import ops
    from ..kernels.cim_bsr_matmul import bsr_matmul
    from ..kernels.timing import DispatchTimer
    import dataclasses as _dc

    dev = resolve_device(device)
    hw = hw or PM.DEFAULT_HW
    bk, bn = int(tile[0]), int(tile[1])
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)
                         * 0.05)
    if sparsity > 0:
        w = w * prune_mask_2d(w, bk, bn, sparsity)
    p = ops.pack_for_kernel(w, bits=w_bits, bk=bk, bn=bn, device=dev)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)
                         ).to(dev)
    args = (x, p["blocks"], p["scales"], p["row_idx"], p["nnz"])
    timer = DispatchTimer(enabled=True)
    timer.timed("bsr_matmul", (m, k, n), (bk, bn), bsr_matmul, *args)
    timer.clear()  # the first dispatch builds the kernel: excluded
    for _ in range(repeats):
        timer.timed("bsr_matmul", (m, k, n), (bk, bn), bsr_matmul, *args)
    measured_s = clamp_measured([r.seconds for r in timer.records])

    # the analytic model sees the matmul as a 1x1 conv with m output pixels
    hw_t = _dc.replace(hw, group=bk, alpha=bn)
    layer = PM.ConvLayer(1, 1, k, n, 1, m, sparsity)
    perf = PM.evaluate_network([layer], w_bits, a_bits, hw=hw_t)[0]
    phases = PM.layer_phase_cycles(layer, w_bits, a_bits, hw=hw_t)
    return gap_report(
        perf.cycles_mars / hw.cim_freq, measured_s,
        predicted_phases=phases, predicted_cycles=round(perf.cycles_mars, 1),
        shape=[m, k, n], tile=[bk, bn], sparsity=sparsity,
        backend=timer.records[-1].backend,
    )
