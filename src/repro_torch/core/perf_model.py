"""Analytic MARS accelerator model (paper §III, §V.A - Table I, Figs. 10-11).

The container has no 28 nm silicon, so - like the paper itself, whose Table I
numbers are "estimated value[s]" referring to the macro measurements of [18]
- MARS system performance is modeled analytically from the architecture:

  * 4 CIM cores x 2 macros x 8 partitions; a core computes one group-set
    (16 inputs x alpha=16 kernels) per CIM cycle -> 256 MACs/core/cycle.
  * 4-bit-native macro ([18]): 8-bit weights cost 2 cell-columns
    (w_pass=2), 8-bit activations cost 2 input passes (a_pass=2).
  * CIM @ 100 MHz, top-level system @ 400 MHz, shunter gives each core one
    FM-SRAM access per CIM cycle.
  * Zero group-sets are skipped in compute, storage and IFM fetch (§III.B).
  * Macro capacity 2 x 64 Kb/core: layers larger than residency reload.

Cycle model per conv layer (P = output pixels):
  compute = P * NNZ_groupsets * a_pass * w_pass / cores
  fm      = (ifm_reads + ofm_writes) / cores   (1 access/core/CIM-cycle)
  reload  = stored_bits / (RELOAD_BITS_PER_CYCLE * cores)
  cycles  = max(compute, fm) + reload + CTRL_OVERHEAD * P

The dense baseline (Fig. 10's "baseline") uses the same pipeline with
NNZ = all group-sets and full weight storage.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .mapping import CORES, GROUP, MACRO_BITS, MACROS_PER_CORE

ALPHA = 16
CIM_FREQ = 100e6
SYS_FREQ = 400e6
RELOAD_BITS_PER_CYCLE = 256  # weight-SRAM -> macro write port, per core
CTRL_OVERHEAD = 0.25  # controller/APW cycles per output pixel (calibrated)
# Extra-pass cost factor: the 2nd 4-bit pass (8-bit weights/activations)
# reuses resident weights + SAS addresses, so only the MAC phase repeats.
# 0.35 calibrated against Table I's w8a4 vs w8a8 FPS ratio (1.32x).
PASS_OVERLAP = 0.35
MACRO_POWER_W = 1.9e-3  # [18]: 1.9~2.7 mW @ 100 MHz; we take the low end
N_MACROS = CORES * MACROS_PER_CORE


@dataclasses.dataclass(frozen=True)
class HardwareConfig:
    """The MARS fabric as data - shared hardware description for this
    analytic model and the event-driven simulator (``repro_torch.sched``)."""

    cores: int = CORES
    macros_per_core: int = MACROS_PER_CORE
    partitions: int = 8  # per macro ([18])
    macro_bits: int = MACRO_BITS
    group: int = GROUP  # weights per weight-group (input direction)
    alpha: int = ALPHA  # kernels per group-set (output direction)
    cim_freq: float = CIM_FREQ
    sys_freq: float = SYS_FREQ
    reload_bits_per_cycle: int = RELOAD_BITS_PER_CYCLE
    ctrl_overhead: float = CTRL_OVERHEAD
    pass_overlap: float = PASS_OVERLAP
    macro_power_w: float = MACRO_POWER_W
    # Macro-mesh interconnect (serving path): ring all-gather at every
    # column-sharded projection boundary. Calibration knobs, not silicon:
    # bytes one device moves per CIM cycle and the per-hop launch latency.
    interconnect_bytes_per_cycle: float = 64.0
    collective_latency_cycles: float = 400.0

    @property
    def n_macros(self) -> int:
        return self.cores * self.macros_per_core

    def pass_factor(self, w_bits: int, a_bits: int) -> float:
        """Cycle multiplier for multi-pass >4-bit operands on the 4-bit macro."""
        a_pass = max(1, -(-a_bits // 4))
        w_pass = max(1, -(-w_bits // 4))
        return (1 + self.pass_overlap * (a_pass - 1)) * (
            1 + self.pass_overlap * (w_pass - 1))

    def capacity_groupsets(self, w_bits: int = 8, group: int | None = None,
                           alpha: int | None = None, macros: int = 1) -> int:
        """Group-sets resident in ``macros`` macro buffers of one core."""
        g = self.group if group is None else group
        a = self.alpha if alpha is None else alpha
        return max(1, (self.macro_bits * macros) // (g * a * w_bits))

    def reload_cycles(self, groupsets: int, w_bits: int = 8,
                      group: int | None = None, alpha: int | None = None) -> float:
        """Cycles for one core's write port to fill ``groupsets`` group-sets."""
        g = self.group if group is None else group
        a = self.alpha if alpha is None else alpha
        return groupsets * g * a * w_bits / self.reload_bits_per_cycle

    def allgather_cycles(self, n_bytes: float, n_devices: int) -> float:
        """Ring all-gather cost: each device ships its 1/n shard around the
        ring in (n-1) hops, each hop paying launch latency + wire time."""
        if n_devices <= 1 or n_bytes <= 0:
            return 0.0
        chunk = n_bytes / n_devices
        per_hop = chunk / self.interconnect_bytes_per_cycle
        return (n_devices - 1) * (per_hop + self.collective_latency_cycles)


DEFAULT_HW = HardwareConfig()


@dataclasses.dataclass(frozen=True)
class ConvLayer:
    """One conv layer: kernel (kh, kw), cin -> cout, output h x w."""

    kh: int
    kw: int
    cin: int
    cout: int
    out_h: int
    out_w: int
    sparsity_gs: float = 0.0  # fraction of group-sets that are all-zero

    @property
    def out_pixels(self) -> int:
        return self.out_h * self.out_w

    @property
    def groupsets(self) -> int:
        return self.groupsets_for(GROUP, ALPHA)

    @property
    def nnz_groupsets(self) -> int:
        return self.nnz_for(GROUP, ALPHA)

    def groupsets_for(self, group: int, alpha: int) -> int:
        """Group-set count under an alternative (group x alpha) tiling."""
        wg_per_kernel = self.kh * self.kw * -(-self.cin // group)
        return wg_per_kernel * -(-self.cout // alpha)

    def zero_fraction_for(self, group: int, alpha: int) -> float:
        """Zero-group-set fraction rescaled from the (GROUP x ALPHA) profile.

        ``sparsity_gs`` is measured at the paper's 16x16 tiles; a coarser
        tile is zero only when all covered 16x16 tiles are, a finer one is
        zero at least as often - modeled as p**(area ratio) (independent
        tiles), the same scaling CIM-Tuner-style searches assume.
        """
        if self.sparsity_gs <= 0.0:
            return 0.0
        ratio = (group * alpha) / float(GROUP * ALPHA)
        return min(1.0, float(self.sparsity_gs) ** ratio)

    def nnz_for(self, group: int, alpha: int) -> int:
        total = self.groupsets_for(group, alpha)
        keep = 1.0 - self.zero_fraction_for(group, alpha)
        return max(1, int(round(total * keep)))

    @property
    def macs(self) -> int:
        return self.out_pixels * self.kh * self.kw * self.cin * self.cout


@dataclasses.dataclass
class LayerPerf:
    name: str
    cycles_dense: float
    cycles_mars: float
    fm_access_dense: float
    fm_access_mars: float

    @property
    def speedup(self) -> float:
        return self.cycles_dense / max(self.cycles_mars, 1e-9)

    @property
    def fm_reduction(self) -> float:
        return self.fm_access_dense / max(self.fm_access_mars, 1e-9)


def _phase_cycles(l: ConvLayer, nnz: int, total_gs: int, w_bits: int,
                  a_bits: int, sparse_fetch: bool,
                  hw: HardwareConfig = DEFAULT_HW) -> dict:
    """Per-phase cycle components of one layer - the model's side of the
    sim-vs-measured comparison (``repro_torch.obs.gap``)."""
    pass_f = hw.pass_factor(w_bits, a_bits)
    compute = l.out_pixels * nnz * pass_f / hw.cores
    # IFM: one group-wide fetch per (pixel, surviving group-set); OFM: one
    # partial-sum write per (pixel, kernel-group) - zero rows still skipped
    # only on the sparse path.
    fetch_gs = nnz if sparse_fetch else total_gs
    ifm = l.out_pixels * fetch_gs
    ofm = l.out_pixels * -(-l.cout // hw.alpha)
    fm_cycles = (ifm + ofm) / hw.cores
    stored_bits = fetch_gs * hw.group * hw.alpha * w_bits
    reload = stored_bits / (hw.reload_bits_per_cycle * hw.cores)
    ctrl = hw.ctrl_overhead * l.out_pixels
    return {"compute": compute, "fm": fm_cycles, "reload": reload,
            "ctrl": ctrl, "fm_access": ifm + ofm,
            "cycles": max(compute, fm_cycles) + reload + ctrl}


def _layer_cycles(l: ConvLayer, nnz: int, total_gs: int, w_bits: int,
                  a_bits: int, sparse_fetch: bool,
                  hw: HardwareConfig = DEFAULT_HW) -> tuple[float, float]:
    p = _phase_cycles(l, nnz, total_gs, w_bits, a_bits, sparse_fetch, hw=hw)
    return p["cycles"], p["fm_access"]


def layer_phase_cycles(l: ConvLayer, w_bits: int = 8, a_bits: int = 4,
                       sparse: bool = True,
                       hw: HardwareConfig = DEFAULT_HW) -> dict:
    """{compute, fm, reload, ctrl} cycles of one layer under ``hw``'s
    tiling (MARS sparse path by default, ``sparse=False`` for the dense
    baseline)."""
    total = l.groupsets_for(hw.group, hw.alpha)
    nnz = l.nnz_for(hw.group, hw.alpha) if sparse else total
    p = _phase_cycles(l, nnz, total, w_bits, a_bits, sparse_fetch=sparse,
                      hw=hw)
    return {k: p[k] for k in ("compute", "fm", "reload", "ctrl")}


def network_phase_breakdown(layers: Sequence[ConvLayer], w_bits: int = 8,
                            a_bits: int = 4, sparse: bool = True,
                            hw: HardwareConfig = DEFAULT_HW) -> dict:
    """Network-total per-phase cycles - what the measured per-phase wall
    times from the tracer are compared against (``repro_torch.obs.gap``)."""
    out = {"compute": 0.0, "fm": 0.0, "reload": 0.0, "ctrl": 0.0}
    for l in layers:
        for k, v in layer_phase_cycles(l, w_bits, a_bits, sparse, hw).items():
            out[k] += v
    return out


def evaluate_network(
    layers: Sequence[ConvLayer], w_bits: int = 8, a_bits: int = 4,
    hw: HardwareConfig = DEFAULT_HW,
) -> List[LayerPerf]:
    out = []
    for i, l in enumerate(layers):
        # group-set counts follow the hw tiling, so a HardwareConfig with a
        # non-default (group, alpha) stays internally consistent
        total = l.groupsets_for(hw.group, hw.alpha)
        nnz = l.nnz_for(hw.group, hw.alpha)
        cd, fmd = _layer_cycles(l, total, total, w_bits, a_bits,
                                sparse_fetch=False, hw=hw)
        cm, fmm = _layer_cycles(l, nnz, total, w_bits, a_bits,
                                sparse_fetch=True, hw=hw)
        out.append(LayerPerf(f"L{i}_{l.kh}x{l.kw}x{l.cin}x{l.cout}", cd, cm, fmd, fmm))
    return out


@dataclasses.dataclass
class NetworkPerf:
    fps: float
    fps_dense: float
    speedup: float
    avg_gops: float  # dense-equivalent ops/s (sparse-accelerator convention)
    macro_tops_w: float
    peak_macro_tops_w: float
    layers: List[LayerPerf]


def summarize(layers: Sequence[ConvLayer], w_bits: int = 8, a_bits: int = 4,
              hw: HardwareConfig = DEFAULT_HW) -> NetworkPerf:
    perf = evaluate_network(layers, w_bits, a_bits, hw=hw)
    cyc_m = sum(p.cycles_mars for p in perf)
    cyc_d = sum(p.cycles_dense for p in perf)
    fps = hw.cim_freq / cyc_m
    fps_dense = hw.cim_freq / cyc_d
    total_ops = 2.0 * sum(l.macs for l in layers)  # MAC = 2 OPS
    avg_gops = fps * total_ops / 1e9
    # Macro-level efficiency: ops attributed to macros / macro power. The
    # paper reports dense-equivalent ops (skipped zeros count), as is
    # standard for sparse accelerators.
    macro_tops_w = (fps * total_ops) / (hw.n_macros * hw.macro_power_w) / 1e12
    pass_f = hw.pass_factor(w_bits, a_bits)
    peak_dense_ops = 2 * hw.group * hw.alpha * hw.cores * hw.cim_freq / pass_f
    best_density = min(max(1e-3, 1.0 - l.sparsity_gs) for l in layers)
    peak = peak_dense_ops / best_density / (hw.n_macros * hw.macro_power_w) / 1e12
    return NetworkPerf(fps, fps_dense, cyc_d / cyc_m, avg_gops, macro_tops_w, peak, perf)


# ---------------------------------------------------------------------------
# Cost-constant re-fit: least-squares calibration against measured timings
# ---------------------------------------------------------------------------

# Per-phase cost coefficients the re-fit solves for, in order: seconds per
# MAC-path cycle (the max(compute, fm) critical path), per reload cycle, and
# per control cycle.
REFIT_COEFFS = ("mac", "reload", "ctrl")


def phase_features(phases: Dict[str, float]) -> List[float]:
    """Cycle-count feature vector of one measured sample, matching
    REFIT_COEFFS: the model says seconds = features . theta."""
    compute = float(phases.get("compute", 0.0))
    fm = float(phases.get("fm", 0.0))
    return [max(compute, fm), float(phases.get("reload", 0.0)),
            float(phases.get("ctrl", 0.0))]


@dataclasses.dataclass(frozen=True)
class RefitResult:
    """Outcome of ``fit_cycle_constants``.

    ``hw`` is the input HardwareConfig with cim_freq, reload_bits_per_cycle
    and ctrl_overhead re-derived so the analytic model reproduces the fitted
    seconds-per-cycle coefficients exactly; ``residual`` is the relative RMS
    error of the fit over its own samples - the post-refit gap floor."""

    hw: HardwareConfig
    seconds_per_cycle: Dict[str, float]
    residual: float
    n_samples: int

    def predict_seconds(self, phases: Dict[str, float]) -> float:
        f = phase_features(phases)
        return sum(c * t for c, t in zip(f, (
            self.seconds_per_cycle[k] for k in REFIT_COEFFS)))

    def to_json(self) -> dict:
        return {"seconds_per_cycle": dict(self.seconds_per_cycle),
                "residual": self.residual, "n_samples": self.n_samples,
                "cim_freq": self.hw.cim_freq,
                "reload_bits_per_cycle": self.hw.reload_bits_per_cycle,
                "ctrl_overhead": self.hw.ctrl_overhead}


def _uniform_scale_fit(A: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Degenerate fallback: one scale factor applied to every phase."""
    denom = float(A.sum())
    scale = float(y.sum()) / denom if denom > 0 else 1.0 / CIM_FREQ
    return np.full(A.shape[1], max(scale, 1e-18))


def fit_cycle_constants(samples: Sequence[Tuple[Dict[str, float], float]],
                        hw: HardwareConfig = DEFAULT_HW) -> RefitResult:
    """Least-squares re-fit of the cycle constants from measured timings.

    ``samples`` pairs a ``layer_phase_cycles``-style phase dict with the
    measured wall-clock seconds of that workload on the machine at hand.
    Solves ``seconds = max(compute, fm) * t_mac + reload * t_reload +
    ctrl * t_ctrl`` for nonnegative thetas; with fewer than 3 usable
    samples, or a singular/degenerate system, falls back to a single
    uniform scale factor so the result is always well-defined."""
    rows = [(phase_features(p), float(m)) for p, m in samples
            if np.isfinite(float(m)) and float(m) > 0
            and all(np.isfinite(v) and v >= 0 for v in phase_features(p))]
    if not rows:
        raise ValueError("fit_cycle_constants: no finite positive samples")
    A = np.asarray([f for f, _ in rows], dtype=np.float64)
    y = np.asarray([m for _, m in rows], dtype=np.float64)

    theta = None
    if len(rows) >= 3:
        active = [j for j in range(A.shape[1]) if A[:, j].max() > 0]
        # Nonnegative fit by iterative clamping: drop any coefficient the
        # unconstrained solve drives negative and re-solve the rest.
        while active:
            sol, *_ = np.linalg.lstsq(A[:, active], y, rcond=None)
            neg = [active[i] for i, c in enumerate(sol) if c < 0]
            if not neg:
                theta = np.zeros(A.shape[1])
                for i, j in enumerate(active):
                    theta[j] = sol[i]
                break
            active = [j for j in active if j not in neg]
    if theta is None or theta[0] <= 0:
        theta = _uniform_scale_fit(A, y)

    pred = A @ theta
    residual = float(np.sqrt(np.mean((pred - y) ** 2)) / max(y.mean(), 1e-18))
    t_mac, t_reload, t_ctrl = (float(t) for t in theta)
    # Fold the coefficients back into a HardwareConfig: cycles/cim_freq must
    # equal cycles * theta per phase, so frequency absorbs t_mac and the
    # other two constants are rescaled relative to it.
    hw_fit = dataclasses.replace(
        hw,
        cim_freq=1.0 / t_mac,
        reload_bits_per_cycle=(hw.reload_bits_per_cycle * t_mac / t_reload
                               if t_reload > 0 else hw.reload_bits_per_cycle),
        ctrl_overhead=hw.ctrl_overhead * t_ctrl / t_mac,
    )
    coeffs = dict(zip(REFIT_COEFFS, (t_mac, t_reload, t_ctrl)))
    return RefitResult(hw_fit, coeffs, residual, len(rows))


# ---------------------------------------------------------------------------
# Speculative decoding: two-tier (draft + target) cost model
# ---------------------------------------------------------------------------


def expected_spec_tokens(k: int, accept: float) -> float:
    """Expected tokens emitted per draft-k-verify round.

    Under per-token-independent acceptance probability ``accept``, the
    round emits the longest accepted draft prefix plus the target's
    correction token: E = sum_{t=0..k} accept^t = (1-a^{k+1})/(1-a)."""
    a = min(max(accept, 0.0), 1.0)
    if a >= 1.0:
        return float(k + 1)
    return (1.0 - a ** (k + 1)) / (1.0 - a)


def speculative_summary(c_draft_step: float, c_verify: float, k: int,
                        accept: float,
                        draft_steps: int | None = None) -> dict:
    """Throughput model for one speculative round on the CIM fabric.

    ``c_draft_step`` is the simulated cycle cost of ONE draft-tier decode
    step (its reload + compute at the draft sparsity, or the kept-sublayer
    fraction of a target step for the layer-skip family); ``c_verify`` the
    cost of one (k+1)-token target pass. ``draft_steps`` is how many draft
    steps a round runs: the reprune default is k+1 (k proposals + the
    trailing KV-fill step that keeps its separate draft cache in lockstep);
    the layer-skip family passes k - it has no draft cache to fill.
    ``accept`` is the modeled per-token acceptance probability - a
    calibration input, NOT simulated; the serve benchmark reports the
    measured rate to calibrate against (``sched.search.SpecCalibration``)."""
    if draft_steps is None:
        draft_steps = k + 1
    tokens = expected_spec_tokens(k, accept)
    cycles = draft_steps * c_draft_step + c_verify
    return {
        "k": k,
        "accept": round(min(max(accept, 0.0), 1.0), 4),
        "draft_steps": draft_steps,
        "tokens_per_round": round(tokens, 4),
        "cycles_per_round": round(cycles, 1),
        "tokens_per_kcycle": round(1e3 * tokens / max(cycles, 1e-9), 5),
    }


# ---------------------------------------------------------------------------
# Paper networks on CIFAR (32x32): layer tables for Table I / Figs. 10-11
# ---------------------------------------------------------------------------


def vgg16_cifar_layers(sparsity_per_layer: Sequence[float] | None = None) -> List[ConvLayer]:
    cfg = [  # (cin, cout, out_hw) - 2x2 maxpool after blocks
        (3, 64, 32), (64, 64, 32),
        (64, 128, 16), (128, 128, 16),
        (128, 256, 8), (256, 256, 8), (256, 256, 8),
        (256, 512, 4), (512, 512, 4), (512, 512, 4),
        (512, 512, 2), (512, 512, 2), (512, 512, 2),
    ]
    if sparsity_per_layer is None:
        # Table IV group-set compression rates measured by the paper
        sparsity_per_layer = [0.05, 0.05, 0.50, 0.566, 0.616, 0.932, 0.932,
                              0.978, 0.987, 0.987, 0.987, 0.987, 0.987]
    return [
        ConvLayer(3, 3, ci, co, hw, hw, s)
        for (ci, co, hw), s in zip(cfg, sparsity_per_layer)
    ]


def resnet18_cifar_layers(sparsity_per_layer: Sequence[float] | None = None) -> List[ConvLayer]:
    cfg = [(3, 64, 32)] + [(64, 64, 32)] * 4 + [(64, 128, 16)] + [(128, 128, 16)] * 3 \
        + [(128, 256, 8)] + [(256, 256, 8)] * 3 + [(256, 512, 4)] + [(512, 512, 4)] * 3
    if sparsity_per_layer is None:
        # per-layer rates are not published for ResNet18; this profile is
        # consistent with Table II's 95% overall weight sparsity (weights
        # concentrate in deep layers) and Table I's FPS
        sparsity_per_layer = [0.3] + [0.5] * 4 + [0.7] * 4 + [0.9] * 4 + [0.97] * 4
    return [
        ConvLayer(3, 3, ci, co, hw, hw, s)
        for (ci, co, hw), s in zip(cfg, sparsity_per_layer)
    ]
