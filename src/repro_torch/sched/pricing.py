"""Request pricing: the event-driven simulator as an admission oracle.

CIMinus's thesis is that a calibrated cost model can price sparse workloads
on a CIM fabric BEFORE running them; the serving analogue is admission
control. This module turns the event-driven simulator (plus the
re-fit cycle constants) into a per-request price: predicted prefill seconds
and per-decode-token seconds at a tenant's (arch, sparsity), so a gateway
can decide admit / defer / shed without ever dispatching a kernel.

Two honesty points:

  * the simulator prices CIM cycles on the MODELED fabric. Raw
    ``cycles / hw.cim_freq`` seconds are therefore fabric-seconds, not
    host-seconds - fine for RELATIVE decisions (which request is heavier,
    which tenant's backlog is longer). Passing ``refit`` (a
    ``core.perf_model.RefitResult`` or its ``seconds_per_cycle`` dict,
    i.e. the measured-constants fit) converts phase cycles with the
    MEASURED per-phase constants instead, so prices live on the same
    clock as the SLOs they gate.
  * simulation is not free. Prices are memoized per
    ``(arch, seq-bucket, sparsity, n_devices)`` with sequence lengths
    bucketed to the next power of two - admission control needs a stable
    order of magnitude per shape class, not a fresh DAG simulation per
    request.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from ..core import perf_model as PM
from .graph import lm_graph
from .simulate import simulate


def _seq_bucket(n: int) -> int:
    """Next power of two >= n (min 1): the pricing cache granularity."""
    b = 1
    while b < max(1, int(n)):
        b <<= 1
    return b


@dataclasses.dataclass(frozen=True)
class StepPrice:
    """Simulated cost of one forward pass at ``seq_len`` rows."""

    seconds: float
    cycles: float
    phases: Dict[str, float]  # compute/reload/fm/stall cycle totals
    seq_bucket: int


@dataclasses.dataclass(frozen=True)
class RequestPrice:
    """Predicted serving cost of one request on the modeled fabric.

    ``prefill_s`` covers the whole prompt in one pass (the bucketed
    sequence length); ``per_token_s`` is one decode step; ``total_s`` is
    the request end to end (prefill + max_new decode steps) - the number
    admission backlogs sum over."""

    prefill_s: float
    per_token_s: float
    max_new_tokens: int

    @property
    def decode_s(self) -> float:
        return self.per_token_s * self.max_new_tokens

    @property
    def total_s(self) -> float:
        return self.prefill_s + self.decode_s

    def to_json(self) -> dict:
        return {"prefill_ms": round(self.prefill_s * 1e3, 4),
                "per_token_ms": round(self.per_token_s * 1e3, 4),
                "total_ms": round(self.total_s * 1e3, 4)}


def _refit_coeffs(refit) -> Optional[Dict[str, float]]:
    """Normalize ``refit`` into a seconds-per-cycle dict (or None).

    Accepts a :class:`~repro_torch.core.perf_model.RefitResult`, its
    ``seconds_per_cycle`` mapping, or a BENCH_sched ``post_refit`` entry
    (which nests the mapping under ``seconds_per_cycle``)."""
    if refit is None:
        return None
    if hasattr(refit, "seconds_per_cycle"):
        refit = refit.seconds_per_cycle
    if isinstance(refit, dict) and "seconds_per_cycle" in refit:
        refit = refit["seconds_per_cycle"]
    if not isinstance(refit, dict):
        raise TypeError(f"pricing: refit must be a RefitResult or a "
                        f"seconds_per_cycle mapping, got {type(refit)}")
    coeffs = {k: float(refit.get(k, 0.0)) for k in PM.REFIT_COEFFS}
    if not any(v > 0 for v in coeffs.values()):
        raise ValueError(f"pricing: refit constants all zero: {refit}")
    return coeffs


class Pricer:
    """Memoizing price oracle over the event-driven simulator.

    One Pricer serves every tenant: the cache key carries the arch name,
    so tenants with different models (or the same model at different
    sparsity) price independently."""

    def __init__(self, hw: Optional[PM.HardwareConfig] = None, refit=None):
        self.hw = hw or PM.DEFAULT_HW
        self._refit = _refit_coeffs(refit)
        self._cache: Dict[Tuple, StepPrice] = {}

    @property
    def calibrated(self) -> bool:
        """True when prices run on measured (re-fit) constants."""
        return self._refit is not None

    def _seconds(self, cycles: float, phases: Dict[str, float]) -> float:
        if self._refit is None:
            return cycles / self.hw.cim_freq
        feats = PM.phase_features(phases)
        return sum(c * t for c, t in
                   zip(feats, (self._refit[k] for k in PM.REFIT_COEFFS)))

    def step_price(self, cfg, seq_len: int, sparsity_gs: float,
                   n_devices: int = 1) -> StepPrice:
        """Simulated cost of ONE forward pass of ``cfg``'s CIM projection
        graph at ``seq_len`` rows (bucketed up to a power of two)."""
        bucket = _seq_bucket(seq_len)
        key = (cfg.name, bucket, round(float(sparsity_gs), 4), n_devices)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        graph = lm_graph(cfg, seq_len=bucket, sparsity_gs=sparsity_gs)
        sim = simulate(graph, hw=self.hw, w_bits=cfg.w_bits,
                       a_bits=cfg.a_bits, keep_events=False)
        phases = {
            "compute": sum(l.compute_cycles for l in sim.layers),
            "reload": sum(l.reload_cycles for l in sim.layers),
            "fm": sum(l.fm_cycles for l in sim.layers),
            "stall": sum(l.stall_cycles for l in sim.layers),
        }
        cycles = float(sim.cycles)
        if n_devices > 1:
            collective = sum(
                self.hw.allgather_cycles(l.out_h * l.out_w * l.cout * 4,
                                         n_devices)
                for l in graph.layers())
            phases["collective"] = collective
            cycles += collective
        price = StepPrice(seconds=self._seconds(cycles, phases),
                          cycles=cycles, phases=phases, seq_bucket=bucket)
        self._cache[key] = price
        return price

    def price_request(self, cfg, prompt_len: int, max_new_tokens: int,
                      sparsity_gs: float, n_devices: int = 1) -> RequestPrice:
        """Price one request: a bucketed full-prompt prefill pass plus
        ``max_new_tokens`` one-token decode steps."""
        prefill = self.step_price(cfg, prompt_len, sparsity_gs,
                                  n_devices=n_devices)
        decode = self.step_price(cfg, 1, sparsity_gs, n_devices=n_devices)
        return RequestPrice(prefill_s=prefill.seconds,
                            per_token_s=decode.seconds,
                            max_new_tokens=int(max_new_tokens))
