"""Mapping search: grid/greedy co-exploration of the compression tiling.

CIM-Tuner's observation, applied to MARS: the (group x alpha) tile shape is
simultaneously (a) the pruning granularity, (b) the macro storage quantum,
and (c) the block-sparse kernel's block shape - so changing it trades skip
opportunity (smaller tiles -> more all-zero tiles survive pruning) against
per-cycle parallelism and index overhead (smaller tiles -> more tiles, more
codes, more reload waves). The search simulates each candidate tiling on
the event-driven model and returns the best schedule; the paper's own
16x16 mapping is always in the candidate set, so the result is never worse
than the default.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

from ..core.perf_model import (DEFAULT_HW, HardwareConfig,
                               speculative_summary)

from .graph import LayerGraph, lm_graph
from .simulate import SimResult, simulate


@dataclasses.dataclass(frozen=True)
class MappingCandidate:
    """One point in the mapping space."""

    group: int  # weight-group size (input direction) = kernel bk
    alpha: int  # kernels per group-set (output direction) = kernel bn
    pipeline: bool = True

    @property
    def tile(self) -> Tuple[int, int]:
        return (self.group, self.alpha)


@dataclasses.dataclass
class CandidateResult:
    candidate: MappingCandidate
    fps: float
    cycles: float
    core_utilization: float

    def row(self) -> dict:
        return {
            "group": self.candidate.group,
            "alpha": self.candidate.alpha,
            "pipeline": self.candidate.pipeline,
            "fps": round(self.fps, 2),
            "cycles": round(self.cycles, 1),
            "core_utilization": round(self.core_utilization, 4),
        }


@dataclasses.dataclass
class SearchResult:
    best: CandidateResult
    default: CandidateResult
    table: List[CandidateResult]

    @property
    def speedup_vs_default(self) -> float:
        return self.best.fps / max(self.default.fps, 1e-9)


def default_candidate(hw: HardwareConfig = DEFAULT_HW,
                      pipeline: bool = True) -> MappingCandidate:
    return MappingCandidate(hw.group, hw.alpha, pipeline)


def tile_divides_graph(graph: LayerGraph, group: int, alpha: int) -> bool:
    """True when (group, alpha) exactly tiles EVERY node's 2-D workload
    (kh*kw*cin x cout) - the uniform-envelope feasibility predicate: one
    tile that ``pack_bsr`` accepts unchanged for the whole network."""
    return all(
        (n.layer.kh * n.layer.kw * n.layer.cin) % group == 0
        and n.layer.cout % alpha == 0
        for n in graph.nodes.values())


def uniform_tile_candidates(graph: LayerGraph,
                            groups: Sequence[int],
                            alphas: Sequence[int],
                            pipeline: bool = True) -> List[MappingCandidate]:
    """The subset of the (groups x alphas) grid that is network-uniform
    feasible (divides every layer)."""
    return [MappingCandidate(g, a, pipeline)
            for g in groups for a in alphas
            if tile_divides_graph(graph, g, a)]


def search_mapping(graph: LayerGraph, hw: HardwareConfig = DEFAULT_HW,
                   w_bits: int = 8, a_bits: int = 4,
                   groups: Sequence[int] = (8, 16, 32),
                   alphas: Sequence[int] = (8, 16, 32),
                   pipeline: bool = True,
                   budget: Optional[int] = None,
                   uniform: bool = False) -> SearchResult:
    """Grid search over tile shapes; ``budget`` caps simulated candidates
    (the default mapping never counts against it).

    ``uniform=True`` is the CIM-Tuner-style network-wide mode: only tiles
    that exactly divide EVERY layer's (d_in, d_out) are considered, so the
    winning (group, alpha) is directly the one packing envelope the whole
    network deploys with (``stack_deployed`` requires it). The default
    mapping is kept only if itself feasible; with no feasible candidate at
    all the search fails loudly rather than silently clipping per layer.
    """
    cands = [default_candidate(hw, pipeline)]
    for g in groups:
        for a in alphas:
            c = MappingCandidate(g, a, pipeline)
            if c not in cands:
                cands.append(c)
    has_default = True
    if uniform:
        cands = [c for c in cands
                 if tile_divides_graph(graph, c.group, c.alpha)]
        if not cands:
            raise ValueError(
                "search_mapping(uniform=True): no candidate tile divides "
                "every layer - widen groups/alphas (powers of two that "
                "divide the model dims always qualify)")
        has_default = cands[0] == default_candidate(hw, pipeline)
    if budget is not None:
        # the default mapping (when it survived filtering) rides for free;
        # always simulate at least one candidate so a reference row exists
        cands = cands[: max(int(has_default) + max(budget, 0), 1)]

    table: List[CandidateResult] = []
    for c in cands:
        res = simulate(graph, hw, w_bits, a_bits, pipeline=c.pipeline,
                       group=c.group, alpha=c.alpha, keep_events=True)
        table.append(CandidateResult(c, res.fps, res.cycles,
                                     res.core_utilization))
    default = table[0]
    best = max(table, key=lambda r: r.fps)
    return SearchResult(best, default, table)


# ---------------------------------------------------------------------------
# Speculative two-tier search: pick (family, k, knob) from simulated cost
# and the CALIBRATED acceptance prior
# ---------------------------------------------------------------------------

CALIBRATION_SCHEMA = 1


@dataclasses.dataclass
class SpecCalibration:
    """Measured acceptance prior, keyed (arch, family, gap).

    Every served spec run measures an acceptance rate at one point of the
    draft-knob space; this cache accumulates those points and interpolates
    between them, replacing ``default_accept_model``'s linear guess with
    data. ``gap`` is the family's normalized how-much-the-draft-gives-up
    coordinate: ``draft_sparsity - target_sparsity`` for reprune,
    ``1 - keep`` for layerskip - one axis per family, so measurements at
    different absolute sparsities still pool.

    Persisted like the autotune cache: ``to_json`` into the serving-
    artifact manifest (``spec_calibration`` key) and alongside the bench
    history JSONL, ``from_json`` back with hard schema validation
    (malformed calibration fails loudly, never silently mis-prices)."""

    rows: List[dict] = dataclasses.field(default_factory=list)

    def add(self, arch: str, family: str, gap: float, accept: float,
            weight: float = 1.0) -> None:
        """Fold in one measured point. ``weight`` should scale with the
        evidence (e.g. the number of proposed tokens behind the rate)."""
        if not 0.0 <= accept <= 1.0:
            raise ValueError(f"calibration: accept {accept} not in [0, 1]")
        if weight <= 0.0:
            raise ValueError(f"calibration: weight {weight} must be > 0")
        self.rows.append({"arch": str(arch), "family": str(family),
                          "gap": float(gap), "accept": float(accept),
                          "weight": float(weight)})

    # how far (in gap units) a measurement's influence reaches before the
    # fit falls back toward the uncalibrated prior: one point at gap=0.5
    # must NOT promise its acceptance at gap=0.75 unseen
    TRUST_RADIUS = 0.1

    def accept_model(self, arch: str, family: str,
                     prior: Optional[Callable[[float], float]] = None
                     ) -> Optional[Callable[[float], float]]:
        """Fitted gap -> acceptance for one (arch, family), or None when no
        measurements exist. Inverse-distance-weighted over the measured
        points (times their evidence weight): exact re-queries reproduce
        the measurement, in-between gaps interpolate. ``prior`` (an
        uncalibrated gap -> accept fallback) bounds extrapolation: trust
        in the interpolation decays with the distance to the NEAREST
        measured point, so a query far from all data answers mostly from
        the prior instead of flat-extrapolating one measurement across
        the whole knob axis."""
        pts = [r for r in self.rows
               if r["arch"] == arch and r["family"] == family]
        if not pts:
            return None

        def model(gap: float) -> float:
            num = den = 0.0
            d_min = min(abs(gap - r["gap"]) for r in pts)
            for r in pts:
                w = r["weight"] / (1e-3 + abs(gap - r["gap"]))
                num += w * r["accept"]
                den += w
            fit = num / den
            if prior is not None:
                trust = self.TRUST_RADIUS / (self.TRUST_RADIUS + d_min)
                fit = trust * fit + (1.0 - trust) * prior(gap)
            return min(1.0, max(0.0, fit))

        return model

    def to_json(self) -> dict:
        return {"schema": CALIBRATION_SCHEMA, "rows": list(self.rows)}

    @classmethod
    def from_json(cls, d: dict) -> "SpecCalibration":
        if not isinstance(d, dict) or d.get("schema") != CALIBRATION_SCHEMA:
            raise ValueError(
                f"spec calibration: unsupported schema {d.get('schema')!r} "
                f"(supported: {CALIBRATION_SCHEMA})")
        rows = d.get("rows")
        if not isinstance(rows, list):
            raise ValueError("spec calibration: rows is not a list")
        cal = cls()
        for i, r in enumerate(rows):
            try:
                cal.add(r["arch"], r["family"], r["gap"], r["accept"],
                        r.get("weight", 1.0))
            except (KeyError, TypeError, ValueError) as e:
                raise ValueError(f"spec calibration: row {i}: {e}")
        return cal


@dataclasses.dataclass
class SpecSearchResult:
    """Winner + full table of the (family, knob, k) grid. Each row is a
    ``perf_model.speculative_summary`` dict extended with the simulated
    per-step draft cost, family and knob."""

    best: dict
    table: List[dict]

    @property
    def decision(self) -> dict:
        """The auto-policy verdict: serve speculation with the winning
        (family, k, knob), or DECLINE - fall back to the scan engine -
        when even the best modeled candidate loses to target-only decode.
        No configuration may silently ship a speculation loss."""
        b = self.best
        d = {"verdict": ("spec" if b["speedup_vs_target"] > 1.0
                         else "declined"),
             "family": b["family"], "k": b["k"],
             "knob": (b["draft_sparsity"] if b["family"] == "reprune"
                      else b["keep"]),
             "predicted_speedup": b["speedup_vs_target"],
             "accept": b["accept"], "accept_source": b["accept_source"]}
        if d["verdict"] == "declined":
            d["reason"] = "scan wins"
        return d


def default_accept_model(draft_sparsity: float,
                         target_sparsity: float) -> float:
    """Crude reprune acceptance prior: agreement decays linearly with the
    extra sparsity the draft tier gives up over the target. This is the
    UNCALIBRATED fallback - measured :class:`SpecCalibration` rows replace
    it as soon as one spec run has been served."""
    return min(1.0, max(0.0, 1.0 - (draft_sparsity - target_sparsity)))


def default_accept_model_layerskip(keep: float) -> float:
    """Uncalibrated layerskip prior: agreement ~ the kept-sublayer
    fraction (keep=1 is the target itself). Same caveat as
    :func:`default_accept_model` - measurements override it."""
    return min(1.0, max(0.0, keep))


def search_spec(cfg, *, hw: HardwareConfig = DEFAULT_HW, w_bits: int = 8,
                a_bits: int = 8, target_sparsity: float = 0.6,
                draft_sparsities: Sequence[float] = (0.75, 0.85, 0.9, 0.95),
                ks: Sequence[int] = (2, 3, 4, 6, 8),
                keeps: Sequence[float] = (0.25, 0.5, 0.75),
                families: Sequence[str] = ("reprune", "layerskip"),
                group: int = 16, alpha: int = 16,
                accept_model: Optional[Callable[[float, float], float]] = None,
                calibration: Optional[SpecCalibration] = None,
                arch: Optional[str] = None) -> SpecSearchResult:
    """Pick the speculative (family, k, draft knob) from SIMULATED cost and
    the best available acceptance prior.

    Cost: the event-driven simulator prices a one-token draft step for
    every candidate - a re-pruned graph at each ``draft_sparsities`` for
    the reprune family; the kept-sublayer fraction of a target step for
    each ``keeps`` of the layerskip family (its draft IS the target
    envelope, so its per-step cost scales with the executed sublayers, and
    its rounds run k draft steps, not k+1 - no second KV cache to fill).
    For every k the (k+1)-token target verify pass is priced once.

    Acceptance: ``calibration`` (measured :class:`SpecCalibration` rows
    for ``arch``, default ``cfg.name``) beats the explicit
    ``accept_model`` callable (reprune-only, legacy signature), beats the
    uncalibrated linear priors. Each row records which source priced it
    (``accept_source``).

    The winner maximizes expected tokens/cycle; ``result.decision``
    declines speculation outright when even the winner models below
    target-only throughput."""
    arch = arch if arch is not None else getattr(cfg, "name", "unknown")
    c_target_step = simulate(lm_graph(cfg, seq_len=1,
                                      sparsity_gs=target_sparsity),
                             hw, w_bits, a_bits, group=group,
                             alpha=alpha).cycles
    verify_cost = {k: simulate(lm_graph(cfg, seq_len=k + 1,
                                        sparsity_gs=target_sparsity),
                               hw, w_bits, a_bits, group=group,
                               alpha=alpha).cycles
                   for k in ks}
    table: List[dict] = []

    def add_rows(family: str, knob: float, gap: float, c_draft: float,
                 draft_steps_of) -> None:
        # both families' uncalibrated priors are max(0, 1 - gap) in gap
        # space (reprune: 1 - (ds - ts); layerskip: keep = 1 - gap)
        gap_prior = lambda g: min(1.0, max(0.0, 1.0 - g))
        fitted = (calibration.accept_model(arch, family, prior=gap_prior)
                  if calibration is not None else None)
        if fitted is not None:
            accept, source = fitted(gap), "calibrated"
        elif family == "reprune" and accept_model is not None:
            accept, source = accept_model(knob, target_sparsity), "model"
        elif family == "reprune":
            accept, source = default_accept_model(knob, target_sparsity), \
                "prior"
        else:
            accept, source = default_accept_model_layerskip(knob), "prior"
        for k in ks:
            row = speculative_summary(c_draft, verify_cost[k], k, accept,
                                      draft_steps=draft_steps_of(k))
            row["family"] = family
            if family == "reprune":
                row["draft_sparsity"] = knob
            else:
                row["keep"] = knob
            row["gap"] = round(gap, 4)
            row["accept_source"] = source
            row["draft_step_cycles"] = round(c_draft, 1)
            # tokens/cycle speculative vs the target's 1 token / step
            row["speedup_vs_target"] = round(
                row["tokens_per_round"] * c_target_step
                / max(row["cycles_per_round"], 1e-9), 4)
            table.append(row)

    if "reprune" in families:
        for ds in draft_sparsities:
            c_draft = simulate(lm_graph(cfg, seq_len=1, sparsity_gs=ds),
                               hw, w_bits, a_bits, group=group,
                               alpha=alpha).cycles
            add_rows("reprune", ds, ds - target_sparsity, c_draft,
                     lambda k: k + 1)
    if "layerskip" in families:
        for keep in keeps:
            add_rows("layerskip", keep, 1.0 - keep, keep * c_target_step,
                     lambda k: k)
    if not table:
        raise ValueError(f"search_spec: no known family in {families!r}")
    best = max(table, key=lambda r: r["tokens_per_kcycle"])
    return SpecSearchResult(best, table)


def greedy_search(graph: LayerGraph, hw: HardwareConfig = DEFAULT_HW,
                  w_bits: int = 8, a_bits: int = 4,
                  steps: Sequence[int] = (8, 16, 32, 64),
                  pipeline: bool = True) -> SearchResult:
    """Coordinate-descent alternative to the full grid: optimize ``group``
    with alpha fixed at the default, then ``alpha`` at the winning group.
    Simulates O(2k) candidates instead of O(k^2)."""
    table: List[CandidateResult] = []

    def ev(c: MappingCandidate) -> CandidateResult:
        for t in table:
            if t.candidate == c:
                return t
        res = simulate(graph, hw, w_bits, a_bits, pipeline=c.pipeline,
                       group=c.group, alpha=c.alpha)
        r = CandidateResult(c, res.fps, res.cycles, res.core_utilization)
        table.append(r)
        return r

    default = ev(default_candidate(hw, pipeline))
    best = default
    for g in steps:
        best = max(best, ev(MappingCandidate(g, hw.alpha, pipeline)),
                   key=lambda r: r.fps)
    for a in steps:
        best = max(best, ev(MappingCandidate(best.candidate.group, a,
                                             pipeline)),
                   key=lambda r: r.fps)
    return SearchResult(best, default, table)
