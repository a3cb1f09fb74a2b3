"""Schedule execution: one artifact format for the simulator and the GPU.

``NetworkSchedule`` is the contract: per layer it records the tiling the
search chose, the allocator's placement, and the simulated timing - and
the *same* (group, alpha) tile becomes the (bk, bn) block shape that
``core.deploy`` packs and the block-sparse kernel consumes. A schedule that
simulated fast is therefore directly runnable: ``execute_layer`` feeds a
real weight through ``deploy_weight -> deployed_matmul`` with the
schedule's tiling, and ``verify_layer`` asserts the result matches the
dense quantized oracle within a float tolerance - scheduling must never
change numerics, only time.

Execution follows the tensors' device: CUDA tensors run the kernels (or
raise), CPU tensors their plain versions.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from ..core import deploy as D
from ..core.cim_layer import CIMConfig
from ..core.perf_model import DEFAULT_HW, HardwareConfig

from . import allocate as A
from .graph import LayerGraph
from .search import MappingCandidate, SearchResult
from .simulate import SimResult, simulate


@dataclasses.dataclass
class LayerSchedule:
    name: str
    group: int
    alpha: int
    nnz: int
    total_groupsets: int
    reload_waves: int
    imbalance: float
    core_loads: List[int]
    t_start: float = 0.0
    t_end: float = 0.0

    @property
    def tile(self) -> tuple:
        return (self.group, self.alpha)


@dataclasses.dataclass
class NetworkSchedule:
    hw: HardwareConfig
    w_bits: int
    a_bits: int
    candidate: MappingCandidate
    layers: List[LayerSchedule]
    cycles: float
    fps: float
    # set by the measured-latency autotuner (``sched.autotune``) when wall
    # clock overrode (or confirmed) the simulated pick; None = never timed
    measured_tile: Optional[tuple] = None

    @property
    def uniform_tile(self) -> tuple:
        """The single (group, alpha) every layer was scheduled with - the
        uniform-envelope contract ``stack_deployed`` builds on. Raises if
        the schedule is heterogeneous (a future per-layer search would
        need per-layer stacks)."""
        tiles = {(s.group, s.alpha) for s in self.layers}
        if len(tiles) > 1:
            raise ValueError(
                f"schedule is not uniform-tile: {sorted(tiles)} - re-search "
                "with search_mapping(uniform=True)")
        return tiles.pop() if tiles else self.candidate.tile

    def to_json(self) -> dict:
        return {
            "group": self.candidate.group,
            "alpha": self.candidate.alpha,
            "pipeline": self.candidate.pipeline,
            "w_bits": self.w_bits,
            "a_bits": self.a_bits,
            "cycles": round(self.cycles, 1),
            "fps": round(self.fps, 2),
            "measured_tile": (list(self.measured_tile)
                              if self.measured_tile is not None else None),
            "layers": [
                {
                    "name": s.name,
                    "tile": list(s.tile),
                    "nnz": s.nnz,
                    "total_groupsets": s.total_groupsets,
                    "reload_waves": s.reload_waves,
                    "imbalance": round(s.imbalance, 3),
                    "core_loads": s.core_loads,
                    "t_start": round(s.t_start, 1),
                    "t_end": round(s.t_end, 1),
                }
                for s in self.layers
            ],
        }


def build_schedule(graph: LayerGraph, candidate: MappingCandidate,
                   hw: HardwareConfig = DEFAULT_HW, w_bits: int = 8,
                   a_bits: int = 4,
                   sim: Optional[SimResult] = None) -> NetworkSchedule:
    """Materialize the artifact for a chosen mapping: allocator placement
    per layer + simulated timeline."""
    if sim is None:
        sim = simulate(graph, hw, w_bits, a_bits, pipeline=candidate.pipeline,
                       group=candidate.group, alpha=candidate.alpha)
    timing = {t.name: t for t in sim.layers}
    layers = []
    for name in graph.topo_order():
        node = graph.nodes[name]
        alloc = A.allocate_node(node, hw, w_bits, candidate.group,
                                candidate.alpha)
        t = timing[name]
        layers.append(LayerSchedule(
            name=name,
            group=candidate.group,
            alpha=candidate.alpha,
            nnz=alloc.nnz_total,
            total_groupsets=node.layer.groupsets_for(candidate.group,
                                                     candidate.alpha),
            reload_waves=alloc.reload_waves,
            imbalance=alloc.imbalance,
            core_loads=[asg.nnz for asg in alloc.assignments],
            t_start=t.t_start,
            t_end=t.t_end,
        ))
    return NetworkSchedule(hw, w_bits, a_bits, candidate, layers,
                           sim.cycles, sim.fps)


def schedule_from_search(graph: LayerGraph, result: SearchResult,
                         hw: HardwareConfig = DEFAULT_HW, w_bits: int = 8,
                         a_bits: int = 4) -> NetworkSchedule:
    return build_schedule(graph, result.best.candidate, hw, w_bits, a_bits)


# ---------------------------------------------------------------------------
# Execution: the schedule's tile IS the kernel's block shape
# ---------------------------------------------------------------------------


def _deploy_tile(sched: LayerSchedule, d_in: int, d_out: int) -> tuple:
    """(bk, bn) for the kernel: the schedule tile, clipped to a divisor
    of the weight shape (pack_bsr requires exact tiling)."""
    return D.fit_tile(d_in, d_out, sched.group, sched.alpha)


def deploy_layer(w, sched: LayerSchedule, cim: CIMConfig,
                 target_sparsity: Optional[float] = None) -> D.DeployedWeight:
    """Pack one real weight for serving with the schedule's tiling."""
    d_in, d_out = int(w.shape[-2]), int(w.shape[-1])
    bk, bn = _deploy_tile(sched, d_in, d_out)
    return D.deploy_weight(w, cim, bk=bk, bn=bn,
                           target_sparsity=target_sparsity)


def execute_layer(x: torch.Tensor, w: torch.Tensor, sched: LayerSchedule,
                  cim: CIMConfig, target_sparsity: Optional[float] = None
                  ) -> torch.Tensor:
    """Run one scheduled layer on the kernel path of ``x``'s device (the
    reference's ``interpret=`` is the device here): on CUDA the fake-quant
    and block-sparse kernels, which raise rather than fall back."""
    dw = deploy_layer(w, sched, cim, target_sparsity)
    return D.deployed_matmul(x, dw, a_bits=cim.quant.a_bits)


def verify_layer(x: torch.Tensor, w: torch.Tensor, sched: LayerSchedule,
                 cim: CIMConfig, target_sparsity: Optional[float] = None,
                 atol: float = 1e-4) -> float:
    """Scheduled-kernel output vs the dense quantized oracle on the same
    device; returns the max abs error (raises if above ``atol``)."""
    d_in, d_out = int(w.shape[-2]), int(w.shape[-1])
    bk, bn = _deploy_tile(sched, d_in, d_out)
    got = execute_layer(x, w, sched, cim, target_sparsity)
    want = D.reference_matmul(x, w, cim, target_sparsity=target_sparsity,
                              bk=bk, bn=bn)
    err = float((got.float() - want.float()).abs().max())
    if err > atol:
        raise AssertionError(
            f"{sched.name}: scheduled execution diverged (max err {err})")
    return err


def execute_network(xs: Dict[str, torch.Tensor], ws: Dict[str, torch.Tensor],
                    schedule: NetworkSchedule, cim: CIMConfig
                    ) -> Dict[str, torch.Tensor]:
    """Execute every scheduled layer that has a weight + input provided."""
    by_name = {s.name: s for s in schedule.layers}
    out = {}
    for name, w in ws.items():
        if name not in by_name or name not in xs:
            continue
        out[name] = execute_layer(xs[name], w, by_name[name], cim)
    return out
