"""Event-driven simulation of the MARS fabric (replaces the closed-form
``max(compute, fm) + reload`` approximation of ``core.perf_model``).

Discrete-event engine at reload-wave granularity. Modeled resources, per
core:

  * one weight-SRAM -> macro write port (RELOAD events);
  * two 64 Kb macro buffers, ping-ponged: while one macro computes a wave
    the write port refills the other, so steady-state reload is hidden
    behind compute and only the first wave's fill is exposed (the
    closed-form model charges the full reload serially - the main place
    the two disagree, by design);
  * one MAC path issuing one group-set per CIM cycle (COMPUTE events);
    the shunter grants the core one FM-SRAM access per cycle, so a wave
    occupies the core for max(compute, fm) cycles - IFM fetches ride
    under the MACs unless the layer is fetch-bound (w4a4);
  * a per-layer APW event (adder/partial-sum write-back + controller),
    ``ctrl_overhead`` cycles per output pixel, emitted once every core
    has finished the layer's waves.

Inter-layer behavior follows the DAG: a layer's COMPUTE cannot start
before every dependency's APW has retired (activations exist), but with
``pipeline=True`` its RELOAD may - weights are static, so each core
prefetches the next layer's first wave into whichever macro buffer is
free while the current layer still computes. ``pipeline=False`` holds
reloads until dependencies retire, which is the closest event-level
analogue of the closed-form model and is what the cross-validation test
compares against ``perf_model.summarize``.

Known simplification: concurrent layers (ResNet down paths, LM QKV) share
the four cores by interleaving waves, not by a cycle-level arbiter; the
FIFO order the scheduler emits is what the hardware's static schedule
would pin anyway.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import itertools
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from ..core.perf_model import DEFAULT_HW, ConvLayer, HardwareConfig

from . import allocate as A
from .graph import LayerGraph, LayerNode, graph_from_layers

RELOAD, COMPUTE, APW = "reload", "compute", "apw"


@dataclasses.dataclass(frozen=True)
class SimEvent:
    """One completed occupancy interval on a resource (the event log)."""

    t_start: float
    t_end: float
    kind: str  # reload | compute | apw
    layer: str
    core: int  # -1 for network-level APW
    wave: int


@dataclasses.dataclass
class LayerTiming:
    name: str
    t_start: float  # first reload start
    t_compute: float  # first compute start
    t_end: float  # APW retire
    compute_cycles: float
    reload_cycles: float
    fm_cycles: float
    stall_cycles: float  # compute idle between ready and retire


@dataclasses.dataclass
class SimResult:
    cycles: float  # makespan (CIM cycles)
    fps: float
    layers: List[LayerTiming]
    events: List[SimEvent]
    hw: HardwareConfig
    w_bits: int
    a_bits: int
    compute_busy_total: float = 0.0  # MAC-path cycles summed over cores

    @property
    def core_utilization(self) -> float:
        return self.compute_busy_total / max(self.hw.cores * self.cycles, 1e-9)

    def summary(self) -> dict:
        return {
            "cycles": round(self.cycles, 1),
            "fps": round(self.fps, 2),
            "core_utilization": round(self.core_utilization, 4),
            "n_layers": len(self.layers),
            "n_events": len(self.events),
        }


@dataclasses.dataclass
class _Wave:
    layer: str
    wave: int
    groupsets: int
    compute: float  # cycles once issued
    fm: float
    reload: float
    last: bool  # last wave of this (layer, core)


class _Core:
    """Per-core state machine: reload port + 2 macro buffers + MAC path."""

    def __init__(self, cid: int):
        self.cid = cid
        # FIFOs (deques: a full-width LM queues ~10^6 waves)
        self.reload_q: Deque[_Wave] = collections.deque()  # for the port
        self.loaded_q: Deque[Tuple[_Wave, float]] = collections.deque()
        self.reload_busy = False
        self.compute_busy = False
        self.buffers_free = 2  # ping-pong macros not holding live weights
        self.t_reload_free = 0.0
        self.t_compute_free = 0.0


def _layer_waves(node: LayerNode, alloc: A.LayerAllocation,
                 hw: HardwareConfig, w_bits: int, a_bits: int,
                 dense: bool) -> List[List[_Wave]]:
    """Cut one layer into per-core wave task lists."""
    l = node.layer
    pass_f = hw.pass_factor(w_bits, a_bits)
    out: List[List[_Wave]] = []
    for asg in alloc.assignments:
        waves: List[_Wave] = []
        n_kg = len(asg.kernel_groups)
        for v, gs in enumerate(asg.waves):
            compute = l.out_pixels * gs * pass_f
            fm = float(l.out_pixels * gs)  # one IFM fetch per (pixel, gs)
            if v == len(asg.waves) - 1:  # OFM partial-sum writes drain last
                fm += l.out_pixels * n_kg
            reload = hw.reload_cycles(gs, w_bits, alloc.group, alloc.alpha)
            waves.append(_Wave(node.name, v, gs, compute, fm, reload,
                               last=v == len(asg.waves) - 1))
        out.append(waves)
    return out


def simulate(graph: LayerGraph | Sequence[ConvLayer],
             hw: HardwareConfig = DEFAULT_HW, w_bits: int = 8,
             a_bits: int = 4, *, dense: bool = False, pipeline: bool = True,
             group: Optional[int] = None, alpha: Optional[int] = None,
             keep_events: bool = True) -> SimResult:
    """Simulate one inference frame over the layer DAG.

    ``dense=True`` runs the no-skip baseline (every group-set computed and
    fetched); ``group``/``alpha`` override the paper's 16x16 tiling for
    mapping search.
    """
    if not isinstance(graph, LayerGraph):
        graph = graph_from_layers(graph)
    order = graph.topo_order()
    g = hw.group if group is None else group
    a = hw.alpha if alpha is None else alpha

    allocs = {n: A.allocate_node(graph.nodes[n], hw, w_bits, g, a, dense=dense)
              for n in order}
    waves = {n: _layer_waves(graph.nodes[n], allocs[n], hw, w_bits, a_bits,
                             dense) for n in order}

    cores = [_Core(c) for c in range(hw.cores)]
    seq = itertools.count()
    heap: List[Tuple[float, int, str, int, Optional[_Wave]]] = []
    events: List[SimEvent] = []
    timing: Dict[str, LayerTiming] = {}
    retired: Dict[str, float] = {}  # layer -> APW retire time
    pending_compute: Dict[str, int] = {}  # (layer) -> waves still to compute
    compute_busy: Dict[str, float] = {}  # layer -> MAC-path cycles occupied
    reload_busy: Dict[str, float] = {}  # layer -> write-port cycles occupied
    reload_started: Dict[str, float] = {}
    compute_started: Dict[str, float] = {}
    released: set = set()  # layers whose waves entered reload queues
    compute_ready: set = set()  # layers whose deps have retired

    def deps_retired(name: str) -> bool:
        return all(d in retired for d in graph.nodes[name].deps)

    def release(name: str, now: float) -> None:
        """Queue a layer's waves on its cores' reload FIFOs."""
        released.add(name)
        total = 0
        for c, wl in enumerate(waves[name]):
            cores[c].reload_q.extend(wl)
            total += len(wl)
        pending_compute[name] = total
        if total == 0:  # degenerate empty layer: retire instantly
            _retire(name, now)

    def _retire(name: str, now: float) -> None:
        retired[name] = now
        for s in order:
            if s not in compute_ready and deps_retired(s):
                compute_ready.add(s)
                if not pipeline and s not in released:
                    release(s, now)

    def kick(core: _Core, now: float) -> None:
        """Start whatever this core can legally start at ``now``."""
        # reload: port idle + a free macro buffer + head-of-queue exists
        if (not core.reload_busy and core.buffers_free > 0 and core.reload_q):
            w = core.reload_q.popleft()
            core.reload_busy = True
            core.buffers_free -= 1
            t0 = max(now, core.t_reload_free)
            t1 = t0 + w.reload
            core.t_reload_free = t1
            reload_started.setdefault(w.layer, t0)
            reload_busy[w.layer] = reload_busy.get(w.layer, 0.0) + (t1 - t0)
            heapq.heappush(heap, (t1, next(seq), RELOAD, core.cid, w))
            if keep_events:
                events.append(SimEvent(t0, t1, RELOAD, w.layer, core.cid, w.wave))
        # compute: MAC path idle + head-of-loaded-FIFO's layer is ready
        if not core.compute_busy and core.loaded_q:
            w, t_loaded = core.loaded_q[0]
            if w.layer in compute_ready:
                core.loaded_q.popleft()
                core.compute_busy = True
                t0 = max(now, core.t_compute_free, t_loaded)
                t1 = t0 + max(w.compute, w.fm)
                core.t_compute_free = t1
                compute_started.setdefault(w.layer, t0)
                compute_busy[w.layer] = (compute_busy.get(w.layer, 0.0)
                                         + (t1 - t0))
                heapq.heappush(heap, (t1, next(seq), COMPUTE, core.cid, w))
                if keep_events:
                    events.append(SimEvent(t0, t1, COMPUTE, w.layer,
                                           core.cid, w.wave))

    # --- prime the queues -------------------------------------------------
    for n in order:
        if deps_retired(n):
            compute_ready.add(n)
    if pipeline:
        for n in order:  # weights are static: all reloads may prefetch
            release(n, 0.0)
    else:
        for n in order:
            # a zero-wave root may retire inside release() and release its
            # successors via _retire - don't queue those twice
            if n in compute_ready and n not in released:
                release(n, 0.0)
    for c in cores:
        kick(c, 0.0)

    # --- event loop -------------------------------------------------------
    makespan = 0.0
    while heap:
        t, _, kind, cid, w = heapq.heappop(heap)
        makespan = max(makespan, t)
        if kind == RELOAD:
            core = cores[cid]
            core.reload_busy = False
            core.loaded_q.append((w, t))
            kick(core, t)
        elif kind == COMPUTE:
            core = cores[cid]
            core.compute_busy = False
            core.buffers_free += 1  # macro free for the next refill
            pending_compute[w.layer] -= 1
            if pending_compute[w.layer] == 0:
                l = graph.nodes[w.layer].layer
                t_apw = t + hw.ctrl_overhead * l.out_pixels
                heapq.heappush(heap, (t_apw, next(seq), APW, -1, w))
                if keep_events:
                    events.append(SimEvent(t, t_apw, APW, w.layer, -1, 0))
            kick(core, t)
        else:  # APW retire: dependents' activations now exist
            _retire(w.layer, t)
            for c in cores:
                kick(c, t)

    if len(retired) != len(order):
        missing = [n for n in order if n not in retired]
        raise RuntimeError(f"simulation deadlocked; unretired: {missing[:5]}")

    layer_timings = []
    for n in order:
        node = graph.nodes[n]
        comp = compute_busy.get(n, 0.0)
        rel = reload_busy.get(n, 0.0)
        fm = sum(max(w.fm - w.compute, 0.0) for wl in waves[n] for w in wl)
        t0 = reload_started.get(n, 0.0)
        tc = compute_started.get(n, t0)
        te = retired[n]
        span = te - tc
        stall = max(0.0, span * hw.cores - comp
                    - hw.ctrl_overhead * node.layer.out_pixels)
        layer_timings.append(LayerTiming(n, t0, tc, te, comp, rel, fm, stall))

    return SimResult(makespan, hw.cim_freq / max(makespan, 1e-9),
                     layer_timings, events if keep_events else [],
                     hw, w_bits, a_bits,
                     compute_busy_total=sum(compute_busy.values()))


def cross_validate(layers: Sequence[ConvLayer], hw: HardwareConfig = DEFAULT_HW,
                   w_bits: int = 8, a_bits: int = 4,
                   dense: bool = True) -> dict:
    """Simulated vs closed-form cycles on the same layer table."""
    from ..core import perf_model as PM

    res = simulate(graph_from_layers(layers), hw, w_bits, a_bits,
                   dense=dense, pipeline=False)
    perf = PM.evaluate_network(layers, w_bits, a_bits, hw=hw)
    analytic = sum(p.cycles_dense if dense else p.cycles_mars for p in perf)
    return {
        "sim_cycles": res.cycles,
        "analytic_cycles": analytic,
        "ratio": res.cycles / max(analytic, 1e-9),
        "sim_fps": res.fps,
        "analytic_fps": hw.cim_freq / max(analytic, 1e-9),
    }
