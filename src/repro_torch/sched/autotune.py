"""Measured-latency tile autotuner: close the search loop on the stopwatch.

``search_mapping`` ranks (group, alpha) tiles by SIMULATED cycles on the
modeled MARS fabric - but the tile is also the block-sparse kernel's block
shape, and what a block shape costs on the device actually serving the
model (the H100 in deployment, the plain PyTorch version on the CPU in
tests) is not what it costs on the modeled 28 nm fabric. CIM-Tuner's
answer, reproduced here: keep the analytic search as the PROPOSER, then
time the top-N proposals through the real ``bsr_matmul_stacked`` kernel -
prefill and decode row counts, fenced with
:class:`~repro_torch.kernels.timing.DispatchTimer` - and let measured wall
clock pick the winner. The simulated pick is always in the shortlist, so
the measured winner is never slower than it on the timed workload.

Measurements are expensive (each candidate packs + dispatches every
distinct projection shape), so results persist as an :class:`AutotuneCache`
keyed by (arch, projection shapes, backend) inside the serving
artifact's manifest - a booted artifact reuses the measurement instead of
re-timing, and a backend change (cache taken on the GPU, booted on the
CPU) misses the key rather than trusting a stale clock. The port's
backends are ``torch-cuda`` and ``torch-cpu``, never the reference's
``cpu``/``gpu``/``tpu``: a cache the JAX package wrote reads as a miss
here, whatever machine it was taken on. The per-sample (phase cycles, measured seconds) pairs feed
``perf_model.fit_cycle_constants`` so the simulator's constants track the
machine (``refit_from_table``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from ..core import perf_model as PM
from ..core.deploy import DeployedWeight, stack_deployed
from ..core.perf_model import DEFAULT_HW, HardwareConfig
from ..core.sparsity import prune_mask_2d
from ..device import DeviceLike, resolve_device
from ..kernels import ops
from ..kernels.timing import DispatchTimer
from .graph import lm_graph
from .search import SearchResult, search_mapping

CACHE_SCHEMA = 1


# ---------------------------------------------------------------------------
# Workload signature: the shapes a serving config actually dispatches
# ---------------------------------------------------------------------------


def projection_shapes(cfg) -> List[Tuple[int, int, int]]:
    """Distinct CIM projection shapes of ``cfg`` as (d_in, d_out, count),
    sorted - the workload signature the autotuner times and keys on.
    Counts aggregate identical shapes across blocks (timing one and
    weighting by count, instead of re-timing the same matmul L times)."""
    counts: Dict[Tuple[int, int], int] = {}
    for node in lm_graph(cfg, seq_len=1).nodes.values():
        l = node.layer
        key = (l.kh * l.kw * l.cin, l.cout)
        counts[key] = counts.get(key, 0) + 1
    return sorted((d_in, d_out, n) for (d_in, d_out), n in counts.items())


def backend_name(device: DeviceLike = None) -> str:
    """The cache's backend for a device: ``torch-cuda`` or ``torch-cpu``
    (``None`` is the GPU, as for every entry point)."""
    return f"torch-{resolve_device(device).type}"


def autotune_key(cfg, backend: Optional[str] = None) -> str:
    """Cache key: arch | backend | shape signature. The backend is part of
    the key on purpose - a wall-clock ranking taken on one backend says
    nothing about another, so a mismatch must read as a MISS. ``backend``
    defaults to the GPU's, ``torch-cuda``; the JAX package's keys carry
    ``cpu``/``gpu``/``tpu`` and so never match one written here."""
    backend = backend or backend_name()
    shapes = ";".join(f"{i}x{o}x{n}" for i, o, n in projection_shapes(cfg))
    return f"{cfg.name}|{backend}|{shapes}"


# ---------------------------------------------------------------------------
# Measurement: one tile through the real stacked kernel, fenced
# ---------------------------------------------------------------------------


def measure_tile(shapes: Sequence[Tuple[int, int, int]],
                 tile: Tuple[int, int], sparsity: float,
                 w_bits: int = 8, a_bits: int = 8,
                 prefill_rows: int = 32, decode_rows: int = 4,
                 repeats: int = 2, stack_layers: int = 2,
                 timer: Optional[DispatchTimer] = None,
                 hw: HardwareConfig = DEFAULT_HW,
                 device: DeviceLike = None) -> dict:
    """Fenced wall clock of ONE candidate tile over a workload signature.

    For every (d_in, d_out, count) shape, packs ``stack_layers`` synthetic
    pruned weights into a uniform envelope and dispatches the real
    ``bsr_matmul_stacked`` kernel on ``device`` (default: the GPU) at
    prefill and decode row counts; the first dispatch per shape (the
    kernel's build and first launch) is excluded. On a CUDA device the
    kernel launches or raises; the CPU times the plain version, and only
    when asked for. Returns a JSON-ready row: count-weighted
    prefill/decode/total seconds plus the per-sample (phase cycles,
    measured seconds) pairs the cost-constant re-fit consumes."""
    dev = resolve_device(device)
    bk, bn = int(tile[0]), int(tile[1])
    timer = timer if timer is not None else DispatchTimer(enabled=True)
    hw_t = dataclasses.replace(hw, group=bk, alpha=bn)
    rng = np.random.default_rng(0)
    layer0 = torch.zeros(1, dtype=torch.int32, device=dev)
    prefill_s = decode_s = 0.0
    samples: List[dict] = []
    for d_in, d_out, count in shapes:
        packs = []
        for _ in range(max(stack_layers, 1)):
            w = torch.from_numpy(
                rng.standard_normal((d_in, d_out)).astype(np.float32) * 0.05)
            if sparsity > 0:
                w = w * prune_mask_2d(w, bk, bn, sparsity)
            packs.append(DeployedWeight([ops.pack_for_kernel(
                w, bits=w_bits, bk=bk, bn=bn, device=dev)], d_in, d_out,
                w_bits))
        # the uniform envelope the stacked kernel takes: slots padded to the
        # widest layer with zero blocks and zero scales (inert)
        sw = stack_deployed(packs)
        stacked = (sw.blocks, sw.scales, sw.row_idx, sw.nnz)
        for phase, rows in (("prefill", prefill_rows), ("decode", decode_rows)):
            x = torch.from_numpy(
                rng.standard_normal((rows, d_in)).astype(np.float32)).to(dev)
            # the reference passes bm_for_rows(rows) as the kernel's row
            # tile; the port's kernel picks its tile height from M itself
            # (cim_bsr_matmul.plan), so no bm is passed
            args = (x, *stacked, layer0)
            # warm call outside the timer: the kernel's build and first
            # launch, not dispatch
            y = ops.bsr_matmul_stacked(*args)
            if y.is_cuda:
                torch.cuda.synchronize(y.device)
            best = None
            for _ in range(max(repeats, 1)):
                n_before = len(timer.records)
                timer.timed(f"autotune.{phase}", (rows, d_in, d_out),
                            (bk, bn), ops.bsr_matmul_stacked, *args)
                s = timer.records[n_before].seconds
                best = s if best is None else min(best, s)
            best = max(best, 1e-9)
            if phase == "prefill":
                prefill_s += best * count
            else:
                decode_s += best * count
            layer = PM.ConvLayer(1, 1, d_in, d_out, 1, rows, sparsity)
            samples.append({
                "shape": [rows, d_in, d_out],
                "phases": PM.layer_phase_cycles(layer, w_bits, a_bits,
                                                hw=hw_t),
                "measured_s": best,
            })
    return {
        "tile": [bk, bn],
        "backend": backend_name(dev),
        "prefill_s": prefill_s,
        "decode_s": decode_s,
        "total_s": prefill_s + decode_s,
        "samples": samples,
    }


def refit_from_table(table: Sequence[dict],
                     hw: HardwareConfig = DEFAULT_HW) -> PM.RefitResult:
    """Cost-constant re-fit over every (phases, measured_s) sample a
    ``measure_tile`` table collected."""
    samples = [(s["phases"], s["measured_s"])
               for row in table for s in row.get("samples", ())]
    return PM.fit_cycle_constants(samples, hw=hw)


# ---------------------------------------------------------------------------
# Cache: measurements persist inside the serving artifact manifest
# ---------------------------------------------------------------------------


class AutotuneCache:
    """Per-(arch, shapes, backend) measured-tile store, JSON round-trippable
    through the serving artifact's ``extra`` manifest slot."""

    def __init__(self, entries: Optional[Dict[str, dict]] = None):
        self.entries: Dict[str, dict] = dict(entries or {})

    def get(self, key: str) -> Optional[dict]:
        return self.entries.get(key)

    def put(self, key: str, result: "AutotuneResult") -> None:
        self.entries[key] = {
            "backend": result.backend,
            "best_tile": list(result.best_tile),
            "simulated_tile": list(result.simulated_tile),
            "table": [{k: v for k, v in row.items() if k != "samples"}
                      for row in result.table],
        }

    def to_json(self) -> dict:
        return {"schema": CACHE_SCHEMA, "entries": self.entries}

    @classmethod
    def from_json(cls, obj) -> "AutotuneCache":
        if not isinstance(obj, dict) or "entries" not in obj:
            raise ValueError(f"autotune cache: malformed payload {type(obj)}")
        if obj.get("schema") != CACHE_SCHEMA:
            raise ValueError(
                f"autotune cache: schema {obj.get('schema')!r} != {CACHE_SCHEMA}")
        entries = obj["entries"]
        if not isinstance(entries, dict):
            raise ValueError("autotune cache: entries is not a mapping")
        for key, e in entries.items():
            tile = e.get("best_tile") if isinstance(e, dict) else None
            if (not isinstance(tile, (list, tuple)) or len(tile) != 2
                    or not all(isinstance(t, int) and t > 0 for t in tile)):
                raise ValueError(f"autotune cache: entry {key!r} has bad "
                                 f"best_tile {tile!r}")
        return cls(entries)


# ---------------------------------------------------------------------------
# The autotuner
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AutotuneResult:
    """Outcome of one autotune pass. ``best_tile`` is what to pack with;
    ``table`` holds the measured rows (empty on a cache hit or when
    measurement was disabled and the simulated tile won by default)."""

    best_tile: Tuple[int, int]
    simulated_tile: Tuple[int, int]
    table: List[dict]
    cache_hit: bool
    key: str
    backend: str

    def to_json(self) -> dict:
        return {
            "best_tile": list(self.best_tile),
            "simulated_tile": list(self.simulated_tile),
            "cache_hit": self.cache_hit,
            "backend": self.backend,
            "table": [{k: v for k, v in row.items() if k != "samples"}
                      for row in self.table],
        }


def autotune(cfg, top_n: int = 3, *, target_sparsity: float = 0.6,
             groups: Sequence[int] = (8, 16, 32),
             alphas: Sequence[int] = (8, 16, 32),
             seq_len: int = 128, prefill_rows: int = 32,
             decode_rows: int = 4, repeats: int = 2, stack_layers: int = 2,
             hw: HardwareConfig = DEFAULT_HW,
             cache: Optional[AutotuneCache] = None,
             timer: Optional[DispatchTimer] = None,
             allow_measure: bool = True,
             search: Optional[SearchResult] = None,
             device: DeviceLike = None) -> AutotuneResult:
    """Pick the serving tile by measured wall clock.

    Runs the uniform-envelope mapping search (unless a ``search`` result is
    passed in), shortlists its top-``top_n`` tiles by simulated FPS, times
    each through the real stacked BSR kernels and returns the measured
    winner. A populated ``cache`` short-circuits the measurement entirely
    (cache HIT); with ``allow_measure=False`` a MISS falls back to the
    simulated tile instead of timing (the offline / wrong-backend path).
    ``device`` (default: the GPU) is where the candidates are timed and
    names the cache's backend; without a GPU this measures only when the
    caller asks for the CPU, and records ``torch-cpu``."""
    dev = resolve_device(device)
    backend = backend_name(dev)
    key = autotune_key(cfg, backend)
    if search is None:
        graph = lm_graph(cfg, seq_len=seq_len, sparsity_gs=target_sparsity)
        search = search_mapping(graph, hw, cfg.w_bits, cfg.a_bits,
                                groups=groups, alphas=alphas, uniform=True)
    sim_tile = search.best.candidate.tile
    if cache is not None:
        hit = cache.get(key)
        if hit is not None:
            return AutotuneResult(tuple(hit["best_tile"]), sim_tile,
                                  [], True, key, backend)
    if not allow_measure:
        return AutotuneResult(sim_tile, sim_tile, [], False, key, backend)

    shapes = projection_shapes(cfg)
    ranked = sorted(search.table, key=lambda r: r.fps, reverse=True)
    seen: set = set()
    shortlist = []
    for r in ranked:
        if r.candidate.tile not in seen:
            seen.add(r.candidate.tile)
            shortlist.append(r)
        if len(shortlist) >= max(top_n, 1):
            break
    table = []
    for r in shortlist:
        row = measure_tile(shapes, r.candidate.tile, target_sparsity,
                           w_bits=cfg.w_bits, a_bits=cfg.a_bits,
                           prefill_rows=prefill_rows,
                           decode_rows=decode_rows, repeats=repeats,
                           stack_layers=stack_layers, timer=timer, hw=hw,
                           device=dev)
        row["sim_fps"] = round(r.fps, 2)
        row["sim_cycles"] = round(r.cycles, 1)
        table.append(row)
    best = min(table, key=lambda row: row["total_s"])
    result = AutotuneResult(tuple(best["tile"]), sim_tile, table, False,
                            key, backend)
    if cache is not None:
        cache.put(key, result)
    return result
