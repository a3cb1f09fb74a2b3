"""Macro allocation: surviving group-sets -> the 4 cores x 2 macros fabric.

The paper stores a layer's nonzero group-sets densely in the macros
(Fig. 5b); what it does not spell out is *which* core gets which
kernel-group when survival counts are ragged. This allocator:

  * assigns kernel-groups (columns of alpha kernels) to cores with LPT
    greedy load balancing on surviving group-set counts - a kernel-group
    never splits across cores because its alpha kernels share one set of
    bit-lines / one APW accumulation;
  * tracks macro residency: each core's share is cut into reload *waves*
    of at most one macro's capacity, so the simulator can ping-pong the
    two macros (compute from one while the write port refills the other);
  * reports partition occupancy so utilization is visible per macro.

Conservation is a hard invariant: every surviving group-set is placed in
exactly one (core, wave) slot - ``verify_conservation`` checks it and the
test suite enforces it.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from ..core.mapping import GroupsetPacking
from ..core.perf_model import DEFAULT_HW, HardwareConfig

from .graph import LayerNode


@dataclasses.dataclass
class CoreAssignment:
    """One core's share of a layer."""

    core: int
    kernel_groups: List[int]  # output-group columns owned by this core
    nnz: int  # surviving group-sets assigned
    waves: List[int]  # group-sets per reload wave (<= one macro's capacity)

    @property
    def n_waves(self) -> int:
        return len(self.waves)


@dataclasses.dataclass
class LayerAllocation:
    name: str
    nnz_total: int
    capacity_per_macro: int  # group-sets resident in ONE macro buffer
    assignments: List[CoreAssignment]
    group: int
    alpha: int
    w_bits: int

    @property
    def reload_waves(self) -> int:
        return max((a.n_waves for a in self.assignments), default=0)

    @property
    def placed(self) -> int:
        return sum(a.nnz for a in self.assignments)

    @property
    def imbalance(self) -> float:
        """max core load / mean core load (1.0 = perfectly balanced)."""
        loads = [a.nnz for a in self.assignments]
        mean = sum(loads) / max(len(loads), 1)
        return max(loads) / mean if mean > 0 else 1.0

    @property
    def macro_occupancy(self) -> float:
        """Busiest wave's fill fraction of one macro buffer."""
        busiest = max((max(a.waves, default=0) for a in self.assignments),
                      default=0)
        return min(1.0, busiest / max(self.capacity_per_macro, 1))


def allocate_counts(counts: Sequence[int], hw: HardwareConfig = DEFAULT_HW,
                    w_bits: int = 8, group: Optional[int] = None,
                    alpha: Optional[int] = None, name: str = "") -> LayerAllocation:
    """Place per-kernel-group survival ``counts`` onto the macro fabric.

    LPT greedy: kernel-groups sorted by descending count, each assigned to
    the currently least-loaded core. Guarantees max load <= (4/3 - 1/3m) x
    optimum, plenty for the <= 2x count skew real layers show.
    """
    g = hw.group if group is None else group
    a = hw.alpha if alpha is None else alpha
    counts = np.asarray(counts, dtype=np.int64)
    cap = hw.capacity_groupsets(w_bits, g, a, macros=1)
    order = np.argsort(-counts, kind="stable")
    loads = np.zeros(hw.cores, dtype=np.int64)
    owned: List[List[int]] = [[] for _ in range(hw.cores)]
    for j in order:
        if counts[j] == 0:
            continue
        c = int(np.argmin(loads))
        owned[c].append(int(j))
        loads[c] += counts[j]
    assignments = []
    for c in range(hw.cores):
        nnz = int(loads[c])
        waves = [cap] * (nnz // cap)
        if nnz % cap:
            waves.append(nnz % cap)
        assignments.append(CoreAssignment(c, sorted(owned[c]), nnz, waves))
    return LayerAllocation(name, int(counts.sum()), cap, assignments,
                           g, a, w_bits)


def allocate_node(node: LayerNode, hw: HardwareConfig = DEFAULT_HW,
                  w_bits: int = 8, group: Optional[int] = None,
                  alpha: Optional[int] = None,
                  dense: bool = False) -> LayerAllocation:
    g = hw.group if group is None else group
    a = hw.alpha if alpha is None else alpha
    counts = node.kernel_group_counts(g, a, dense=dense)
    return allocate_counts(counts, hw, w_bits, g, a, name=node.name)


def allocate_packing(p: GroupsetPacking, hw: HardwareConfig = DEFAULT_HW,
                     w_bits: int = 8, group: Optional[int] = None,
                     alpha: Optional[int] = None,
                     name: str = "") -> LayerAllocation:
    """Allocate directly from a ``pack_groupsets`` artifact (the paper
    path): survival counts come from the packed index codes."""
    go = int(p.channel_pos.max(initial=-1)) + 1
    counts = np.bincount(p.channel_pos, minlength=max(go, 1))
    return allocate_counts(counts, hw, w_bits, group, alpha, name=name)


def device_assignment(counts: Sequence[int], n_devices: int) -> np.ndarray:
    """Kernel-group columns -> serving devices: the LPT policy of
    ``allocate_counts``, constrained to equal cardinality per device.

    A serving mesh plays the role of the macro cluster, but unlike
    the paper's cores a column shard must hold the SAME number of
    block columns on every device (equal-shaped shards). So: columns sorted
    by descending surviving-block count, each placed on the least-loaded
    device that still has column slots free. Requires
    ``len(counts) % n_devices == 0``; returns the (n_columns,) device id
    per column. Every column is placed exactly once, every device owns
    exactly ``n_columns / n_devices`` columns, and the nnz imbalance is
    never worse than the contiguous split's.
    """
    counts = np.asarray(counts, dtype=np.int64)
    go = counts.shape[0]
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if go % n_devices:
        raise ValueError(
            f"{go} kernel-group columns do not split evenly over "
            f"{n_devices} devices")
    slots = go // n_devices
    loads = np.zeros(n_devices, dtype=np.int64)
    owned = np.zeros(n_devices, dtype=np.int64)
    dev = np.zeros(go, dtype=np.int32)
    for j in np.argsort(-counts, kind="stable"):
        open_devs = np.flatnonzero(owned < slots)
        d = open_devs[np.argmin(loads[open_devs])]
        dev[j] = d
        loads[d] += counts[j]
        owned[d] += 1
    return dev


def verify_conservation(alloc: LayerAllocation) -> bool:
    """Every surviving group-set placed exactly once; waves cover loads."""
    if alloc.placed != alloc.nnz_total:
        return False
    all_kgs: List[int] = []
    for a in alloc.assignments:
        if sum(a.waves) != a.nnz:
            return False
        if any(w <= 0 or w > alloc.capacity_per_macro for w in a.waves):
            return False
        all_kgs.extend(a.kernel_groups)
    return len(all_kgs) == len(set(all_kgs))
