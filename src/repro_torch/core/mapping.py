"""Weight -> CIM macro mapping (paper §III.B), numpy, host side.

Two packers live here:

1. ``pack_groupsets`` - the paper's mapping: nonzero group-sets packed
   densely into the 64 Kb macros (Fig. 5b), each with a 16-bit index code
   (Fig. 6). The analytic perf model and the schedule search read it.

2. ``pack_bsr`` - the same zero-tile skipping as a padded block-sparse
   (ELL) format that the block-sparse kernel consumes; ``row_idx`` plays
   the role of the Index SRAM + SAS.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

# --- the adopted macro ([18], ISSCC'20 6T 64Kb): 8 partitions x 64 groups
# of 16 weights x 8b. Two macros/core -> alpha=16 kernels per cycle. ---
MACRO_BITS = 64 * 1024
PARTITIONS = 8
WLGROUPS = 64
GROUP = 16  # weights per weight-group (input/channel direction)
MACROS_PER_CORE = 2
CORES = 4


# ---------------------------------------------------------------------------
# Fig. 6 index code: [15] first-group flag | [14:9] #nonzero groups in kernel
#                    | [8:5] spatial position | [4:0] channel-group position
# ---------------------------------------------------------------------------


def encode_index(first: int, total: int, spatial: int, channel: int) -> int:
    assert 0 <= first <= 1 and 0 <= total < 64 and 0 <= spatial < 16 and 0 <= channel < 32
    return (first << 15) | (total << 9) | (spatial << 5) | channel


def decode_index(code: int) -> Tuple[int, int, int, int]:
    return (code >> 15) & 1, (code >> 9) & 0x3F, (code >> 5) & 0xF, code & 0x1F


@dataclasses.dataclass
class GroupsetPacking:
    """Result of packing one layer into the macros."""

    blocks: np.ndarray  # (nnz, GROUP, alpha) surviving group-sets
    codes: np.ndarray  # (nnz,) uint16 index codes
    spatial_pos: np.ndarray  # (nnz,) position in kernel order
    channel_pos: np.ndarray  # (nnz,) channel-group order
    n_total_groupsets: int
    capacity_groupsets: int  # how many group-sets fit in one core's macros
    reloads: int  # macro refills needed for the layer

    @property
    def nnz(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def index_bits(self) -> int:
        return self.nnz * 16

    @property
    def weight_bits_8b(self) -> int:
        return self.nnz * GROUP * self.blocks.shape[2] * 8


def pack_groupsets(w: np.ndarray, alpha: int = 16, group: int = GROUP) -> GroupsetPacking:
    """Pack a (d_in, d_out) (or HWIO conv reshaped by caller) weight.

    d_in is split into weight-groups of ``group``; d_out into kernel-groups
    of ``alpha``. A group-set = (group x alpha) tile; all-zero tiles are
    dropped (Fig. 5b) and survivors get Fig. 6 index codes.
    """
    d_in, d_out = w.shape
    gi = -(-d_in // group)
    go = -(-d_out // alpha)
    wp = np.zeros((gi * group, go * alpha), dtype=w.dtype)
    wp[:d_in, :d_out] = w
    tiles = wp.reshape(gi, group, go, alpha).transpose(0, 2, 1, 3)  # gi,go,g,a

    blocks, codes, spos, cpos = [], [], [], []
    for j in range(go):  # kernel-group = 16 kernels mapped across partitions
        alive = [i for i in range(gi) if np.any(tiles[i, j])]
        for rank, i in enumerate(alive):
            blocks.append(tiles[i, j])
            # Fig. 6 fields: spatial = position within the 3x3 kernel order,
            # channel = channel-group order. For 2-D weights spatial=0.
            codes.append(
                encode_index(int(rank == 0), min(len(alive), 63), (i // 32) % 16, i % 32)
            )
            spos.append(i)
            cpos.append(j)

    nnz = len(blocks)
    blocks_arr = (
        np.stack(blocks) if nnz else np.zeros((0, group, alpha), dtype=w.dtype)
    )
    capacity = (MACRO_BITS * MACROS_PER_CORE) // (group * alpha * 8)  # 8b weights
    reloads = max(1, -(-nnz // max(capacity, 1)))
    return GroupsetPacking(
        blocks=blocks_arr,
        codes=np.asarray(codes, dtype=np.uint16),
        spatial_pos=np.asarray(spos, dtype=np.int32),
        channel_pos=np.asarray(cpos, dtype=np.int32),
        n_total_groupsets=gi * go,
        capacity_groupsets=capacity,
        reloads=reloads,
    )


def unpack_groupsets(p: GroupsetPacking, d_in: int, d_out: int, alpha: int = 16,
                     group: int = GROUP) -> np.ndarray:
    """Inverse of pack_groupsets (for round-trip tests)."""
    gi = -(-d_in // group)
    go = -(-d_out // alpha)
    w = np.zeros((gi * group, go * alpha), dtype=p.blocks.dtype)
    for b, i, j in zip(p.blocks, p.spatial_pos, p.channel_pos):
        w[i * group : (i + 1) * group, j * alpha : (j + 1) * alpha] = b
    return w[:d_in, :d_out]


# ---------------------------------------------------------------------------
# Block-sparse path: padded ELL/BSR format for the kernel
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BsrWeight:
    """Column-major ELL blocks: for each output block-column j, the nonzero
    input block rows (padded with 0 -> a zero block, mathematically inert).

    blocks:  (n_col_blocks, nnz_max, bk, bn)
    row_idx: (n_col_blocks, nnz_max) int32, padding entries = 0
    nnz:     (n_col_blocks,) true counts (may exceed nnz_max when truncated)
    """

    blocks: np.ndarray
    row_idx: np.ndarray
    nnz: np.ndarray
    bk: int
    bn: int
    d_in: int
    d_out: int

    @property
    def density(self) -> float:
        total = (self.d_in // self.bk) * (self.d_out // self.bn)
        return float(self.nnz.sum()) / max(total, 1)


def pack_bsr(w: np.ndarray, bk: int, bn: int,
             nnz_max: int | None = None) -> BsrWeight:
    """Pack (d_in, d_out) into the padded BSR format; d_in % bk == 0 and
    d_out % bn == 0 are required."""
    d_in, d_out = w.shape
    assert d_in % bk == 0 and d_out % bn == 0, (d_in, bk, d_out, bn)
    gi, go = d_in // bk, d_out // bn
    tiles = w.reshape(gi, bk, go, bn).transpose(2, 0, 1, 3)  # go, gi, bk, bn
    alive = np.any(tiles.reshape(go, gi, -1) != 0, axis=-1)  # go, gi
    counts = alive.sum(axis=1)
    if nnz_max is None:
        nnz_max = max(int(counts.max(initial=0)), 1)
    blocks = np.zeros((go, nnz_max, bk, bn), dtype=w.dtype)
    row_idx = np.zeros((go, nnz_max), dtype=np.int32)
    for j in range(go):
        rows = np.nonzero(alive[j])[0][:nnz_max]
        blocks[j, : len(rows)] = tiles[j, rows]
        row_idx[j, : len(rows)] = rows
    return BsrWeight(blocks, row_idx, counts.astype(np.int32), bk, bn,
                     d_in, d_out)


def bsr_to_dense(bw: BsrWeight) -> np.ndarray:
    w = np.zeros((bw.d_in, bw.d_out), dtype=bw.blocks.dtype)
    go = bw.d_out // bw.bn
    nnz_max = bw.row_idx.shape[1]
    for j in range(go):
        # nnz holds TRUE counts, which exceed the stored slots when the
        # packing was truncated with an explicit nnz_max
        for s in range(min(int(bw.nnz[j]), nnz_max)):
            i = int(bw.row_idx[j, s])
            w[i * bw.bk:(i + 1) * bw.bk, j * bw.bn:(j + 1) * bw.bn] = \
                bw.blocks[j, s]
    return w
