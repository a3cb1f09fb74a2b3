"""Padded ELL/BSR packing of a 2-D weight for the block-sparse kernel
(numpy, host side)."""
from __future__ import annotations

import dataclasses

import numpy as np


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
