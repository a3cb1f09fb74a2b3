"""Block-sparse int8 matmul: the CUDA kernel's wrappers, its launch plan
and its plain version.

``csrc/bsr_matmul.cu`` replaces the Pallas TPU kernels ``bsr_matmul`` and
``bsr_matmul_stacked`` of ``repro/kernels/cim_bsr_matmul.py`` with ONE
layer-indexed kernel; ``bsr_matmul`` here is its L = 1 case with layer 0.

Layout (column-major ELL, from ``core.mapping.pack_bsr``):
  x:       (M, K)                       f32 or bf16
  blocks:  (L, go, nnz_max, bk, bn)     int8 packed nonzero blocks
  scales:  (L, go, nnz_max)             f32 per-block scale
  row_idx: (L, go, nnz_max)             int32 k-block index per slot
  nnz:     (L, go)                      int32 true slot counts (may exceed
                                        nnz_max in a truncated packing)
  layer:   (1,) int32 device tensor, or a Python int
  out:     (M, go*bn)                   f32

The kernel runs on the bf16 tensor cores (int8 levels are exact in bf16).
f32 x is first copied to bf16 with a flag saying whether the copy is
exact; the kernel multiplies the copy where it is (eq. 5 activations), and
f32 x as three bf16 planes where it is not, without a host sync. ``plan``
picks the tile height and S, the slots per split: each column's slots are
cut into runs of S, each run's partial sums go to a workspace, and a
second kernel adds them in run order. S reads M, K / bk, go, bn and the SM
count, never ``nnz_max``, ``nnz``, L or the layer, so a layer's own
packing and the padded envelope it sits in are cut alike and give the
same bits. A wrapper takes the plain version only for tensors on
the CPU. For CUDA tensors it launches the kernel or raises; ``LAUNCHES``
counts the launches, ``LAUNCHES_BY_ENTRY`` splits them by entry point and
``LAUNCHES_BY_PATH`` by split-K ("split" or "single") and load path
("aligned", 16-byte asynchronous copies, or "masked").

Macro sharding (the reference's ``bsr_matmul_sharded`` and
``bsr_matmul_stacked_sharded``, ``shard_map`` wrappers around the Pallas
bodies): the ``go`` block columns are split over the macros of a serving
mesh, each macro holding its own shard on its own device. The sharded
entry points launch the kernel once a macro on that macro's shard (its
``nnz`` is the macro's own occupancy) and gather the outputs along N, in
macro order, on the first macro's device: the reference's tiled
all-gather. Each launch is planned from the LOGICAL ``go``, the columns of
all shards together, so a shard runs the S and split count of the
unsharded call and its columns come out bit for bit as there. The
output's columns are in macro order; callers un-permute them.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from ..device import PLAIN_DEVICES
from . import _build

MACRO_AXIS = "macro"  # the serving mesh's axis (launch.shardings)

LAUNCHES = 0
LAUNCHES_BY_ENTRY: Dict[str, int] = {
    "bsr_matmul": 0, "bsr_matmul_stacked": 0, "bsr_matmul_sharded": 0,
    "bsr_matmul_stacked_sharded": 0}
LAUNCHES_BY_PATH: Dict[str, int] = {
    f"{s} {p}": 0 for s in ("single", "split") for p in ("aligned", "masked")}

_LIB = None
_LAYER_CONST: Dict[tuple, torch.Tensor] = {}
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)

Layer = Union[int, torch.Tensor]
# one macro's shard: (blocks, scales, row_idx, nnz), stacked or single-layer
Shard = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

# the kernel's tiling (csrc/bsr_matmul.cu): BN output columns per block, BK
# rows of a block's K per pipeline stage, a ring of STAGES bf16 stages (the
# f32 path fits fewer into the same bytes), padded shared-memory rows, at
# most MAX_SLOTS slots per split (their row offsets and scales sit in shared
# memory), the resident blocks per SM the launch bounds hold registers to,
# and at most MAX_PRE blocks for the pass that copies f32 x to bf16
BN, BK, STAGES, MAX_SLOTS, MAX_PRE = 128, 64, 4, 128, 128
MIN_BLOCKS = {16: 4, 64: 2}
_X_PITCH, _W_PITCH = BK + 8, BN + 16
SMS = 132  # streaming multiprocessors of an H100 SXM
WAVES = 2  # resident-block waves the splits aim to fill, columns taken dense
_SMEM_PER_SM, _SMEM_RESERVED = 233472, 1024  # per SM, and kept per block


@dataclasses.dataclass(frozen=True)
class Plan:
    bm: int          # output rows per block (16 or 64)
    slots: int       # S: slots per split
    path: str        # "aligned" (16-byte cp.async) or "masked"
    copy: bool       # f32 x copied to bf16 first (used where it is exact)
    smem_bytes: int  # dynamic shared memory per block
    blocks_per_sm: int  # resident blocks an SM holds

    def splits(self, nnz_max: int) -> int:
        """Splits for a packing with ``nnz_max`` slots per column: every
        slot in one. Splits past a column's count add exact zeros."""
        return max(1, -(-nnz_max // self.slots))


@functools.lru_cache(maxsize=1024)
def plan(m: int, k_blocks: int, go: int, bn: int, x_dtype: torch.dtype,
         aligned: bool, copy: bool = False) -> Plan:
    """The kernel's launch plan for (m, K) x a packing with ``k_blocks`` =
    K / bk block rows and ``go`` block columns of width ``bn``; ``copy``
    records whether f32 x goes through its bf16 copy (``launch_plan``).

    The tile height follows M: one m16 tile up to 16 rows (decode), else
    64. The output tiles are the row tiles times ``go`` times the 128-column
    tiles of a block column. S is set so that, were every column to hold
    all ``k_blocks`` slots, the splits would fill ``WAVES`` waves of
    resident blocks (``SMS`` times the blocks an SM holds: shared memory,
    threads and the launch bounds' registers); at least 1 and at most
    ``MAX_SLOTS``. Nothing here reads the packing's slot count or its data:
    that is what keeps loop = scan bit for bit."""
    if x_dtype not in _KERNEL_DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x_dtype}")
    bm = 16 if m <= 16 else 64
    threads = BN * (1 if bm == 16 else 2)  # a warp per 32 columns, 2 down
    smem = STAGES * (bm * _X_PITCH * 2 + BK * _W_PITCH) + MAX_SLOTS * 8
    per_sm = min(_SMEM_PER_SM // (smem + _SMEM_RESERVED), 2048 // threads,
                 MIN_BLOCKS[bm])
    tiles = -(-m // bm) * go * -(-bn // BN)
    want = -(-WAVES * SMS * per_sm // tiles)  # splits wanted, columns dense
    slots = max(1, min(MAX_SLOTS, -(-k_blocks // want)))
    return Plan(bm, slots, "aligned" if aligned else "masked", copy, smem,
                per_sm)


def is_aligned(x: torch.Tensor, blocks: torch.Tensor) -> bool:
    """Whether the 16-byte path can take the operands: x and blocks 16-byte
    aligned, x's rows (K) and a block's rows of x (bk) whole 16-byte
    chunks, and bn a multiple of 16 (every int8 block row starts on 16
    bytes). The output and the workspace come from ``torch.empty``, which
    aligns them."""
    elem = x.element_size()
    bk, bn = blocks.shape[-2:]
    return (x.data_ptr() % 16 == 0 and blocks.data_ptr() % 16 == 0
            and (x.shape[1] * elem) % 16 == 0 and (bk * elem) % 16 == 0
            and bn % 16 == 0)


def launch_plan(x: torch.Tensor, blocks: torch.Tensor,
                go: Optional[int] = None) -> Tuple[Plan, int]:
    """(plan, splits) of a call, from shapes and pointers alone (no device
    read, so no host sync). f32 x on the 16-byte path is copied to bf16 when
    the copy's rows are 16-byte chunks too (K and bk multiples of 8). ``go``
    (default: the blocks' own) is the block columns the plan is made for: a
    macro's shard passes the whole projection's."""
    _, go_own, nmax, bk, bn = blocks.shape
    k = int(x.shape[1])
    aligned = is_aligned(x, blocks)
    copy = (x.dtype == torch.float32 and aligned and k % 8 == 0
            and bk % 8 == 0)
    p = plan(int(x.shape[0]), k // bk, go_own if go is None else int(go),
             bn, x.dtype, aligned, copy)
    return p, p.splits(nmax)


def _copy_blocks(m: int, k: int) -> int:
    """Blocks of the pass that copies f32 x to bf16 (4 elements a thread,
    1024 threads a block)."""
    return max(1, min(MAX_PRE, -(-(m * k // 4) // 1024)))


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0
    for counts in (LAUNCHES_BY_ENTRY, LAUNCHES_BY_PATH):
        for k in counts:
            counts[k] = 0


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("bsr_matmul")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bsr_matmul_launch.argtypes = [p, i, p, p, i, p, p, p, p, p,
                                          p, p, i, i, i, i, i, i, i,
                                          i, i, i, i, i, p]
        lib.bsr_matmul_launch.restype = i
        lib.bsr_matmul_error_string.argtypes = [i]
        lib.bsr_matmul_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(x, blocks, scales, row_idx, nnz) -> None:
    if x.dim() != 2 or blocks.dim() != 5:
        raise ValueError(f"x must be (M, K) and blocks (L, go, nnz_max, bk, "
                         f"bn), got {tuple(x.shape)} and {tuple(blocks.shape)}")
    n_l, go, nmax, bk, bn = blocks.shape
    if x.shape[1] % bk:
        raise ValueError(f"K={x.shape[1]} is not a multiple of bk={bk}")
    if (tuple(scales.shape) != (n_l, go, nmax)
            or tuple(row_idx.shape) != (n_l, go, nmax)
            or tuple(nnz.shape) != (n_l, go)):
        raise ValueError("scales/row_idx/nnz do not match the blocks' "
                         f"geometry {tuple(blocks.shape)}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    want = ((blocks, torch.int8), (scales, torch.float32),
            (row_idx, torch.int32), (nnz, torch.int32))
    for t, dt in want:
        if t.dtype != dt:
            raise TypeError(f"expected {dt}, got {t.dtype}")


def dense_weight(blocks: torch.Tensor, scales: torch.Tensor,
                 row_idx: torch.Tensor, nnz: torch.Tensor, layer: Layer,
                 k: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Layer ``layer``'s dense (K, N) weight in ``dtype``, rebuilt from
    ``blocks * scales`` over the slots ``s < min(nnz, nnz_max)``. Padding
    slots are masked, never trusted to be zero."""
    li = int(layer.reshape(-1)[0]) if torch.is_tensor(layer) else int(layer)
    _, go, nmax, bk, bn = blocks.shape
    dev = blocks.device
    valid = (torch.arange(nmax, device=dev)[None, :]
             < nnz[li].clamp(max=nmax)[:, None])  # (go, nmax)
    wb = torch.where(valid[..., None, None],
                     blocks[li].to(dtype) * scales[li].to(dtype)[..., None,
                                                                 None], 0.0)
    rows = torch.where(valid, row_idx[li], 0).long()
    cols = torch.arange(go, device=dev)[:, None].expand(go, nmax)
    w = torch.zeros((k // bk, go, bk, bn), dtype=dtype, device=dev)
    # accumulate: inert slots add exact zeros onto whatever block they hit
    w.index_put_((rows, cols), wb, accumulate=True)
    return w.permute(0, 2, 1, 3).reshape(k, go * bn)


def bsr_matmul_stacked_plain(x: torch.Tensor, blocks: torch.Tensor,
                             scales: torch.Tensor, row_idx: torch.Tensor,
                             nnz: torch.Tensor, layer: Layer) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``x @`` the selected layer's
    dense weight, summed in float64 and rounded once to float32. On the
    serving path (eq. 5 levels times int8 levels times a power-of-two
    scale) every product and partial sum is exact in float64, so the result
    is the same whatever the sum order: a library product picks its order
    from N, and an f32 sum would give a macro's shard other bits than the
    whole."""
    _check(x, blocks, scales, row_idx, nnz)
    w = dense_weight(blocks, scales, row_idx, nnz, layer, x.shape[1],
                     torch.float64)
    return (x.double() @ w).float()


def bsr_matmul_sharded_plain(x: torch.Tensor, shards: Sequence[Shard]
                             ) -> torch.Tensor:
    """Plain version of :func:`bsr_matmul_sharded`: the plain product per
    shard, concatenated in macro order on x's device."""
    return torch.cat([bsr_matmul_stacked_plain(
        x.to(s[0].device), *(a[None] for a in s), 0).to(x.device)
        for s in shards], dim=1)


def bsr_matmul_stacked_sharded_plain(x: torch.Tensor,
                                     shards: Sequence[Shard], layer: Layer
                                     ) -> torch.Tensor:
    """Plain version of :func:`bsr_matmul_stacked_sharded`."""
    return torch.cat([bsr_matmul_stacked_plain(
        x.to(s[0].device), *s, layer).to(x.device) for s in shards], dim=1)


def _layer_tensor(layer: Layer, device: torch.device) -> torch.Tensor:
    if torch.is_tensor(layer):
        if (layer.dtype != torch.int32 or layer.numel() != 1
                or layer.device != device or not layer.is_contiguous()):
            raise ValueError("layer must be a contiguous (1,) int32 tensor "
                             "on the activations' device")
        return layer
    key = (device, int(layer))
    if key not in _LAYER_CONST:
        _LAYER_CONST[key] = torch.tensor([int(layer)], dtype=torch.int32,
                                         device=device)
    return _LAYER_CONST[key]


def _run(entry, x, blocks, scales, row_idx, nnz, layer: Layer,
         plan_go: Optional[int] = None):
    """One call: the plain version for CPU (or meta) tensors, else one
    launch, planned for ``plan_go`` block columns (``launch_plan``;
    default the blocks' own)."""
    _check(x, blocks, scales, row_idx, nnz)
    if not x.is_cuda:
        if x.device.type in PLAIN_DEVICES:
            return bsr_matmul_stacked_plain(x, blocks, scales, row_idx, nnz,
                                            layer)
        raise ValueError(f"unsupported device {x.device}")
    args = (x, blocks, scales, row_idx, nnz)
    if any(t.device != x.device for t in args):
        raise ValueError("all operands must lie on one CUDA device")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("bsr_matmul operands must be contiguous")
    lt = _layer_tensor(layer, x.device)
    m, k = x.shape
    n_l, go, nmax, bk, bn = blocks.shape
    y = x.new_empty((m, go * bn), dtype=torch.float32)
    if m == 0 or go == 0:
        return y
    p, splits = launch_plan(x, blocks, plan_go)
    # one workspace on the caller's stream: the splits' partial sums, then
    # f32 x's bf16 copy and the copy pass's flags
    n = go * bn
    part = 4 * splits * m * n if splits > 1 else 0
    copy = -(-2 * m * k // 16) * 16 if p.copy else 0
    n_pre = _copy_blocks(m, k) if p.copy else 0
    work = (x.new_empty((part + copy + 4 * n_pre,), dtype=torch.uint8)
            if part + copy else None)
    base = None if work is None else work.data_ptr()
    lib = _lib()
    dev = x.get_device()
    # the raw handle of the current stream (torch.cuda.current_stream()
    # builds a Stream object, several us of host time per launch)
    err = lib.bsr_matmul_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16),
        base + part if p.copy else None,
        base + part + copy if p.copy else None, n_pre, blocks.data_ptr(),
        scales.data_ptr(), row_idx.data_ptr(), nnz.data_ptr(), lt.data_ptr(),
        y.data_ptr(), base if part else None, m, k, n_l, go, nmax, bk, bn,
        p.bm, p.slots, splits, int(p.path == "aligned"), dev,
        torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: "
                           f"{lib.bsr_matmul_error_string(err).decode()}")
    global LAUNCHES
    LAUNCHES += 1
    LAUNCHES_BY_ENTRY[entry] += 1
    LAUNCHES_BY_PATH[f"{'split' if splits > 1 else 'single'} {p.path}"] += 1
    return y


def bsr_matmul_stacked(x: torch.Tensor, blocks: torch.Tensor,
                       scales: torch.Tensor, row_idx: torch.Tensor,
                       nnz: torch.Tensor, layer: Layer) -> torch.Tensor:
    """y = x @ W[layer] for a layer-stacked packing; the layer id is read
    on the device."""
    return _run("bsr_matmul_stacked", x, blocks, scales, row_idx, nnz, layer)


def bsr_matmul(x: torch.Tensor, blocks: torch.Tensor, scales: torch.Tensor,
               row_idx: torch.Tensor, nnz: torch.Tensor) -> torch.Tensor:
    """y = x @ W for a single-layer packing: blocks (go, nnz_max, bk, bn),
    scales/row_idx (go, nnz_max), nnz (go,)."""
    return _run("bsr_matmul", x, blocks[None], scales[None], row_idx[None],
                nnz[None], 0)


def _sharded(entry, x: torch.Tensor, shards: Sequence[Shard],
             layer: Layer) -> torch.Tensor:
    """One launch a macro on its shard and device (x and the layer id
    copied there when the macro is on another device than x), each planned
    for all shards' columns; the outputs concatenated in macro order on
    x's device."""
    if not shards:
        raise ValueError("a sharded call needs at least one shard")
    go = sum(int(s[0].shape[1]) for s in shards)
    ys = []
    for s in shards:
        dev = s[0].device
        lt = layer.to(dev) if torch.is_tensor(layer) else layer
        ys.append(_run(entry, x.to(dev), *s, lt, plan_go=go).to(x.device))
    return torch.cat(ys, dim=1)


def bsr_matmul_stacked_sharded(x: torch.Tensor, shards: Sequence[Shard],
                               layer: Layer) -> torch.Tensor:
    """The reference's ``bsr_matmul_stacked_sharded``: ``shards[d]`` is
    macro d's (blocks (L, go_d, nnz_max, bk, bn), scales, row_idx, nnz) on
    its device; x and the layer id are replicated. y is (M, go * bn), its
    columns in macro order."""
    return _sharded("bsr_matmul_stacked_sharded", x, shards, layer)


def bsr_matmul_sharded(x: torch.Tensor, shards: Sequence[Shard]
                       ) -> torch.Tensor:
    """The reference's ``bsr_matmul_sharded``: the single-layer form, each
    shard's blocks (go_d, nnz_max, bk, bn)."""
    return _sharded("bsr_matmul_sharded", x,
                    [tuple(a[None] for a in s) for s in shards], 0)
