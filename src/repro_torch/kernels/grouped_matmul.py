"""Grouped float product whose rows do not depend on the row count: the
CUDA kernel's wrapper, launch plan and plain version.

    y[g, r, :] = x[g, r, :] @ w[g]      x (G, R, K), w (G, K, N)

``csrc/grouped_matmul.cu`` replaces no Pallas kernel: the reference leaves
these products to XLA as plain jnp (the MoE router and expert einsums of
``repro/models/layers.py:moe_block``, a float LM head). The port needs a
kernel of its own for them because the library product picks its sum
order from the row count on the card, and the paged pass promises that a
T-token verify gives each position exactly what T one-token steps give
(``serve/deployed.py``). The kernel's launch plan (:func:`plan`) is chosen
from the two types, K and N alone, so each row's sum runs in an order that
R, ``counts``, the other rows and the row tile cannot change: bf16 weights
on the tensor cores (f32 x as three exact bf16 planes, 32-term steps folded
into an error-carrying f32 sum), f32 routers on the CUDA cores (fused
multiply-add chains over fixed K slices, combined by a fixed butterfly).
The source's header has the design.

Types: (x, w) in (f32, f32), (f32, bf16) or (bf16, bf16), y in x's type,
f32 accumulation; a bf16 w under f32 x computes ``x @ w.float()`` without
the widened copy, and an f32 w under bf16 x is rounded to bf16 first, as
``x @ w.to(x.dtype)`` does. ``counts`` (G,) int, when given, is each
group's number of filled rows: rows at or past it come out as zeros.

The wrapper takes the plain version only for tensors on the CPU (or the
meta device, shapes only); for CUDA
tensors it launches the kernel (one launch a call) or raises.
``LAUNCHES`` counts the launches.

Gradients. When grad mode is on and x or w requires a gradient, both
``grouped_matmul`` and ``grouped_matmul_plain`` run through an autograd
Function whose forward is the call above (the kernel's launch is
unchanged) and whose backward computes, in the product's type,

    dx[g] = dy[g] @ w[g]^T      dw[g] = x[g]^T @ dy[g]

with dy's rows at or past ``counts[g]`` taken as zeros (those outputs are
constant), so those rows of dx are zero and add nothing to dw; dw comes
back in w's type. The reference leaves these products to XLA's autodiff
of its plain einsums (``repro/models/layers.py:352,395-398``); here they
are two ``torch.bmm`` over strided views on both devices. The moe
training's backward needs no row invariance: its rows are each step's
own. Otherwise the wrapper saves nothing and runs the forward alone.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from ..device import PLAIN_DEVICES
from . import _build

LAUNCHES = 0

_LIB = None
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)

# the tensor-core route (the source's constants): two consumer
# warpgroups of 64 output columns a block, up to 48 rows a block in row
# tiles of 16, a step of two stages between folds, one block an SM; K a
# stage and the ring's depth by x's type
WG_COLS = 128
WG_ROWS = 48
WG_ROW_TILE = 16
WG_FOLD = 2
WG_THREADS = 288
WG_STAGE_K = {torch.float32: 64, torch.bfloat16: 128}
WG_STAGES = {torch.float32: 6, torch.bfloat16: 4}
# the CUDA-core route: blocks of WARP_THREADS, one block more in a row's
# cluster for every CLUSTER_K of K, at most MAX_CLUSTER
WARP_THREADS = 128
CLUSTER_K = 512
MAX_CLUSTER = 8


@dataclasses.dataclass(frozen=True)
class Plan:
    """The launch plan of one (x type, w type, K, N). ``route``: "wgmma"
    (bf16 w on the tensor cores) or "warp" (f32 x and w on the CUDA cores).
    ``planes``: bf16 planes of x on the tensor cores (3 for f32 x, 1 for
    bf16), 0 on the CUDA cores. ``cols``/``rows``: a block's output columns
    and rows at most; ``row_tile``: rows a wgmma row tile; ``stage_k``: K a
    pipeline stage on the tensor cores, the K stride of a thread's chain on
    the CUDA cores; ``step_k``: K between folds into the error-carrying sum
    (0 on the CUDA cores); ``stages``: the ring's depth; ``threads`` and
    ``smem`` a block's; ``cluster``: blocks of a thread block cluster (the
    CUDA-core route splits a row's K over them). The same fields, in this
    order, are what the built library's ``grouped_matmul_describe`` gives
    (see :func:`describe`)."""
    route: str
    planes: int
    cols: int
    rows: int
    row_tile: int
    stage_k: int
    step_k: int
    stages: int
    threads: int
    smem: int
    cluster: int

    def fields(self) -> Tuple[int, ...]:
        return (int(self.route == "warp"), self.planes, self.cols, self.rows,
                self.row_tile, self.stage_k, self.step_k, self.stages,
                self.threads, self.smem, self.cluster)


def _wgmma_smem(x_dtype: torch.dtype) -> int:
    """The source's Cfg::kSmem: the w and raw x rings, two planes buffers,
    the barriers and 1024 bytes to align the base."""
    sk, st = WG_STAGE_K[x_dtype], WG_STAGES[x_dtype]
    planes = (3 if x_dtype == torch.float32 else 1) * WG_ROWS * sk * 2
    w = sk * WG_COLS * 2
    x = WG_ROWS * sk * (4 if x_dtype == torch.float32 else 2)
    return st * (w + x) + 2 * planes + 2 * st * 8 + 1024


@functools.lru_cache(maxsize=256)
def plan(x_dtype: torch.dtype, w_dtype: torch.dtype, k: int, n: int) -> Plan:
    """The kernel's launch plan: from the two types (w in the type the
    product reads it in, see ``_check``), K and N, and nothing else. R and
    ``counts`` only decide how many blocks run, which row tiles a block
    issues and which rows it writes, so no row's order of operations can
    depend on them.

    f32 x over f32 w takes the CUDA-core route: a cluster of blocks a row
    and a chunk of 8, 16 or 32 columns (from N), one block for every
    CLUSTER_K of K, at most MAX_CLUSTER; thread t of the cluster's T chains
    k = t, t + T, ... Every other pair takes the tensor-core route, whose
    tiles and schedule follow x's type alone."""
    for dt in (x_dtype, w_dtype):
        if dt not in _KERNEL_DTYPES:
            raise TypeError(f"the grouped_matmul kernel takes float32 or "
                            f"bfloat16, got {dt}")
    if x_dtype == torch.float32 and w_dtype == torch.float32:
        cl = min(MAX_CLUSTER, max(1, -(-k // CLUSTER_K)))
        cols = 8 if n <= 8 else 16 if n <= 16 else 32
        return Plan("warp", 0, cols, 1, 1, WARP_THREADS * cl, 0, 0,
                    WARP_THREADS, 0, cl)
    if w_dtype != torch.bfloat16:
        raise TypeError(f"a {x_dtype} x takes a bfloat16 w, got {w_dtype}")
    sk = WG_STAGE_K[x_dtype]
    return Plan("wgmma", 3 if x_dtype == torch.float32 else 1, WG_COLS,
                WG_ROWS, WG_ROW_TILE, sk, sk * WG_FOLD, WG_STAGES[x_dtype],
                WG_THREADS, _wgmma_smem(x_dtype), 1)


def launch_plan(x: torch.Tensor, w: torch.Tensor,
                counts: Optional[torch.Tensor] = None) -> Plan:
    """:func:`plan` of a call, from its shapes and types alone: ``counts``
    is taken only to show that it does not enter, and R never does."""
    w = _check(x, w, counts)
    return plan(x.dtype, w.dtype, int(x.shape[2]), int(w.shape[2]))


def describe(x_dtype: torch.dtype, w_dtype: torch.dtype, k: int,
             n: int) -> Tuple[int, ...]:
    """The built library's own plan of these types and shapes, the fields
    of :class:`Plan` in order (a check that :func:`plan` mirrors it)."""
    out = (ctypes.c_int * 11)()
    _lib().grouped_matmul_describe(int(x_dtype == torch.bfloat16),
                                   int(w_dtype == torch.bfloat16), k, n, out)
    return tuple(out)


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("grouped_matmul")
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.grouped_matmul_launch.argtypes = [p, p, p, p, i, i, i, i, i64,
                                              i64, i64, i64, i, i, p]
        lib.grouped_matmul_launch.restype = i
        lib.grouped_matmul_describe.argtypes = [i, i, i, i, p]
        lib.grouped_matmul_describe.restype = None
        lib.grouped_matmul_error_string.argtypes = [i]
        lib.grouped_matmul_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(x: torch.Tensor, w: torch.Tensor,
           counts: Optional[torch.Tensor]) -> torch.Tensor:
    """Shapes checked; returns w in the type the product reads it in."""
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] or (
            x.shape[2] != w.shape[1]):
        raise ValueError(f"x (G, R, K) and w (G, K, N), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if not x.is_floating_point() or not w.is_floating_point():
        raise TypeError(f"grouped_matmul takes floating tensors, got "
                        f"{x.dtype} and {w.dtype}")
    if counts is not None and counts.shape != (x.shape[0],):
        raise ValueError(f"counts must be ({x.shape[0]},), got "
                         f"{tuple(counts.shape)}")
    # w is read in x's type, as x @ w.to(x.dtype); a bf16 w under f32 x
    # widens exactly, so it is left as it is
    keep = w.dtype == x.dtype or (x.dtype == torch.float32
                                  and w.dtype == torch.bfloat16)
    return w if keep else w.to(x.dtype)


def _filled(r: int, counts: torch.Tensor) -> torch.Tensor:
    """(G, r, 1) bool: the rows below each group's count."""
    return (torch.arange(r, device=counts.device)[None, :]
            < counts[:, None])[..., None]


def _plain_product(x: torch.Tensor, w: torch.Tensor,
                   counts: Optional[torch.Tensor]) -> torch.Tensor:
    """The plain version's arithmetic on a checked w (see
    :func:`grouped_matmul_plain`)."""
    r = x.shape[1]
    y = torch.bmm(x.expand(-1, 2, -1) if r == 1 else x,
                  w.to(x.dtype))[:, :r]
    if counts is not None:
        y = torch.where(_filled(r, counts), y, 0.0)
    return y.contiguous()


def _needs_grad(x: torch.Tensor, w: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)


class _GroupedMatmul(torch.autograd.Function):
    """The forward on the kernel (or the plain version); the backward's two
    products by ``torch.bmm`` (module docstring)."""

    @staticmethod
    def forward(ctx, x, w, counts, plain):
        ctx.save_for_backward(x, w, counts)
        return (_plain_product if plain else _launch)(x, w, counts)

    @staticmethod
    def backward(ctx, dy):
        x, w, counts = ctx.saved_tensors
        if counts is not None:
            dy = torch.where(_filled(dy.shape[1], counts), dy, 0.0)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.bmm(dy, w.to(x.dtype).transpose(1, 2))
        if ctx.needs_input_grad[1]:
            dw = torch.bmm(x.transpose(1, 2), dy).to(w.dtype)
        return dx, dw, None, None


def grouped_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                         counts: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Plain PyTorch version: ``torch.bmm(x, w.to(x.dtype))``, rows at or
    past ``counts`` zeroed. A one-row product is taken as two rows (the
    row repeated): the CPU library sends a single row to its
    matrix-vector routine, whose sum order differs from the matrix
    product's, and would break the rows' independence of R here.
    Differentiable through the wrapper's Function (module docstring)."""
    w = _check(x, w, counts)
    if _needs_grad(x, w):
        return _GroupedMatmul.apply(x, w, counts, True)
    return _plain_product(x, w, counts)


def _strides(t: torch.Tensor, inner_pad: int) -> Tuple[int, int]:
    """(group stride, row stride) in elements of a (G, rows, cols) operand
    whose last dimension is contiguous; a dimension of size 1 takes the
    stride it would have if padded rows of ``inner_pad`` followed."""
    g, rows, _ = t.shape
    row = t.stride(1) if rows > 1 else inner_pad
    return (t.stride(0) if g > 1 else rows * row), row


def _tma_operand(t: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
    """(t, group stride, row stride) such that the tensor-core route's
    tensor maps take it: 16-byte aligned, every stride a whole number of
    16 bytes. Otherwise a zero-padded copy with rows of a multiple of 8
    elements (for odd shapes only: the serving paths' operands pass)."""
    vec = 16 // t.element_size()
    cols = t.shape[2]
    pad = -(-cols // vec) * vec
    sg, sr = _strides(t, pad)
    if t.data_ptr() % 16 or sg % vec or sr % vec:
        p = -(-cols // 8) * 8
        c = t.new_zeros((t.shape[0], t.shape[1], p))
        c[..., :cols] = t
        t = c
        sg, sr = _strides(t, p)
    return t, sg, sr


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y[g] = x[g] @ w[g] in x's type (module docstring) on the kernel for
    CUDA tensors, the plain version for CPU (or meta) ones. ``x`` and
    ``w`` may be views whose rows are contiguous (strides of their own);
    other layouts are copied, as are operands the tensor maps cannot take.
    Differentiable (module docstring): the backward never launches."""
    if x.device.type in PLAIN_DEVICES:
        return grouped_matmul_plain(x, w, counts)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    w = _check(x, w, counts)
    if any(t is not None and t.device != x.device for t in (w, counts)):
        raise ValueError("all operands must lie on one CUDA device")
    if _needs_grad(x, w):
        return _GroupedMatmul.apply(x, w, counts, False)
    return _launch(x, w, counts)


def _launch(x: torch.Tensor, w: torch.Tensor,
            counts: Optional[torch.Tensor]) -> torch.Tensor:
    """One launch of the kernel on a checked w (see :func:`grouped_matmul`)."""
    pl = plan(x.dtype, w.dtype, int(x.shape[2]), int(w.shape[2]))
    g, r, k = x.shape
    n = w.shape[2]
    if x.stride(2) != 1:
        x = x.contiguous()
    if w.stride(2) != 1:
        w = w.contiguous()
    if counts is not None:
        counts = counts.to(torch.int32).contiguous()
    y = torch.empty((g, r, n), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    if k == 0:
        return y.zero_()
    if pl.route == "wgmma":
        x, sxg, sxr = _tma_operand(x)
        w, swg, swk = _tma_operand(w)
    else:
        sxg, sxr = _strides(x, k)
        swg, swk = _strides(w, n)
    lib = _lib()
    dev = x.get_device()
    err = lib.grouped_matmul_launch(
        x.data_ptr(), w.data_ptr(), y.data_ptr(),
        None if counts is None else counts.data_ptr(), g, r, k, n, sxg, sxr,
        swg, swk, int(x.dtype == torch.bfloat16),
        int(w.dtype == torch.bfloat16),
        torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        msg = lib.grouped_matmul_error_string(err).decode()
        raise RuntimeError(f"grouped_matmul kernel launch failed: {msg}")
    global LAUNCHES
    LAUNCHES += 1
    return y
