"""Dense int8-weight matmul with per-output-channel scales: the CUDA
kernel's wrapper and plain version.

``csrc/quant_matmul.cu`` replaces the Pallas TPU kernel ``quant_matmul`` of
``repro/kernels/quant_matmul.py``, the non-sparse CIM macro (the paper's
baseline): weights are int8 levels, activations stream through, and the
scale multiplies once per output channel after the K sum.

  x:     (M, K)  f32 or bf16
  w:     (K, N)  int8 levels
  scale: (N,)    f32
  out:   (M, N)  f32       y = (x @ w) * scale

The kernel runs on the bf16 tensor cores: int8 levels are exact in bf16,
and f32 x goes in as three bf16 planes whose sum is x (``split_bf16x3`` is
the CPU twin of that split). ``plan`` picks the tile height, the number of
K slices (split-K: partial sums in a workspace, added in slice order by a
second kernel, so the result is the same bits in every run) and
the load path: 16-byte asynchronous copies when ``is_aligned`` holds,
element-wise masked loads otherwise. Any M, N, K
works on either path; nothing is padded in memory. The wrapper takes the
plain version only for tensors on the CPU (or the meta device, shapes
only); for CUDA tensors it launches the kernel or raises. ``LAUNCHES``
counts entry-point calls that launched,
``LAUNCHES_BY_PATH`` the same calls by load path.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..device import PLAIN_DEVICES
from . import _build

LAUNCHES = 0
LAUNCHES_BY_PATH = {"aligned": 0, "masked": 0}

_LIB = None
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)

# the kernel's tiling (csrc/quant_matmul.cu): kBN output columns per block,
# kBK of K per pipeline stage, kStages stages, padded shared-memory rows
BN, BK, STAGES = 128, 64, 4
_X_PITCH, _W_PITCH = BK + 8, BN + 16
SMS = 132  # streaming multiprocessors of an H100 SXM
MIN_SLICE_STAGES = 4  # a K slice is at least this many stages when it can be
SMEM_LIMIT = 232448  # dynamic shared memory a block may take on sm_90
_SMEM_PER_SM, _SMEM_RESERVED = 233472, 1024  # per SM, and kept per block


@dataclasses.dataclass(frozen=True)
class Plan:
    bm: int          # output rows per block (16, 64 or 128)
    splits: int      # K slices; partial sums go to a workspace when > 1
    k_slice: int     # K per slice, a multiple of BK
    path: str        # "aligned" (16-byte cp.async) or "masked"
    smem_bytes: int  # dynamic shared memory per block
    blocks_per_sm: int  # resident blocks an SM holds (shared memory, threads)


@functools.lru_cache(maxsize=1024)
def plan(m: int, n: int, k: int, x_dtype: torch.dtype,
         aligned: bool) -> Plan:
    """The kernel's launch plan for an (m, k) x (k, n) product.

    The tile height follows M: one m16 tile up to 16 rows (decode), 64 up
    to 64, else 128 for bf16 x; f32 x, three bf16 products per
    multiply-add (see ``split_bf16x3``) on a stage twice as wide, stops at
    64. When the output tiles fill less than one wave (``SMS`` times the
    blocks an SM holds), K is cut into slices of whole stages, as many as
    the wave holds copies of the tiles but none shorter than
    ``MIN_SLICE_STAGES`` stages (or one slice when K has fewer); the slices
    cover K, the last one possibly shorter."""
    if x_dtype not in _KERNEL_DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x_dtype}")
    bf16 = x_dtype == torch.bfloat16
    bm = 16 if m <= 16 else 64 if m <= 64 or not bf16 else 128
    threads = BN * (1 if bm == 16 else 2)  # a warp per 32 columns, 2 down
    smem = STAGES * (bm * _X_PITCH * (2 if bf16 else 4) + BK * _W_PITCH)
    per_sm = min(_SMEM_PER_SM // (smem + _SMEM_RESERVED), 2048 // threads)
    tiles = -(-m // bm) * -(-n // BN)
    stages = -(-k // BK)
    splits = max(1, min(SMS * per_sm // tiles, stages // MIN_SLICE_STAGES))
    per_slice = max(1, -(-stages // splits))
    splits = max(1, -(-stages // per_slice))
    return Plan(bm, splits, per_slice * BK, "aligned" if aligned else
                "masked", smem, per_sm)


def is_aligned(x: torch.Tensor, w: torch.Tensor,
               scale: torch.Tensor) -> bool:
    """Whether the 16-byte path can take the operands: x, w and scale
    16-byte aligned, x with unit column stride and a row stride and K that
    are whole 16-byte chunks, and N a multiple of 16 (every int8 row starts
    on 16 bytes). The output and the workspace come from ``torch.empty``,
    which aligns them."""
    vec = 16 // x.element_size()
    k, n = w.shape
    return (x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
            and scale.data_ptr() % 16 == 0 and x.stride(1) == 1
            and x.stride(0) % vec == 0 and k % vec == 0 and n % 16 == 0)


def split_bf16x3(x: torch.Tensor):
    """The kernel's split of f32 x into three bf16 planes, on any device:
    ``x0 = bf16(x)``, ``x1 = bf16(x - x0)``, ``x2 = bf16(x - x0 - x1)``,
    each rounded to nearest even. For normal f32 ``x0 + x1 + x2 == x``
    exactly (8 + 8 + 8 significant bits cover f32's 24), and a plane times
    an int8 level is exact in f32."""
    x = x.float()
    x0 = x.to(torch.bfloat16)
    r = x - x0.float()
    x1 = r.to(torch.bfloat16)
    x2 = (r - x1.float()).to(torch.bfloat16)
    return x0, x1, x2


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0
    for path in LAUNCHES_BY_PATH:
        LAUNCHES_BY_PATH[path] = 0


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("quant_matmul")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.quant_matmul_launch.argtypes = [p, i, p, p, p, p, i, i, i,
                                            ctypes.c_int64, i, i, i, i, i, p]
        lib.quant_matmul_launch.restype = i
        lib.quant_matmul_error_string.argtypes = [i]
        lib.quant_matmul_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor) -> None:
    if x.dim() != 2 or w.dim() != 2 or scale.dim() != 1:
        raise ValueError(f"expected x (M, K), w (K, N), scale (N,); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(scale.shape)}")
    if x.shape[1] != w.shape[0] or scale.shape[0] != w.shape[1]:
        raise ValueError(f"shapes do not chain: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, scale {tuple(scale.shape)}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"w must be int8 and scale float32, got {w.dtype} "
                        f"and {scale.dtype}")


def quant_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``(x.float() @ w.float()) * scale``."""
    _check(x, w, scale)
    return (x.float() @ w.float()) * scale


def quant_matmul(x: torch.Tensor, w: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """y = (x @ w) * scale on the kernel, f32 out. ``x`` may be a row slice
    of a wider buffer (unit column stride); ``w`` and ``scale`` must be
    contiguous."""
    _check(x, w, scale)
    if not x.is_cuda:
        if x.device.type in PLAIN_DEVICES:
            return quant_matmul_plain(x, w, scale)
        raise ValueError(f"unsupported device {x.device}")
    if w.device != x.device or scale.device != x.device:
        raise ValueError("all operands must lie on one CUDA device")
    if not (w.is_contiguous() and scale.is_contiguous()):
        raise ValueError("w and scale must be contiguous")
    m, k = x.shape
    n = w.shape[1]
    if x.stride(1) != 1 or x.stride(0) < max(k, 1):
        x = x.contiguous()
    y = x.new_empty((m, n), dtype=torch.float32)
    if m == 0 or n == 0:
        return y
    p = plan(m, n, k, x.dtype, is_aligned(x, w, scale))
    # partial sums of the K slices, on the caller's stream
    work = (x.new_empty((p.splits, m, n), dtype=torch.float32)
            if p.splits > 1 else None)
    lib = _lib()
    dev = x.get_device()
    # the raw handle of the current stream: torch.cuda.current_stream()
    # builds a Stream object, which costs more host time than the rest of
    # the work before the launch
    err = lib.quant_matmul_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(),
        scale.data_ptr(), y.data_ptr(),
        None if work is None else work.data_ptr(), m, n, k, x.stride(0),
        p.bm, p.splits, p.k_slice, int(p.path == "aligned"), dev,
        torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError("quant_matmul kernel launch failed: "
                           f"{lib.quant_matmul_error_string(err).decode()}")
    global LAUNCHES
    LAUNCHES += 1
    LAUNCHES_BY_PATH[p.path] += 1
    return y
