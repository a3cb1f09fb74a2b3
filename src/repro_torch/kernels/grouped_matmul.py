"""Grouped float product whose rows do not depend on the row count: the
CUDA kernel's wrapper and plain version.

    y[g, r, :] = x[g, r, :] @ w[g]      x (G, R, K), w (G, K, N)

``csrc/grouped_matmul.cu`` replaces no Pallas kernel: the reference leaves
these products to XLA as plain jnp (the MoE router and expert einsums of
``repro/models/layers.py:moe_block``, a float LM head). The port needs a
kernel of its own for them because the library product picks its sum
order from the row count on the card, and the paged pass promises that a
T-token verify gives each position exactly what T one-token steps give
(``serve/deployed.py``). The kernel sums each row's K terms in the order
k = 0 .. K-1 whatever R, the tile or the other rows (the source's header
has the design).

Types: (x, w) in (f32, f32), (f32, bf16) or (bf16, bf16), y in x's type,
f32 accumulation; a bf16 w under f32 x computes ``x @ w.float()`` without
the widened copy, and an f32 w under bf16 x is rounded to bf16 first, as
``x @ w.to(x.dtype)`` does. ``counts`` (G,) int, when given, is each
group's number of filled rows: rows at or past it come out as zeros.

The wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel (one launch a call) or raises.
``LAUNCHES`` counts the launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

LAUNCHES = 0

_LIB = None
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("grouped_matmul")
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.grouped_matmul_launch.argtypes = [p, p, p, p, i, i, i, i, i64,
                                              i64, i, i, p]
        lib.grouped_matmul_launch.restype = i
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


def grouped_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                         counts: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Plain PyTorch version: ``torch.bmm(x, w.to(x.dtype))``, rows at or
    past ``counts`` zeroed. A one-row product is taken as two rows (the
    row repeated): the CPU library sends a single row to its
    matrix-vector routine, whose sum order differs from the matrix
    product's, and would break the rows' independence of R here."""
    w = _check(x, w, counts).to(x.dtype)
    r = x.shape[1]
    y = torch.bmm(x.expand(-1, 2, -1) if r == 1 else x, w)[:, :r]
    if counts is not None:
        filled = torch.arange(r, device=x.device)[None, :] < counts[:, None]
        y = torch.where(filled[..., None], y, 0.0)
    return y.contiguous()


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y[g] = x[g] @ w[g] in x's type (module docstring) on the kernel for
    CUDA tensors, the plain version for CPU ones. ``x`` may be a view whose
    rows are contiguous (a group stride of its own); other layouts are
    copied."""
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, w, counts)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    w = _check(x, w, counts)
    if x.dtype not in _KERNEL_DTYPES or w.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the grouped_matmul kernel takes float32 or "
                        f"bfloat16, got {x.dtype} and {w.dtype}")
    if any(t is not None and t.device != x.device for t in (w, counts)):
        raise ValueError("all operands must lie on one CUDA device")
    g, r, k = x.shape
    n = w.shape[2]
    if x.stride(2) != 1 or (r > 1 and x.stride(1) != k):
        x = x.contiguous()
    if w.stride(2) != 1 or (k > 1 and w.stride(1) != n):
        w = w.contiguous()
    if counts is not None:
        counts = counts.to(torch.int32).contiguous()
    y = torch.empty((g, r, n), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = _lib()
    dev = x.get_device()
    err = lib.grouped_matmul_launch(
        x.data_ptr(), w.data_ptr(), y.data_ptr(),
        None if counts is None else counts.data_ptr(), g, r, k, n,
        x.stride(0), w.stride(0), int(x.dtype == torch.bfloat16),
        int(w.dtype == torch.bfloat16),
        torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        msg = lib.grouped_matmul_error_string(err).decode()
        raise RuntimeError(f"grouped_matmul kernel launch failed: {msg}")
    global LAUNCHES
    LAUNCHES += 1
    return y
