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

Any M, N, K: the kernel masks the ragged edges itself (the TPU version
pads to 128-tiles). The wrapper takes the plain version only for tensors
on the CPU; for CUDA tensors it launches the kernel or raises.
``LAUNCHES`` counts the launches.
"""
from __future__ import annotations

import ctypes

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
        lib = _build.load("quant_matmul")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.quant_matmul_launch.argtypes = [p, i, p, p, p, i, i, i,
                                            ctypes.c_int64, i, p]
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
    if x.device.type == "cpu":
        return quant_matmul_plain(x, w, scale)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if w.device != x.device or scale.device != x.device:
        raise ValueError("all operands must lie on one CUDA device")
    if not (w.is_contiguous() and scale.is_contiguous()):
        raise ValueError("w and scale must be contiguous")
    m, k = x.shape
    n = w.shape[1]
    if x.stride(1) != 1 or x.stride(0) < max(k, 1):
        x = x.contiguous()
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return y
    lib = _lib()
    err = lib.quant_matmul_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(),
        scale.data_ptr(), y.data_ptr(), m, n, k, x.stride(0),
        x.device.index or 0, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("quant_matmul kernel launch failed: "
                           f"{lib.quant_matmul_error_string(err).decode()}")
    global LAUNCHES
    LAUNCHES += 1
    return y
