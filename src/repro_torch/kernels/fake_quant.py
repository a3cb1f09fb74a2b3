"""MARS fake quantization (eq. 5 / eq. 8): the CUDA kernel's wrapper and
plain version.

``csrc/fake_quant.cu`` replaces the Pallas TPU kernel ``fake_quant`` of
``repro/kernels/fake_quant.py``. For every element, in f32:

  unsigned (eq. 5): round(clamp(x, 0, 1) * (2^b - 1)) / 2^b
  signed   (eq. 8): round(clamp(x, -1, 1) * (2^(b-1) - 1)) / 2^(b-1)

rounded half to even, NaN kept, the result in ``x.dtype``. Any shape; the
kernel walks the flat tensor. The wrapper takes the plain version only for
a tensor on the CPU; for a CUDA tensor it launches the kernel or raises.
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
        lib = _build.load("fake_quant")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fake_quant_launch.argtypes = [p, p, ctypes.c_int64, i, i, i, i, p]
        lib.fake_quant_launch.restype = i
        lib.fake_quant_error_string.argtypes = [i]
        lib.fake_quant_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(x: torch.Tensor, bits: int) -> None:
    if not x.is_floating_point():
        raise TypeError(f"fake_quant takes a floating tensor, got {x.dtype}")
    if not 1 <= bits <= 24:
        raise ValueError(f"bits must lie in [1, 24], got {bits}")


def fake_quant_plain(x: torch.Tensor, bits: int,
                     signed: bool = False) -> torch.Tensor:
    """Plain PyTorch version: the same f32 arithmetic, ``x.dtype`` out."""
    _check(x, bits)
    x32 = x.float()
    if signed:
        qmax = 2.0 ** (bits - 1) - 1.0
        y = torch.round(x32.clamp(-1.0, 1.0) * qmax) / (2.0 ** (bits - 1))
    else:
        levels = 2.0 ** bits - 1.0
        y = torch.round(x32.clamp(0.0, 1.0) * levels) / (2.0 ** bits)
    return y.to(x.dtype)


def fake_quant(x: torch.Tensor, bits: int,
               signed: bool = False) -> torch.Tensor:
    """eq. 5 (``signed=False``) or its signed form / eq. 8 on the kernel.
    A non-contiguous ``x`` is made contiguous first."""
    _check(x, bits)
    if x.device.type == "cpu":
        return fake_quant_plain(x, bits, signed)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the fake_quant kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    x = x.contiguous()
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    lib = _lib()
    err = lib.fake_quant_launch(
        x.data_ptr(), y.data_ptr(), x.numel(), int(x.dtype == torch.bfloat16),
        bits, int(signed), x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("fake_quant kernel launch failed: "
                           f"{lib.fake_quant_error_string(err).decode()}")
    global LAUNCHES
    LAUNCHES += 1
    return y
