"""MARS fake quantization (eq. 5 / eq. 8): the CUDA kernel's wrapper and
plain version.

``csrc/fake_quant.cu`` replaces the Pallas TPU kernel ``fake_quant`` of
``repro/kernels/fake_quant.py``. For every element, in f32:

  unsigned (eq. 5): round(clamp(x, 0, 1) * (2^b - 1)) / 2^b
  signed   (eq. 8): round(clamp(x, -1, 1) * (2^(b-1) - 1)) / 2^(b-1)

rounded half to even, NaN kept, the result in ``out_dtype`` (``x.dtype``
unless given). Any pair of float32 and bfloat16 for x and the result: the
same values as ``fake_quant(x.float()).to(out_dtype)``, since bf16 -> f32
is exact and the cast to bf16 rounds to nearest even, without a separate
widening or narrowing pass. Any shape; the kernel walks the flat tensor in
16-byte vectors. The wrapper takes the plain version only for a tensor on
the CPU; for a CUDA tensor it launches the kernel or raises. ``LAUNCHES``
counts the launches.

Gradients. The reference trains through plain jnp, so its gradient is
what JAX's autodiff makes of ``round_ste`` and ``jnp.clip``: for every
element, in f32, ``grad_in = ((grad / 2^e) * qmax) * m`` (2^e the divisor,
qmax the level count), where ``m`` depends on the straight-through mode
``ste``:

  "clip"   (eq. 5 activations): 1 strictly inside the clamp range, 1/2
           exactly on a bound (XLA splits a tie of min/max evenly), 0
           outside and for NaN;
  "noclip" (eq. 8 weights, which the reference rounds with no clamp, so
           the tanh-normalized weight's +-1 keeps the whole slope): 1.

``m`` multiplies, so an infinite grad outside the range gives NaN, as
under ``jax.grad``; grad_in takes ``x``'s type. When ``x`` needs a
gradient and grad mode is on, both ``fake_quant`` and ``fake_quant_plain``
run through an autograd Function whose backward is ``fake_quant_bwd``
(the CUDA kernel of ``csrc/fake_quant.cu``, ``BWD_LAUNCHES`` counting its
launches) or ``fake_quant_bwd_plain``; otherwise they save nothing and run
the forward alone.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

LAUNCHES = 0
BWD_LAUNCHES = 0
STE_MODES = ("clip", "noclip")

_LIB = None
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    global LAUNCHES, BWD_LAUNCHES
    LAUNCHES = BWD_LAUNCHES = 0


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("fake_quant")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fake_quant_launch.argtypes = [p, p, ctypes.c_int64, i, i, i, i, i,
                                          p]
        lib.fake_quant_launch.restype = i
        lib.fake_quant_bwd_launch.argtypes = [p, p, p, ctypes.c_int64, i, i,
                                              i, i, i, i, p]
        lib.fake_quant_bwd_launch.restype = i
        lib.fake_quant_error_string.argtypes = [i]
        lib.fake_quant_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(x: torch.Tensor, bits: int,
           out_dtype: Optional[torch.dtype]) -> torch.dtype:
    if not x.is_floating_point():
        raise TypeError(f"fake_quant takes a floating tensor, got {x.dtype}")
    if not 1 <= bits <= 24:
        raise ValueError(f"bits must lie in [1, 24], got {bits}")
    out_dtype = out_dtype or x.dtype
    if not out_dtype.is_floating_point:
        raise TypeError(f"fake_quant writes a floating type, got {out_dtype}")
    return out_dtype


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _FakeQuantSTE(torch.autograd.Function):
    """The forward on the kernel (or the plain version), the straight-through
    backward on its kernel (or its plain version)."""

    @staticmethod
    def forward(ctx, x, bits, signed, out_dtype, ste, plain):
        ctx.args = (bits, signed, ste, x.dtype, plain)
        if ste == "clip":  # the weight mode's slope does not read x
            ctx.save_for_backward(x)
        return (_plain_forward if plain else _launch)(x, bits, signed,
                                                      out_dtype)

    @staticmethod
    def backward(ctx, grad):
        bits, signed, ste, dtype, plain = ctx.args
        x = ctx.saved_tensors[0] if ste == "clip" else None
        bwd = fake_quant_bwd_plain if plain else fake_quant_bwd
        return bwd(grad, x, bits, signed, ste, dtype), None, None, None, \
            None, None


def _check_ste(ste: str) -> None:
    if ste not in STE_MODES:
        raise ValueError(f"ste must be one of {STE_MODES}, got {ste!r}")


def _plain_forward(x: torch.Tensor, bits: int, signed: bool,
                   out_dtype: torch.dtype) -> torch.Tensor:
    x32 = x.float()
    if signed:
        qmax = 2.0 ** (bits - 1) - 1.0
        y = torch.round(x32.clamp(-1.0, 1.0) * qmax) / (2.0 ** (bits - 1))
    else:
        levels = 2.0 ** bits - 1.0
        y = torch.round(x32.clamp(0.0, 1.0) * levels) / (2.0 ** bits)
    return y.to(out_dtype).contiguous()  # laid out as the kernel writes it


def fake_quant_plain(x: torch.Tensor, bits: int, signed: bool = False,
                     out_dtype: Optional[torch.dtype] = None,
                     ste: str = "clip") -> torch.Tensor:
    """Plain PyTorch version: the same f32 arithmetic, ``out_dtype`` out,
    contiguous as the kernel's (a layout that follows a strided input
    would change the order of later reductions over it, so the two paths
    would part by ulps); differentiable by the straight-through rule
    ``ste``."""
    out_dtype = _check(x, bits, out_dtype)
    _check_ste(ste)
    if _needs_grad(x):
        return _FakeQuantSTE.apply(x, bits, signed, out_dtype, ste, True)
    return _plain_forward(x, bits, signed, out_dtype)


def fake_quant(x: torch.Tensor, bits: int, signed: bool = False,
               out_dtype: Optional[torch.dtype] = None,
               ste: str = "clip") -> torch.Tensor:
    """eq. 5 (``signed=False``) or its signed form / eq. 8 on the kernel,
    ``out_dtype`` (default ``x.dtype``) out, differentiable by the
    straight-through rule ``ste`` (module docstring). A non-contiguous
    ``x`` is made contiguous first."""
    out_dtype = _check(x, bits, out_dtype)
    _check_ste(ste)
    if x.device.type == "cpu":
        return fake_quant_plain(x, bits, signed, out_dtype, ste)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _KERNEL_DTYPES or out_dtype not in _KERNEL_DTYPES:
        raise TypeError("the fake_quant kernel takes and writes float32 or "
                        f"bfloat16, got {x.dtype} -> {out_dtype}")
    if _needs_grad(x):
        return _FakeQuantSTE.apply(x, bits, signed, out_dtype, ste, False)
    return _launch(x, bits, signed, out_dtype)


def _launch(x: torch.Tensor, bits: int, signed: bool,
            out_dtype: torch.dtype) -> torch.Tensor:
    x = x.contiguous()
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if x.numel() == 0:
        return y
    lib = _lib()
    dev = x.get_device()
    # the raw handle of the current stream (torch.cuda.current_stream()
    # builds a Stream object, several us of host time per launch)
    err = lib.fake_quant_launch(
        x.data_ptr(), y.data_ptr(), x.numel(), int(x.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16), bits, int(signed), dev,
        torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError("fake_quant kernel launch failed: "
                           f"{lib.fake_quant_error_string(err).decode()}")
    global LAUNCHES
    LAUNCHES += 1
    return y


def _check_bwd(grad: torch.Tensor, x: Optional[torch.Tensor], bits: int,
               ste: str, dtype: Optional[torch.dtype]) -> torch.dtype:
    _check_ste(ste)
    if not 1 <= bits <= 24:
        raise ValueError(f"bits must lie in [1, 24], got {bits}")
    if not grad.is_floating_point():
        raise TypeError(f"grad must be floating, got {grad.dtype}")
    if x is None:
        if ste == "clip":
            raise ValueError("the clip mode's slope reads x; pass it")
        if dtype is None:
            raise ValueError("without x, pass the gradient's dtype")
        return dtype
    if x.shape != grad.shape:
        raise ValueError(f"x {tuple(x.shape)} and grad {tuple(grad.shape)} "
                         "differ in shape")
    return dtype or x.dtype


def fake_quant_bwd_plain(grad: torch.Tensor, x: Optional[torch.Tensor],
                         bits: int, signed: bool = False, ste: str = "clip",
                         dtype: Optional[torch.dtype] = None
                         ) -> torch.Tensor:
    """Plain PyTorch version of the straight-through backward: the
    gradient w.r.t. ``x`` (module docstring), contiguous as the kernel's
    (a conv weight's gradient arrives strided), in ``dtype`` (default
    ``x.dtype``; ``x`` may be None in the "noclip" mode, which does not
    read it)."""
    dtype = _check_bwd(grad, x, bits, ste, dtype)
    e = bits - 1 if signed else bits
    v = grad.float() * 2.0 ** -e * (2.0 ** e - 1.0)  # (g / 2^e) * qmax
    if ste == "clip":
        lo = -1.0 if signed else 0.0
        x32 = x.float()
        m = torch.where((x32 > lo) & (x32 < 1.0), 1.0,
                        torch.where((x32 == lo) | (x32 == 1.0), 0.5, 0.0))
        v = v * m
    return v.to(dtype).contiguous()


def fake_quant_bwd(grad: torch.Tensor, x: Optional[torch.Tensor], bits: int,
                   signed: bool = False, ste: str = "clip",
                   dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The straight-through backward (module docstring) on its kernel; the
    plain version only for a tensor on the CPU."""
    dtype = _check_bwd(grad, x, bits, ste, dtype)
    if grad.device.type == "cpu":
        return fake_quant_bwd_plain(grad, x, bits, signed, ste, dtype)
    if grad.device.type != "cuda":
        raise ValueError(f"unsupported device {grad.device}")
    if x is not None and x.device != grad.device:
        raise ValueError("x and grad must lie on one CUDA device")
    if grad.dtype not in _KERNEL_DTYPES or dtype not in _KERNEL_DTYPES or (
            x is not None and x.dtype != dtype):
        raise TypeError("the fake_quant backward kernel takes grad in "
                        "float32 or bfloat16 and writes x's type, one of "
                        f"them; got grad {grad.dtype}, x "
                        f"{None if x is None else x.dtype} -> {dtype}")
    grad = grad.contiguous()
    xc = grad if x is None else x.contiguous()  # unread without the clip
    gi = torch.empty(grad.shape, dtype=dtype, device=grad.device)
    if grad.numel() == 0:
        return gi
    lib = _lib()
    dev = grad.get_device()
    err = lib.fake_quant_bwd_launch(
        xc.data_ptr(), grad.data_ptr(), gi.data_ptr(), grad.numel(),
        int(dtype == torch.bfloat16), int(grad.dtype == torch.bfloat16),
        bits, int(signed), int(ste == "clip"), dev,
        torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError("fake_quant backward kernel launch failed: "
                           f"{lib.fake_quant_error_string(err).decode()}")
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    return gi
