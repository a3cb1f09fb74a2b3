"""Mamba2 SSD intra-chunk block: the CUDA kernel's wrapper and plain version.

``csrc/ssd_intra.cu`` replaces the Pallas TPU kernel ``ssd_intra_chunk`` of
``repro/kernels/ssd_intra.py``. For every chunk c and head h, in f32:

  cum    = cumsum(a[c, h])                         (l,)
  L[i,j] = exp(cum_i - cum_j) for i >= j, else 0   (l, l)
  y[c, :, h] = ((c_c b_c^T) * L) @ x[c, :, h]      (l, P)

Layout (the reference's):
  a: (C, H, l) f32    b, c: (C, l, N)    x: (C, l, H, P)    y: (C, l, H, P)
b, c and x share one type, f32 or bf16. ``out_dtype`` is ``x.dtype`` unless
given: ``ssd_chunked`` asks for f32, so the model path rounds ``y_diag`` no
earlier than the reference does. The kernel writes f32; any other
``out_dtype`` is a cast of that, as in the plain version.

The wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. ``LAUNCHES`` counts the launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

LAUNCHES = 0
MAX_LEN = 1024  # the kernel keeps cum (l floats) in shared memory

_LIB = None
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("ssd_intra")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ssd_intra_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                                         p]
        lib.ssd_intra_launch.restype = i
        lib.ssd_intra_error_string.argtypes = [i]
        lib.ssd_intra_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(a, b, c, x) -> None:
    if a.dim() != 3 or b.dim() != 3 or c.dim() != 3 or x.dim() != 4:
        raise ValueError("expected a (C, H, l), b and c (C, l, N), x (C, l, "
                         f"H, P); got {tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}, {tuple(x.shape)}")
    n_c, n_h, l = a.shape
    if (tuple(b.shape[:2]) != (n_c, l) or b.shape != c.shape
            or tuple(x.shape[:3]) != (n_c, l, n_h)):
        raise ValueError("a, b, c and x disagree on (C, H, l): "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}, {tuple(x.shape)}")


def ssd_intra_chunk_plain(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                          x: torch.Tensor,
                          out_dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """Plain PyTorch version: the (C, H, l, l) decay and score tensors are
    built in full, in f32."""
    _check(a, b, c, x)
    l = a.shape[-1]
    cum = a.float().cumsum(-1)
    causal = torch.ones((l, l), dtype=torch.bool, device=a.device).tril()
    diff = (cum[..., :, None] - cum[..., None, :]).masked_fill(
        ~causal, float("-inf"))  # exp(-inf) = 0: no overflow above i = j
    decay = torch.exp(diff)  # (C, H, l, l)
    s = torch.einsum("cin,cjn->cij", c.float(), b.float())
    y = torch.einsum("chij,cjhp->cihp", decay * s[:, None], x.float())
    return y.to(out_dtype or x.dtype)


def ssd_intra_chunk(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                    x: torch.Tensor, out_dtype: Optional[torch.dtype] = None
                    ) -> torch.Tensor:
    """Batched intra-chunk SSD (module docstring) on the kernel."""
    _check(a, b, c, x)
    if a.device.type == "cpu":
        return ssd_intra_chunk_plain(a, b, c, x, out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    if any(t.device != a.device for t in (b, c, x)):
        raise ValueError("all operands must lie on one CUDA device")
    out_dtype = out_dtype or x.dtype
    if (a.dtype != torch.float32 or x.dtype not in _KERNEL_DTYPES
            or b.dtype != x.dtype or c.dtype != x.dtype
            or out_dtype not in _KERNEL_DTYPES):
        raise TypeError("the ssd_intra kernel takes a in float32, b, c and x "
                        "in one of float32/bfloat16 and writes float32 or "
                        f"bfloat16; got a {a.dtype}, b {b.dtype}, c "
                        f"{c.dtype}, x {x.dtype}, out {out_dtype}")
    if not all(t.is_contiguous() for t in (a, b, c, x)):
        raise ValueError("ssd_intra operands must be contiguous")
    n_c, n_h, l = a.shape
    n, p = b.shape[-1], x.shape[-1]
    if l > MAX_LEN or n_c > 65535:
        raise ValueError(f"the ssd_intra kernel takes l <= {MAX_LEN} and "
                         f"C <= 65535, got l={l}, C={n_c}")
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y.to(out_dtype)
    lib = _lib()
    err = lib.ssd_intra_launch(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), x.data_ptr(), y.data_ptr(),
        n_c, n_h, l, n, p, int(x.dtype == torch.bfloat16),
        x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("ssd_intra kernel launch failed: "
                           f"{lib.ssd_intra_error_string(err).decode()}")
    global LAUNCHES
    LAUNCHES += 1
    return y.to(out_dtype)
