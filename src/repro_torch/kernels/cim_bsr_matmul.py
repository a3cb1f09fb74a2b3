"""Block-sparse int8 matmul: the CUDA kernel's wrappers and plain version.

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

A wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; ``LAUNCHES`` counts the launches
(and ``LAUNCHES_BY_ENTRY`` splits them by entry point).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Union

import torch

from . import _build

LAUNCHES = 0
LAUNCHES_BY_ENTRY: Dict[str, int] = {"bsr_matmul": 0, "bsr_matmul_stacked": 0}

_LIB = None
_LAYER_CONST: Dict[tuple, torch.Tensor] = {}

Layer = Union[int, torch.Tensor]


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0
    for k in LAUNCHES_BY_ENTRY:
        LAUNCHES_BY_ENTRY[k] = 0


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("bsr_matmul")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bsr_matmul_launch.argtypes = [p, i, p, p, p, p, p, p,
                                          i, i, i, i, i, i, i, i, p]
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
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    want = ((blocks, torch.int8), (scales, torch.float32),
            (row_idx, torch.int32), (nnz, torch.int32))
    for t, dt in want:
        if t.dtype != dt:
            raise TypeError(f"expected {dt}, got {t.dtype}")


def dense_weight(blocks: torch.Tensor, scales: torch.Tensor,
                 row_idx: torch.Tensor, nnz: torch.Tensor, layer: Layer,
                 k: int) -> torch.Tensor:
    """Layer ``layer``'s dense (K, N) f32 weight, rebuilt from ``blocks *
    scales`` over the slots ``s < min(nnz, nnz_max)``. Padding slots are
    masked, never trusted to be zero."""
    li = int(layer.reshape(-1)[0]) if torch.is_tensor(layer) else int(layer)
    _, go, nmax, bk, bn = blocks.shape
    dev = blocks.device
    valid = (torch.arange(nmax, device=dev)[None, :]
             < nnz[li].clamp(max=nmax)[:, None])  # (go, nmax)
    wb = torch.where(valid[..., None, None],
                     blocks[li].float() * scales[li][..., None, None], 0.0)
    rows = torch.where(valid, row_idx[li], 0).long()
    cols = torch.arange(go, device=dev)[:, None].expand(go, nmax)
    w = torch.zeros((k // bk, go, bk, bn), dtype=torch.float32, device=dev)
    # accumulate: inert slots add exact zeros onto whatever block they hit
    w.index_put_((rows, cols), wb, accumulate=True)
    return w.permute(0, 2, 1, 3).reshape(k, go * bn)


def bsr_matmul_stacked_plain(x: torch.Tensor, blocks: torch.Tensor,
                             scales: torch.Tensor, row_idx: torch.Tensor,
                             nnz: torch.Tensor, layer: Layer) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``x.float() @`` the selected
    layer's dense weight."""
    _check(x, blocks, scales, row_idx, nnz)
    return x.float() @ dense_weight(blocks, scales, row_idx, nnz, layer,
                                    x.shape[1])


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


def _run(entry: str, x, blocks, scales, row_idx, nnz, layer: Layer):
    _check(x, blocks, scales, row_idx, nnz)
    if x.device.type == "cpu":
        return bsr_matmul_stacked_plain(x, blocks, scales, row_idx, nnz,
                                        layer)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    args = (x, blocks, scales, row_idx, nnz)
    if any(t.device != x.device for t in args):
        raise ValueError("all operands must lie on one CUDA device")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("bsr_matmul operands must be contiguous")
    lt = _layer_tensor(layer, x.device)
    m, k = x.shape
    n_l, go, nmax, bk, bn = blocks.shape
    y = torch.empty((m, go * bn), dtype=torch.float32, device=x.device)
    if m == 0 or go == 0:
        return y
    lib = _lib()
    err = lib.bsr_matmul_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), blocks.data_ptr(),
        scales.data_ptr(), row_idx.data_ptr(), nnz.data_ptr(), lt.data_ptr(),
        y.data_ptr(), m, k, n_l, go, nmax, bk, bn, x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: "
                           f"{lib.bsr_matmul_error_string(err).decode()}")
    global LAUNCHES
    LAUNCHES += 1
    LAUNCHES_BY_ENTRY[entry] += 1
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
