"""Kernel-facing helpers: deployment packing, the BSR matmul entry points
over packed dicts, and the fake-quant and dense int8 matmul entry points."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.mapping import pack_bsr
from . import cim_bsr_matmul, fake_quant as _fq, quant_matmul as _qm


def pack_for_kernel(w_q: torch.Tensor, bits: int, bk: int = 128,
                    bn: int = 128, device: Optional[torch.device] = None
                    ) -> dict:
    """eq. 8 output (float levels / 2^{b-1}) -> the kernel's int8 blocks,
    scales and index arrays on ``device`` (default: ``w_q``'s). The levels
    are rounded in float64, half to even; zero blocks are dropped."""
    scale = 1.0 / (2.0 ** (bits - 1))
    w64 = w_q.detach().to("cpu", torch.float64).numpy()
    levels = np.asarray(np.round(w64 / scale), np.int8)
    bsr = pack_bsr(levels, bk, bn)
    dev = w_q.device if device is None else device
    put = lambda a: torch.from_numpy(a).to(dev)
    return {
        "blocks": put(bsr.blocks),
        "scales": put(np.full(bsr.row_idx.shape, scale, np.float32)),
        "row_idx": put(bsr.row_idx),
        "nnz": put(bsr.nnz),
        "density": bsr.density,
    }


def bsr_matmul(x: torch.Tensor, packed: dict) -> torch.Tensor:
    return cim_bsr_matmul.bsr_matmul(x, packed["blocks"], packed["scales"],
                                     packed["row_idx"], packed["nnz"])


def bsr_matmul_stacked(x: torch.Tensor, blocks: torch.Tensor,
                       scales: torch.Tensor, row_idx: torch.Tensor,
                       nnz: torch.Tensor, layer) -> torch.Tensor:
    """Layer-indexed matmul over a uniform-envelope layer stack; ``layer``
    may be a (1,) int32 device tensor, read by the kernel on the card."""
    return cim_bsr_matmul.bsr_matmul_stacked(x, blocks, scales, row_idx, nnz,
                                             layer)


def fake_quant(x: torch.Tensor, bits: int, signed: bool = False
               ) -> torch.Tensor:
    """eq. 5 / eq. 8 fake quant on the kernel, ``x.dtype`` out; ``bits >=
    32`` leaves ``x`` as it is, as ``core.quant`` does."""
    if bits >= 32:
        return x
    return _fq.fake_quant(x, bits, signed)


def quant_matmul(x: torch.Tensor, w_int8: torch.Tensor, scale: torch.Tensor
                 ) -> torch.Tensor:
    """Dense int8-weight matmul, the non-sparse baseline macro: ``(x @
    w_int8) * scale`` with a per-output-channel f32 scale applied after the
    K sum, f32 out, on the kernel."""
    return _qm.quant_matmul(x, w_int8, scale)
