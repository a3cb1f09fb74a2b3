"""Kernel-facing helpers: deployment packing, the BSR matmul entry points
over packed dicts, and the fake-quant, SSD intra-chunk, dense int8
matmul, paged decode-attention and grouped float product entry points."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.mapping import pack_bsr
from . import cim_bsr_matmul, fake_quant as _fq, quant_matmul as _qm
from . import decode_attention as _da
from . import grouped_matmul as _gm
from . import ssd_intra as _si
from .decode_attention import row_sum  # noqa: F401  (the norms' row sums)


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


def bsr_matmul_sharded(x: torch.Tensor, packed: dict) -> torch.Tensor:
    """The single-layer product over a macro-sharded packed dict: one
    launch a macro on ``packed["shards"]``, output columns in macro order
    (``core.deploy.shard_weight``; callers un-permute by ``col_inv``)."""
    return cim_bsr_matmul.bsr_matmul_sharded(x, packed["shards"])


def bsr_matmul_stacked_sharded(x: torch.Tensor, shards, layer
                               ) -> torch.Tensor:
    """The layer-indexed product over a macro-sharded layer stack's
    per-macro shards (``StackedWeight.shards``), columns in macro order."""
    return cim_bsr_matmul.bsr_matmul_stacked_sharded(x, shards, layer)


def bsr_matmul_stacked(x: torch.Tensor, blocks: torch.Tensor,
                       scales: torch.Tensor, row_idx: torch.Tensor,
                       nnz: torch.Tensor, layer) -> torch.Tensor:
    """Layer-indexed matmul over a uniform-envelope layer stack; ``layer``
    may be a (1,) int32 device tensor, read by the kernel on the card."""
    return cim_bsr_matmul.bsr_matmul_stacked(x, blocks, scales, row_idx, nnz,
                                             layer)


def fake_quant(x: torch.Tensor, bits: int, signed: bool = False,
               out_dtype: Optional[torch.dtype] = None,
               ste: str = "clip") -> torch.Tensor:
    """eq. 5 / eq. 8 fake quant on the kernel, ``out_dtype`` (default
    ``x.dtype``) out; ``bits >= 32`` leaves the values as they are, as
    ``core.quant`` does (cast to ``out_dtype`` when one is given). Its
    gradient is the straight-through rule ``ste``: "clip" for eq. 5's
    clamped activations, "noclip" for eq. 8's weights, which the reference
    rounds unclamped (``kernels/fake_quant.py``)."""
    if bits >= 32:
        return x if out_dtype is None else x.to(out_dtype)
    return _fq.fake_quant(x, bits, signed, out_dtype, ste)


def ssd_intra(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
              x: torch.Tensor, out_dtype: Optional[torch.dtype] = None
              ) -> torch.Tensor:
    """Mamba2's SSD intra-chunk block on its kernel (the plain version for
    CPU tensors), differentiable: ``kernels.ssd_intra.ssd_intra_chunk``."""
    return _si.ssd_intra_chunk(a, b, c, x, out_dtype)


def quant_matmul(x: torch.Tensor, w_int8: torch.Tensor, scale: torch.Tensor
                 ) -> torch.Tensor:
    """Dense int8-weight matmul, the non-sparse baseline macro: ``(x @
    w_int8) * scale`` with a per-output-channel f32 scale applied after the
    K sum, f32 out, on the kernel."""
    return _qm.quant_matmul(x, w_int8, scale)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor, window: int = 0, n_true: int = 0,
                     k_new: Optional[torch.Tensor] = None,
                     v_new: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention of the paged decode / verify pass on its kernel: query
    rows (B, T, H, dh) at positions ``pos[b] + t`` over the views (B, Sv,
    KV, dh), the keys at the query positions from ``k_new``/``v_new`` (B,
    T, KV, dh) when given; each row's sums in one order whatever T and
    Sv."""
    return _da.decode_attention(q, k, v, pos, window, n_true, k_new, v_new)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x[g] @ w[g]`` for x (G, R, K) and w (G, K, N) in x's type, on the
    kernel: each row's K sum in one order whatever R, so a row comes out
    the same in a one-token step and in a multi-token pass. Rows at or
    past ``counts[g]`` are zeros."""
    return _gm.grouped_matmul(x, w, counts)
