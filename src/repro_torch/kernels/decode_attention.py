"""Attention of the paged decode and verify pass: the CUDA kernel's wrapper
and plain version.

``csrc/decode_attention.cu`` computes what the reference leaves to XLA in
``repro/models/layers.py`` (``decode_attention_multi`` over
``attention_scores``); no Pallas kernel stands behind it. Query row
(b, t, h) sits at position ``pos[b] + t`` and attends, causally and within
``window`` (0 = full), the keys of its kv head in the views ``k``/``v``
(B, Sv, KV, dh). In f32, with ``round_t`` the rounding to the common input
type:

  s_j = round_t(round_t(q . k_j) / round_t(sqrt(dh)))
  p_j = round_t(softmax(s)_j),   out = round_t(sum_j p_j v_j)

A row's output depends only on that row's inputs: not on T, B, H or keys
past its position (the view's length). A T-token verify pass then gives
each position exactly what T one-token steps give, which the speculative
accept rule stands on. The kernel holds that by looping over each row's
own keys in an order fixed by the row; the plain version by taking every
sum with :func:`row_sum`. The two agree to a few ulps of the input type
(their sums run in different orders). The wrapper takes the plain version
only for tensors on the CPU; on CUDA tensors it launches the kernel or
raises. ``LAUNCHES`` counts the launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from . import _build

LAUNCHES = 0

# the chunk every plain-version sum is cut into
SUM_CHUNK = 32
# the masked score (as models.layers.NEG_INF): exp() of it minus any
# finite max is exactly 0
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

_LIB = None
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_MAX_DH = 256
_MAX_GROUP = 16


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("decode_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.decode_attention_launch.argtypes = [
            p, p, p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, i, i, p]
        lib.decode_attention_launch.restype = i
        lib.decode_attention_scratch.argtypes = [i, i, i, i, i]
        lib.decode_attention_scratch.restype = ctypes.c_int64
        lib.decode_attention_error_string.argtypes = [i]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


@functools.lru_cache(maxsize=None)
def _scale(dh: int, dt: torch.dtype) -> float:
    """sqrt(dh) rounded to ``dt``, as the plain version divides by it."""
    return float(torch.tensor(math.sqrt(dh), dtype=torch.float32).to(dt))


def _pad_to(x: torch.Tensor, dim: int, multiple: int = SUM_CHUNK
            ) -> torch.Tensor:
    """Zero-pad ``dim`` up to a positive multiple of ``multiple``."""
    n = x.shape[dim]
    pad = max(-(-n // multiple), 1) * multiple - n
    if not pad:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim, in chunks of SUM_CHUNK from its start: each
    chunk by one ``torch.sum`` over a dim of exactly SUM_CHUNK, then the
    chunk sums the same way, until one value is left. A reduction over a
    fixed SUM_CHUNK-wide dim of a contiguous tensor takes one order per
    row, so each row's result depends only on its own values: not on how
    many rows the tensor has, and not on zeros appended to the dim. (A
    broadcast product may come out in a permuted layout, whose reduction
    runs in another order: hence the copy to a contiguous tensor.)"""
    while True:
        x = _pad_to(x, -1).contiguous()
        x = x.reshape(*x.shape[:-1], -1, SUM_CHUNK).sum(dim=-1)
        if x.shape[-1] == 1:
            return x[..., 0]


def _check(q, k, v, pos, n_true):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q (B, T, H, dh) and k, v (B, Sv, KV, dh), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or pos.shape != (b,):
        raise ValueError(f"batch or head width disagree: q {tuple(q.shape)}"
                         f", k {tuple(k.shape)}, pos {tuple(pos.shape)}")
    n_true = n_true or h
    if n_true > h or n_true % k.shape[2]:
        raise ValueError(f"{n_true} true heads over {k.shape[2]} kv heads "
                         f"and {h} heads")
    return n_true, torch.promote_types(torch.promote_types(q.dtype, k.dtype),
                                       v.dtype)


def _expand_kv(k: torch.Tensor, n_heads: int, n_true: int) -> torch.Tensor:
    """(B, S, KV, dh) -> (B, S, H, dh): each kv head repeated for its group
    of the n_true heads, then zeros up to n_heads."""
    if k.shape[2] != n_true:
        k = k.repeat_interleave(n_true // k.shape[2], dim=2)
    if n_heads > n_true:
        k = F.pad(k, (0, 0, 0, n_heads - n_true))
    return k


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           pos: torch.Tensor, window: int = 0,
                           n_true: int = 0) -> torch.Tensor:
    """Plain PyTorch version: the kernel's arithmetic over the masked,
    head-expanded views, every sum by :func:`row_sum`. Returns (B, T, H,
    dh) in the promoted input type."""
    n_true, dt = _check(q, k, v, pos, n_true)
    b, t, h, dh = q.shape
    pp = pos.long()[:, None] + torch.arange(t, device=q.device)[None, :]
    kj = torch.arange(k.shape[1], device=q.device)[None, None, None, :]
    pe = pp[:, None, :, None]  # (B, 1, T, 1) per-query positions
    mask = kj <= pe
    if window > 0:
        mask = mask & (kj > pe - window)
    scale = torch.tensor(math.sqrt(dh), dtype=torch.float32).to(dt)
    qh = _pad_to(q.to(dt).float().transpose(1, 2), -1)  # (B, H, T, dh)
    kh = _pad_to(_expand_kv(k.to(dt), h, n_true).float().transpose(1, 2),
                 -1)  # (B, H, Sk, dh)
    scores = row_sum(qh[:, :, :, None, :] * kh[:, :, None, :, :])
    scores = scores.to(dt) / scale  # (B, H, T, Sk)
    scores = torch.where(mask, scores.float(), NEG_INF)
    e = _pad_to(torch.exp(scores - scores.amax(dim=-1, keepdim=True)), -1)
    probs = (e / row_sum(e)[..., None]).to(dt)
    vh = _pad_to(_expand_kv(v.to(dt), h, n_true).float().permute(0, 2, 3, 1),
                 -1)  # (B, H, dh, Sk)
    out = row_sum(probs.float()[:, :, :, None, :]
                  * vh[:, :, None, :, :]).to(dt)  # (B, H, T, dh)
    return out.transpose(1, 2)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor, window: int = 0, n_true: int = 0
                     ) -> torch.Tensor:
    """Attention of the query rows q (B, T, H, dh) at positions
    ``pos[b] + t`` over the views k, v (B, Sv, KV, dh): the first
    ``n_true`` heads (default H) share the KV heads in equal groups, the
    rest are zero padding. On the kernel for CUDA tensors, the plain
    version for CPU ones; (B, T, H, dh) in the promoted input type."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, pos, window, n_true)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    n_true, dt = _check(q, k, v, pos, n_true)
    if dt not in _KERNEL_DTYPES:
        raise TypeError(f"the decode_attention kernel takes float32 or "
                        f"bfloat16, got {dt}")
    b, t, h, dh = q.shape
    if dh > _MAX_DH or n_true // k.shape[2] > _MAX_GROUP:
        raise ValueError(f"head width {dh} > {_MAX_DH} or more than "
                         f"{_MAX_GROUP} heads to a kv head")
    q, k, v = (a if a.dtype == dt and a.is_contiguous()
               else a.to(dt).contiguous() for a in (q, k, v))
    if pos.dtype != torch.int32:
        pos = pos.to(torch.int32)
    pos = pos.contiguous()
    out = torch.empty(q.shape, dtype=dt, device=q.device)
    sv = k.shape[1]
    lib = _lib()
    scratch = torch.empty(lib.decode_attention_scratch(b, t, h, sv, dh),
                          dtype=torch.float32, device=q.device)
    dev = q.get_device()
    err = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), pos.data_ptr(), b, t, h, n_true, k.shape[2], sv,
        dh, int(window), _scale(dh, dt), int(dt == torch.bfloat16), dev,
        torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        msg = lib.decode_attention_error_string(err).decode()
        raise RuntimeError(f"decode_attention kernel launch failed: {msg}")
    global LAUNCHES
    LAUNCHES += 1
    return out
