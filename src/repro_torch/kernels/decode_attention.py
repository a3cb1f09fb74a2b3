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
accept rule stands on. The kernel holds that by cutting the keys into
chunks of absolute positions (:func:`chunk_keys`), each summed in a fixed
order and the chunks added in ascending order, whatever launch
:func:`plan` picks; the plain version by taking every sum with
:func:`row_sum`. The two agree to a few ulps of the input type (their sums
run in different orders). ``k_new``/``v_new`` stand in for the view's keys
at the query positions, so the paged pass need not copy its view. The
wrapper takes the plain version only for tensors on the CPU (or the meta
device, shapes only); on CUDA tensors it launches the kernel (one launch
a call) or raises.
``LAUNCHES`` counts the launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..device import PLAIN_DEVICES
from . import _build

LAUNCHES = 0

# the chunk every plain-version sum is cut into
SUM_CHUNK = 32
# the masked score (as models.layers.NEG_INF): exp() of it minus any
# finite max is exactly 0
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

# largest cluster, 16-row MMA tiles a query tile and shared memory a CTA
MAX_CLUSTER = 8
MAX_M_TILES = 4
SMEM_MAX = 232448

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
            p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, i,
            i, i, i, i, i, i, i, p]
        lib.decode_attention_launch.restype = i
        lib.decode_attention_smem.argtypes = [i] * 8
        lib.decode_attention_smem.restype = i
        lib.decode_attention_chunk_keys.argtypes = [i]
        lib.decode_attention_chunk_keys.restype = i
        lib.decode_attention_error_string.argtypes = [i]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


@dataclasses.dataclass(frozen=True)
class Plan:
    """A launch of the kernel: ``tokens`` query tokens a tile (with the G
    heads of one kv head: ``m_tiles`` MMA tiles of 16 rows), clusters of
    ``cluster`` CTAs, each keeping the scores of ``cache`` chunks and the
    p . v partials of ``slots`` chunks at once."""
    tokens: int
    m_tiles: int
    cluster: int
    cache: int
    slots: int


def chunk_keys(kv_elt: int) -> int:
    """The kernel's chunk of absolute key positions for the K/V element
    size (128 keys over bf16 K/V, 64 over f32, whose tiles are twice as
    wide), as the built kernel gives it."""
    return _lib().decode_attention_chunk_keys(kv_elt)


@functools.lru_cache(maxsize=256)
def plan(b: int, t: int, h_true: int, kv: int, sv: int, dh: int, q_elt: int,
         kv_elt: int, sms: int) -> Plan:
    """The launch plan for these shapes on a card of ``sms`` SMs; it reads
    nothing else (not the positions, not the data), and no plan changes a
    row's result: each row's sums take the order of its own chunks.

    A tile takes as many of the T tokens as fit in MAX_M_TILES 16-row MMA
    tiles with the G heads of a kv head (all its rows share each K/V row
    loaded), split evenly over the tiles, unless the view has too few
    chunks for those tiles' clusters to fill the wave: then as many tokens
    as give the most CTAs. The cluster is as large as keeps the B x KV x
    tiles clusters within one wave of the SMs (at most MAX_CLUSTER, at
    most the view's chunks; larger where a CTA's share of a long view
    needs it); the wave is three quarters of the SMs, since a cluster's
    CTAs share one GPC and a GPC's spare SMs go unused. Half the shared
    memory left over goes to chunk partials (the chunks past them are
    added in rounds), then the scores of as many chunks as fit (the rest
    are recomputed from K), then the rest to partials again. Shared memory
    is sized by the kernel's own layout (``decode_attention_smem``), so
    the plan cannot disagree with the launch it makes."""
    size = functools.partial(_lib().decode_attention_smem, q_elt, kv_elt)
    g = h_true // kv
    chunk = chunk_keys(kv_elt)
    nch = max(1, -(-sv // chunk))
    wave = sms - sms // 4  # the clusters a GPC's spare SMs cannot hold

    def ctas(tokens):
        tiles = b * kv * -(-t // tokens)
        return tiles * min(MAX_CLUSTER, nch, max(1, wave // tiles))

    # the most tokens a tile (sharing each K/V row among the most rows)
    # that still fills the wave; failing that, the most CTAs
    counts = sorted({-(-t // -(-t // n))
                     for n in range(1, min(t, 16 * MAX_M_TILES // g) + 1)},
                    reverse=True)
    full = [n for n in counts if ctas(n) >= wave * 9 // 10]
    tokens = full[0] if full else max(counts, key=ctas)
    fit = None
    while fit is None:
        tokens = -(-t // -(-t // tokens))  # the same count in every tile
        m_tiles = -(-(g * tokens) // 16)
        tiles = b * kv * -(-t // tokens)
        top = min(MAX_CLUSTER, nch)
        for cluster in range(max(1, min(top, wave // max(tiles, 1))),
                             top + 1):
            base = size(m_tiles, dh, sv, cluster, 0, 1)
            if base <= SMEM_MAX:
                fit = cluster, base
                break
        if fit is None and tokens == 1:
            raise ValueError(f"no plan fits {SMEM_MAX} bytes of shared "
                             f"memory for dh {dh}, {g} heads to a kv head, "
                             f"view {sv}")
        tokens = tokens if fit else max(1, tokens // 2)
    cluster, base = fit
    nk = -(-nch // cluster)
    # the bytes of one more chunk of cached scores, of one more partial slot
    score = size(m_tiles, dh, sv, cluster, 1, 1) - base
    partial = size(m_tiles, dh, sv, cluster, 0, 2) - base
    room = SMEM_MAX - base
    slots = 1 + min(nk - 1, room // 2 // partial)
    room -= (slots - 1) * partial
    cache = min(nk, room // score)
    slots = min(nk, slots + (room - cache * score) // partial)
    assert size(m_tiles, dh, sv, cluster, cache, slots) <= SMEM_MAX
    return Plan(tokens, m_tiles, cluster, cache, slots)


def launch_plan(q: torch.Tensor, k: torch.Tensor, n_true: int,
                dt: torch.dtype, kv_dt: torch.dtype) -> Plan:
    """:func:`plan` for a call's shapes and types (``dt`` of q and the
    output, ``kv_dt`` of K/V) on the card that holds q."""
    b, t, _, dh = q.shape
    return plan(b, t, n_true, k.shape[2], k.shape[1], dh, _elt(dt),
                _elt(kv_dt), _sm_count(q.get_device()))


def _elt(dt: torch.dtype) -> int:
    return 2 if dt == torch.bfloat16 else 4


@functools.lru_cache(maxsize=16)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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


def _check(q, k, v, pos, n_true, k_new=None, v_new=None):
    """Shapes checked; returns (n_true, the promoted type of all inputs,
    the promoted type of the K/V inputs)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q (B, T, H, dh) and k, v (B, Sv, KV, dh), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, t, h, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or pos.shape != (b,):
        raise ValueError(f"batch or head width disagree: q {tuple(q.shape)}"
                         f", k {tuple(k.shape)}, pos {tuple(pos.shape)}")
    new = (b, t) + tuple(k.shape[2:])
    if (k_new is None) != (v_new is None) or (
            k_new is not None and not k_new.shape == v_new.shape == new):
        raise ValueError(f"k_new and v_new go together, each {new}")
    n_true = n_true or h
    if n_true > h or n_true % k.shape[2]:
        raise ValueError(f"{n_true} true heads over {k.shape[2]} kv heads "
                         f"and {h} heads")
    kv_dt = torch.promote_types(k.dtype, v.dtype)
    if k_new is not None:
        kv_dt = torch.promote_types(
            torch.promote_types(kv_dt, k_new.dtype), v_new.dtype)
    return n_true, torch.promote_types(q.dtype, kv_dt), kv_dt


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
                           n_true: int = 0,
                           k_new: Optional[torch.Tensor] = None,
                           v_new: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Plain PyTorch version: the kernel's arithmetic over the masked,
    head-expanded views, every sum by :func:`row_sum`; ``k_new``/``v_new``
    are spliced into copies of the views at each row's query positions
    first. Returns (B, T, H, dh) in the promoted input type."""
    n_true, dt, _ = _check(q, k, v, pos, n_true, k_new, v_new)
    b, t, h, dh = q.shape
    pp = pos.long()[:, None] + torch.arange(t, device=q.device)[None, :]
    if k_new is not None:
        rows = torch.arange(b, device=q.device)[:, None]
        k = k.to(dt).index_put((rows, pp), k_new.to(dt))
        v = v.to(dt).index_put((rows, pp), v_new.to(dt))
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
                     pos: torch.Tensor, window: int = 0, n_true: int = 0,
                     k_new: Optional[torch.Tensor] = None,
                     v_new: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention of the query rows q (B, T, H, dh) at positions
    ``pos[b] + t`` over the views k, v (B, Sv, KV, dh): the first
    ``n_true`` heads (default H) share the KV heads in equal groups, the
    rest are zero padding. With ``k_new``/``v_new`` (B, T, KV, dh) the keys
    at positions ``pos[b] .. pos[b] + T - 1`` are theirs, not the view's,
    so the caller need not copy its view to splice them in. The result is
    in the promoted type of all inputs; bf16 K/V under f32 q are read as
    they are (the kernel widens them exactly), never copied. On the kernel
    for CUDA tensors, the plain version for CPU (or meta) ones; (B, T, H,
    dh) in the promoted input type."""
    if q.device.type in PLAIN_DEVICES:
        return decode_attention_plain(q, k, v, pos, window, n_true, k_new,
                                      v_new)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    n_true, dt, kv_dt = _check(q, k, v, pos, n_true, k_new, v_new)
    if dt not in _KERNEL_DTYPES or kv_dt not in _KERNEL_DTYPES:
        raise TypeError(f"the decode_attention kernel takes float32 or "
                        f"bfloat16, got {dt} over {kv_dt}")
    b, t, h, dh = q.shape
    if dh > _MAX_DH or n_true // k.shape[2] > _MAX_GROUP:
        raise ValueError(f"head width {dh} > {_MAX_DH} or more than "
                         f"{_MAX_GROUP} heads to a kv head")
    # q in the promoted type; bf16 K/V stay bf16 under f32 q (the kernel
    # widens them exactly), so the views are never copied to f32
    q = q if q.dtype == dt and q.is_contiguous() else q.to(dt).contiguous()
    k, v, k_new, v_new = (
        None if a is None else a if a.dtype == kv_dt and a.is_contiguous()
        else a.to(kv_dt).contiguous() for a in (k, v, k_new, v_new))
    if pos.dtype not in (torch.int32, torch.int64):
        pos = pos.to(torch.int32)
    pos = pos.contiguous()
    pl = launch_plan(q, k, n_true, dt, kv_dt)
    out = torch.empty(q.shape, dtype=dt, device=q.device)
    lib = _lib()
    dev = q.get_device()
    err = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if k_new is None else k_new.data_ptr(),
        None if v_new is None else v_new.data_ptr(), out.data_ptr(),
        pos.data_ptr(), b, t, h, n_true, k.shape[2], k.shape[1], dh,
        int(window), _scale(dh, dt), int(dt == torch.bfloat16),
        int(kv_dt == torch.bfloat16), int(pos.dtype == torch.int64),
        pl.tokens, pl.cluster, pl.cache, pl.slots, dev,
        torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        msg = lib.decode_attention_error_string(err).decode()
        raise RuntimeError(f"decode_attention kernel launch failed: {msg}")
    global LAUNCHES
    LAUNCHES += 1
    return out
