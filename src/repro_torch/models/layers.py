"""Neural building blocks on the serving path (plain torch).

Every weight matmul goes through :func:`cim_matmul`, which dispatches on
the leaf type: a :class:`~repro_torch.core.deploy.DeployedWeight` runs the
block-sparse kernel, a :class:`~repro_torch.core.deploy.StackedLayerView`
runs its layer-indexed form, a raw tensor is a dense product (in QAT mode
between the fake-quantized activations and weight, eqs. 5-8, on the
fake-quant kernel). Attention, norms and RoPE stay plain torch, as the
reference leaves them to XLA.
Layouts follow the reference: (B, S, H, dh) activations and caches.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core import deploy
from ..core import quant as Q
from ..core.cim_layer import CIMConfig
from ..kernels import ops

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def maybe_quant_a(x: torch.Tensor, cim: CIMConfig) -> torch.Tensor:
    """eq. 5 on the fake-quant kernel in QAT mode (f32 math, ``x.dtype``
    out), else ``x``."""
    if cim.mode == "qat" and cim.quant.enabled:
        return ops.fake_quant(x, cim.quant.a_bits, cim.quant.a_signed)
    return x


def maybe_quant_w(w: torch.Tensor, cim: CIMConfig) -> torch.Tensor:
    """eqs. 6 and 8 in QAT mode: tanh-normalize in f32, then eq. 8 on the
    fake-quant kernel, ``w.dtype`` out. Re-quantized on every call, as the
    reference does."""
    if cim.mode == "qat" and cim.quant.enabled:
        wq = Q.tanh_normalize(w.float(), cim.quant.group_size)
        return ops.fake_quant(wq, cim.quant.w_bits, signed=True).to(w.dtype)
    return w


def cim_matmul(x: torch.Tensor, w, cim: CIMConfig) -> torch.Tensor:
    """x @ w, dispatched on the type of ``w`` (see the module docstring).
    A raw weight in QAT mode multiplies the fake-quantized activations by
    the fake-quantized weight, in their promoted type as ``jnp`` does."""
    if isinstance(w, deploy.DeployedWeight):
        return deploy.deployed_matmul(x, w, a_bits=cim.quant.a_bits)
    if isinstance(w, deploy.StackedLayerView):
        return deploy.stacked_matmul(x, w.sw, w.layer,
                                     a_bits=cim.quant.a_bits)
    if cim.mode == "qat":
        xq, wq = maybe_quant_a(x, cim), maybe_quant_w(w, cim)
        dt = torch.promote_types(xq.dtype, wq.dtype)
        return xq.to(dt) @ wq.to(dt)
    return x @ w.to(x.dtype)


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + g.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, dh); positions: (..., S)."""
    half = x.shape[-1] // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(float(theta), exps)  # a Python base: no host-device copy
    ang = positions[..., None].float() * freq  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _expand_kv(k: torch.Tensor, n_heads: int, n_true: int = 0
               ) -> torch.Tensor:
    """(B, S, KV, dh) -> (B, S, H, dh): repeat each kv head by the TRUE
    H/KV ratio, then zero-pad up to ``n_heads``."""
    kv = k.shape[2]
    n_true = n_true or n_heads
    if kv != n_true:
        k = k.repeat_interleave(n_true // kv, dim=2)
    if n_heads > n_true:
        k = F.pad(k, (0, 0, 0, n_heads - n_true))
    return k


def attention_scores(q, k, v, mask) -> torch.Tensor:
    """q: (B,Sq,H,dh) k,v: (B,Sk,H,dh) mask: broadcastable (B,1,Sq,Sk).
    Operands of mixed dtype are promoted first, as ``jnp.einsum`` does."""
    dt = torch.promote_types(q.dtype, k.dtype)
    scale = torch.tensor(math.sqrt(q.shape[-1]), dtype=torch.float32).to(
        q.dtype)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(dt), k.to(dt)) / scale
    scores = torch.where(mask, scores.float(), NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    dt = torch.promote_types(probs.dtype, v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(dt), v.to(dt))


def causal_mask(sq: int, sk: int, window: int = 0, offset: int = 0,
                device=None) -> torch.Tensor:
    """(1,1,Sq,Sk) causal (+sliding window) mask; ``window <= 0`` = full."""
    qi = torch.arange(sq, device=device)[:, None] + offset
    kj = torch.arange(sk, device=device)[None, :]
    m = kj <= qi
    if window > 0:
        m = m & (kj > qi - window)
    return m[None, None]


def qkv_project(p: dict, x: torch.Tensor, cfg, cim: CIMConfig):
    b, s, _ = x.shape
    q = cim_matmul(x, p["wq"], cim).reshape(b, s, cfg.n_heads_eff, cfg.dh)
    k = cim_matmul(x, p["wk"], cim).reshape(b, s, cfg.n_kv_heads_eff, cfg.dh)
    v = cim_matmul(x, p["wv"], cim).reshape(b, s, cfg.n_kv_heads_eff, cfg.dh)
    return q, k, v


def self_attention(p: dict, x: torch.Tensor, cfg, window: int = 0,
                   positions: Optional[torch.Tensor] = None,
                   use_rope: bool = True
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence causal self-attention (prefill). Returns (y, (k, v))."""
    b, s, _ = x.shape
    nh = cfg.n_heads_eff
    if cfg.attn_chunk:
        raise NotImplementedError("chunked attention is not ported yet")
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = qkv_project(p, x, cfg, cfg.cim)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    mask = causal_mask(s, s, window, device=x.device)
    o = attention_scores(q, _expand_kv(k, nh, cfg.n_heads),
                         _expand_kv(v, nh, cfg.n_heads), mask)
    y = cim_matmul(o.reshape(b, s, nh * cfg.dh), p["wo"], cfg.cim)
    return y, (k, v)


def decode_attention_multi(p: dict, xt: torch.Tensor, kview: torch.Tensor,
                           vview: torch.Tensor, pos: torch.Tensor, cfg,
                           window: int = 0, use_rope: bool = True):
    """Multi-token decode with PER-ROW positions over a gathered KV view.

    Row b's T query tokens sit at absolute positions pos[b] .. pos[b]+T-1;
    ``kview``/``vview`` (B, Sv, KV, dh) are the gathered paged blocks. The
    query tokens' own K/V are written into a copy of the view before
    attending (the caller's view is left as it was); positions past each
    query are masked causally. Returns (y, k_new, v_new) with k_new/v_new
    (B, T, KV, dh) for the pool write-back."""
    b, t, _ = xt.shape
    q, k, v = qkv_project(p, xt, cfg, cfg.cim)
    pp = pos[:, None] + torch.arange(t, device=xt.device)[None, :]  # (B, T)
    if use_rope:
        q, k = rope(q, pp, cfg.rope_theta), rope(k, pp, cfg.rope_theta)
    rows = torch.arange(b, device=xt.device)[:, None]
    kview = kview.index_put((rows, pp), k.to(kview.dtype))
    vview = vview.index_put((rows, pp), v.to(vview.dtype))
    kj = torch.arange(kview.shape[1], device=xt.device)[None, None, None, :]
    pe = pp[:, None, :, None]  # (B, 1, T, 1) per-query positions
    mask = kj <= pe
    if window > 0:
        mask = mask & (kj > pe - window)
    nh = cfg.n_heads_eff
    o = attention_scores(
        q, _expand_kv(kview.to(xt.dtype), nh, cfg.n_heads),
        _expand_kv(vview.to(xt.dtype), nh, cfg.n_heads), mask)
    y = cim_matmul(o.reshape(b, t, -1), p["wo"], cfg.cim)
    return y, k, v


def gated_mlp(p: dict, x: torch.Tensor, cim: CIMConfig) -> torch.Tensor:
    h = F.silu(cim_matmul(x, p["w_gate"], cim)) * cim_matmul(x, p["w_up"],
                                                             cim)
    return cim_matmul(h, p["w_down"], cim)


def embed(emb: torch.Tensor, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return emb[tokens.long()].to(dtype)


def logits_out(head, x: torch.Tensor, cim: CIMConfig) -> torch.Tensor:
    return cim_matmul(x, head, cim)
