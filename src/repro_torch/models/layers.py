"""Neural building blocks on the serving path (plain torch).

Every weight matmul goes through :func:`cim_matmul`, which dispatches on
the leaf type: a :class:`~repro_torch.core.deploy.DeployedWeight` runs the
block-sparse kernel, a :class:`~repro_torch.core.deploy.StackedLayerView`
runs its layer-indexed form, a raw tensor is a dense product (in QAT mode
between the fake-quantized activations and weight, eqs. 5-8, on the
fake-quant kernel). The paged decode and verify attention runs on the
decode-attention kernel (``kernels/decode_attention.py``), which keeps a
verify position equal to a one-token step; the MoE router and expert
products and a float head on the paged pass run on the grouped-product
kernel (``kernels/grouped_matmul.py``) for the same reason: its launch plan
and every sum order in it follow the types, K and N, never the row count;
prefill attention, norms and RoPE stay plain torch, as the reference leaves
them to XLA. The one-token decode over a contiguous cache
(:func:`decode_attention`, the hybrid family's ring buffer included) runs
on the decode-attention kernel too;
the encoder's bidirectional and the decoder's cross attention, LayerNorm
and GELU are plain torch, as the reference writes them in jnp.
Layouts follow the reference: (B, S, H, dh) activations and caches.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..core import deploy
from ..core import quant as Q
from ..core.cim_layer import CIMConfig
from ..kernels import ops
from ..launch.shardings import KVShards, constrain

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def maybe_quant_a(x: torch.Tensor, cim: CIMConfig) -> torch.Tensor:
    """eq. 5 on the fake-quant kernel in QAT mode (f32 math, ``x.dtype``
    out), else ``x``; its gradient is the clamped straight-through rule."""
    if cim.mode == "qat" and cim.quant.enabled:
        return ops.fake_quant(x, cim.quant.a_bits, cim.quant.a_signed)
    return x


def maybe_quant_w(w: torch.Tensor, cim: CIMConfig) -> torch.Tensor:
    """eqs. 6 and 8 in QAT mode: tanh-normalize in f32, then eq. 8 on the
    fake-quant kernel, ``w.dtype`` out. Re-quantized on every call, as the
    reference does. eq. 8 has no clamp in the reference, so its gradient
    is the unclamped straight-through rule (the normalized weight reaches
    +-1 at each group's maximum, where a clamp's would halve)."""
    if cim.mode == "qat" and cim.quant.enabled:
        wq = Q.tanh_normalize(w.float(), cim.quant.group_size)
        return ops.fake_quant(wq, cim.quant.w_bits, signed=True,
                              out_dtype=w.dtype, ste="noclip")
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


def rmsnorm_rows(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6
                 ) -> torch.Tensor:
    """:func:`rmsnorm` with the mean of squares summed by ``ops.row_sum``,
    so a row's output does not depend on how many rows the batch has (the
    library mean picks its reduction split from the row count on the
    card). The paged decode and verify passes use it: a T-token verify
    then gives each position exactly what T one-token steps give."""
    x32 = x.float()
    var = ops.row_sum(x32 * x32)[..., None] / x32.shape[-1]
    return (x32 * torch.rsqrt(var + eps) * (1.0 + g.float())).to(x.dtype)


def layernorm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with bias in f32 (the biased variance), ``x.dtype`` out."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * g + b).to(x.dtype)


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


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      n_heads: int, chunk: int, window: int = 0,
                      offset: int = 0, n_true: int = 0) -> torch.Tensor:
    """Online-softmax attention over KV chunks of ``chunk`` keys, never
    building the (Sq, Sk) scores (the reference's ``chunked_attention``,
    plain torch as the reference's is plain jnp). q: (B,Sq,H,dh); k, v:
    (B,Sk,KV,dh) un-expanded, each chunk expanded to ``n_heads`` by the
    true ratio ``n_true`` (:func:`_expand_kv`). Causal with an optional
    sliding ``window``; ``offset`` is the absolute position of q row 0
    minus k row 0. The last chunk is zero-padded and its padding masked.
    The running max, sum and output are f32; the result is ``q.dtype``."""
    b, sq, _, dh = q.shape
    sk = k.shape[1]
    pad = (-sk) % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    qi = (torch.arange(sq, device=q.device) + offset)[:, None]
    # 1 / sqrt(dh) rounded to f32, as the reference's jnp scalar
    scale = float(1.0 / torch.sqrt(torch.tensor(float(dh))))
    q32 = q.float()
    f32 = dict(dtype=torch.float32, device=q.device)
    m = torch.full((b, n_heads, sq), NEG_INF, **f32)
    l = torch.zeros((b, n_heads, sq), **f32)
    acc = torch.zeros((b, sq, n_heads, dh), **f32)
    for kj0 in range(0, k.shape[1], chunk):
        ke = _expand_kv(k[:, kj0:kj0 + chunk], n_heads, n_true).float()
        s = torch.einsum("bqhd,bkhd->bhqk", q32, ke) * scale  # (B,H,Sq,C)
        kj = kj0 + torch.arange(chunk, device=q.device)[None, :]
        mask = (kj <= qi) & (kj < sk)
        if window > 0:
            mask = mask & (kj > qi - window)
        s = torch.where(mask[None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)  # (B,H,Sq)
        l = l * alpha + p.sum(dim=-1)
        ve = _expand_kv(v[:, kj0:kj0 + chunk], n_heads, n_true).float()
        pv = torch.einsum("bhqk,bkhd->bqhd", p, ve)
        acc = acc * alpha.transpose(1, 2)[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l.transpose(1, 2)[..., None], min=1e-30)
    return out.to(q.dtype)


def uses_chunked_attention(cfg, s: int) -> bool:
    """Whether a prefill of ``s`` positions takes :func:`chunked_attention`:
    the reference's condition, ``attn_chunk`` set and ``s >= max(4 *
    attn_chunk, 8192)`` (below that the unchunked scores are cheaper)."""
    chunk = cfg.attn_chunk
    return bool(chunk) and s >= max(4 * chunk, 8192)


def self_attention(p: dict, x: torch.Tensor, cfg, window: int = 0,
                   positions: Optional[torch.Tensor] = None,
                   use_rope: bool = True
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence causal self-attention (train, prefill), chunked under
    :func:`uses_chunked_attention`. Returns (y, (k, v))."""
    b, s, _ = x.shape
    nh = cfg.n_heads_eff
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = qkv_project(p, x, cfg, cfg.cim)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if uses_chunked_attention(cfg, s):
        o = chunked_attention(q, k, v, nh, cfg.attn_chunk, window=window,
                              n_true=cfg.n_heads)
    else:
        mask = causal_mask(s, s, window, device=x.device)
        o = attention_scores(q, _expand_kv(k, nh, cfg.n_heads),
                             _expand_kv(v, nh, cfg.n_heads), mask)
    y = cim_matmul(o.reshape(b, s, nh * cfg.dh), p["wo"], cfg.cim)
    return y, (k, v)


def bidir_attention(p: dict, x: torch.Tensor, cfg, use_rope: bool = False
                    ) -> torch.Tensor:
    """Encoder self-attention, every query over every key (no mask)."""
    b, s, _ = x.shape
    nh = cfg.n_heads_eff
    q, k, v = qkv_project(p, x, cfg, cfg.cim)
    if use_rope:
        pos = torch.arange(s, device=x.device)[None, :]
        q, k = rope(q, pos, cfg.rope_theta), rope(k, pos, cfg.rope_theta)
    mask = torch.ones((1, 1, s, s), dtype=torch.bool, device=x.device)
    o = attention_scores(q, _expand_kv(k, nh, cfg.n_heads),
                         _expand_kv(v, nh, cfg.n_heads), mask)
    return cim_matmul(o.reshape(b, s, -1), p["wo"], cfg.cim)


def cross_attention(p: dict, x: torch.Tensor,
                    enc_kv: Tuple[torch.Tensor, torch.Tensor], cfg
                    ) -> torch.Tensor:
    """Decoder cross-attention against precomputed encoder K/V (B, T, KV,
    dh): every query over every encoder position."""
    b, s, _ = x.shape
    nh = cfg.n_heads_eff
    q = cim_matmul(x, p["wq"], cfg.cim).reshape(b, s, nh, cfg.dh)
    k, v = enc_kv
    mask = torch.ones((1, 1, s, k.shape[1]), dtype=torch.bool,
                      device=x.device)
    o = attention_scores(q, _expand_kv(k, nh, cfg.n_heads),
                         _expand_kv(v, nh, cfg.n_heads), mask)
    return cim_matmul(o.reshape(b, s, -1), p["wo"], cfg.cim)


def _narrow_to(a: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``a`` in ``dt`` where that narrows it, else as it is: a widening
    cast changes no value, and the decode-attention kernel widens bf16 K/V
    itself."""
    return a if torch.promote_types(a.dtype, dt) == dt else a.to(dt)


def decode_attention(p: dict, x1: torch.Tensor, kcache: torch.Tensor,
                     vcache: torch.Tensor, pos: int, cfg, window: int = 0,
                     use_rope: bool = True, ring: bool = False):
    """One-token decode over a contiguous cache (B, Smax, KV, dh), the
    reference's ``decode_attention``: the token at absolute position
    ``pos`` writes its K/V into slot ``pos`` in place and attends the
    slots up to ``pos``, only the last ``window`` of them when ``window >
    0``. With ``ring`` the cache is a ring: the token writes slot ``pos %
    Smax`` and attends every valid slot, the first ``min(pos + 1, Smax)``
    (with ``Smax`` the window, a sliding window of ``Smax`` keys). RoPE
    rotates each key at its absolute position before it is stored, and
    attention does not depend on the order of its keys, so a ring's slots
    need no order: the kernel's query at ``min(pos, Smax - 1)`` with no
    window masks ``slot <= min(pos, Smax - 1)``, exactly the valid slots.
    The attention runs on the decode-attention kernel (its plain version
    for CPU tensors). Returns (y (B, 1, D), kcache, vcache), the caches
    the ones given, written in place."""
    b = x1.shape[0]
    smax = kcache.shape[1]
    q, k, v = qkv_project(p, x1, cfg, cfg.cim)
    if use_rope:
        pp = torch.full((1, 1), pos, dtype=torch.long, device=x1.device)
        q, k = rope(q, pp, cfg.rope_theta), rope(k, pp, cfg.rope_theta)
    slot = pos % smax if ring else pos
    kcache[:, slot] = k[:, 0].to(kcache.dtype)
    vcache[:, slot] = v[:, 0].to(vcache.dtype)
    last, window = (min(pos, smax - 1), 0) if ring else (pos, window)
    o = ops.decode_attention(
        q, _narrow_to(kcache, x1.dtype), _narrow_to(vcache, x1.dtype),
        torch.full((b,), last, dtype=torch.long, device=x1.device), window,
        cfg.n_heads)
    return cim_matmul(o.reshape(b, 1, -1), p["wo"], cfg.cim), kcache, vcache


def decode_attention_multi(p: dict, xt: torch.Tensor, kview: torch.Tensor,
                           vview: torch.Tensor, pos: torch.Tensor, cfg,
                           window: int = 0, use_rope: bool = True):
    """Multi-token decode with PER-ROW positions over a gathered KV view.

    Row b's T query tokens sit at absolute positions pos[b] .. pos[b]+T-1;
    ``kview``/``vview`` (B, Sv, KV, dh) are the gathered paged blocks. The
    query tokens' own K/V stand in for the view's at their positions (the
    kernel reads them from ``k_new``/``v_new``, so the view is neither
    copied nor changed); positions past each query are masked causally.
    The attention runs on the decode-attention kernel
    (``kernels/decode_attention.py``), whose sums take one order per query
    row, so each query's output is the same whatever T and the view's
    length.
    Returns (y, k_new, v_new) with k_new/v_new (B, T, KV, dh) for the pool
    write-back. Views split by KV head over the macros (:class:`KVShards`)
    take :func:`_attention_by_macro`."""
    b, t, _ = xt.shape
    q, k, v = qkv_project(p, xt, cfg, cfg.cim)
    pp = pos[:, None] + torch.arange(t, device=xt.device)[None, :]  # (B, T)
    if use_rope:
        q, k = rope(q, pp, cfg.rope_theta), rope(k, pp, cfg.rope_theta)
    # the attention reads the views, and the step's K/V rounded to the
    # view's type, as xt's type
    cast = lambda a: _narrow_to(a, xt.dtype)
    k_new, v_new = cast(k.to(kview.dtype)), cast(v.to(vview.dtype))
    if isinstance(kview, KVShards):
        o = _attention_by_macro(q, KVShards(map(cast, kview.parts)),
                                KVShards(map(cast, vview.parts)), pos,
                                window, cfg.n_heads, k_new, v_new)
    else:
        o = ops.decode_attention(q, cast(kview), cast(vview), pos, window,
                                 cfg.n_heads, k_new, v_new)
    y = cim_matmul(o.reshape(b, t, -1), p["wo"], cfg.cim)
    return y, k, v


def _attention_by_macro(q: torch.Tensor, kview: KVShards, vview: KVShards,
                        pos: torch.Tensor, window: int, n_true: int,
                        k_new: torch.Tensor, v_new: torch.Tensor
                        ) -> torch.Tensor:
    """The paged attention with the views split by KV head over the macros:
    one launch a macro, on its device, over its KV heads and the q heads
    they serve (a kv head serves a contiguous group of n_true / KV q heads,
    as ``_expand_kv`` repeats it), the outputs joined on heads on q's
    device, the padding heads past ``n_true`` zeros as in one launch. Each
    output row depends only on its own q, keys and position, so the rows
    are one launch's, bit for bit."""
    group = n_true // kview.shape[2]
    outs = []
    for d, (kp, vp, kn, vn) in enumerate(zip(
            kview.parts, vview.parts, kview.split(k_new),
            vview.split(v_new))):
        hq = kp.shape[2] * group
        outs.append(ops.decode_attention(
            q[:, :, d * hq:(d + 1) * hq].to(kp.device), kp, vp,
            pos.to(kp.device), window, hq, kn, vn).to(q.device))
    o = torch.cat(outs, dim=2)
    return F.pad(o, (0, 0, 0, q.shape[2] - n_true)) if q.shape[2] > n_true \
        else o


def gated_mlp(p: dict, x: torch.Tensor, cim: CIMConfig) -> torch.Tensor:
    h = F.silu(cim_matmul(x, p["w_gate"], cim)) * cim_matmul(x, p["w_up"],
                                                             cim)
    return cim_matmul(h, p["w_down"], cim)


def gelu_mlp(p: dict, x: torch.Tensor, cim: CIMConfig) -> torch.Tensor:
    """Whisper's MLP: GELU in its tanh form (``jax.nn.gelu``'s default)."""
    h = F.gelu(cim_matmul(x, p["w_up"], cim), approximate="tanh")
    return cim_matmul(h, p["w_down"], cim)


@dataclasses.dataclass
class MoERoute:
    """One ``moe_block`` call's routing, token groups flattened: ``gates``
    (G0, gs, e) f32 softmax; ``idx`` (G0, gs, k) the top-k experts, ties to
    the lower index; ``slot`` each choice's place in its expert's capacity;
    ``keep`` = slot < cap; ``gate`` the renormalized top-k gates, zero
    where dropped; ``onehot`` (G0, gs, k, e) int64."""

    gates: torch.Tensor
    idx: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    gate: torch.Tensor
    onehot: torch.Tensor
    cap: int


def moe_route(p: dict, x: torch.Tensor, cfg) -> MoERoute:
    """The routing of :func:`moe_block` (the reference's
    ``layers.moe_block`` up to ``gate_k * keep``). ``s`` must be a multiple
    of the group size, or the reference's reshape fails: so does this."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    gs = min(cfg.moe_group_size, s)
    if s % gs:
        raise ValueError(f"moe_block: sequence length {s} is not a multiple "
                         f"of the token group size {gs} (moe_group_size "
                         f"{cfg.moe_group_size})")
    g0 = b * (s // gs)
    cap = max(k, int(cfg.capacity_factor * gs * k / e))
    logits = ops.grouped_matmul(x.reshape(1, b * s, d).float(),
                                p["router"].float()[None])
    gates = torch.softmax(logits.reshape(g0, gs, e), dim=-1)
    # a stable descending sort puts equal gates in index order, as
    # jax.lax.top_k does
    gate, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    gate, idx = gate[..., :k], idx[..., :k]
    total = gate[..., 0]
    for j in range(1, k):
        total = total + gate[..., j]
    gate = gate / (total + 1e-9)[..., None]
    onehot = F.one_hot(idx, e)  # (g0, gs, k, e)
    pos = onehot.reshape(g0, gs * k, e).cumsum(dim=1).reshape(
        g0, gs, k, e) - 1
    slot = pos.gather(-1, idx[..., None])[..., 0]
    keep = slot < cap
    return MoERoute(gates=gates, idx=idx, slot=slot, keep=keep,
                    gate=gate * keep, onehot=onehot, cap=cap)


def moe_block(p: dict, x: torch.Tensor, cfg) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """Top-k MoE with grouped capacity dispatch; x (B, S, D) -> (y, aux).

    The reference's semantics (token groups of ``moe_group_size``, the
    capacity per group, drops past it, ``expert_split`` sub-experts taking
    their expert's dispatch, eq. 5/eqs. 6-8 on the expert inputs and
    stacks in QAT mode), with its one-hot einsums replaced by a gather and
    a scatter, which a one-hot product computes exactly. Each expert's
    kept choices take its first rows, in (group, slot) order, so the
    products run on the grouped-product kernel with each expert's filled
    row count. The combine adds each token's terms in f32, in sub-expert
    order, and rounds once to ``x.dtype``. Every step is row by row or
    elementwise, so a token's output does not depend on the other tokens
    of its call beyond the routing the reference gives it."""
    b, s, d = x.shape
    cim = cfg.cim
    e, k, split = cfg.n_experts, cfg.top_k, cfg.expert_split
    rt = moe_route(p, x, cfg)
    if cfg.moe_hints:
        # the reference's hints: the routing tensors stay sharded over the
        # data axis by token group (batch-major), so the expert exchange
        # happens at the dispatch, not while routing is built (a no-op on
        # plain tensors)
        rt.onehot = constrain(rt.onehot, ("data", None, None, None))
        rt.gate = constrain(rt.gate, ("data", None, None))
    g0, gs = rt.idx.shape[:2]
    rmax = g0 * rt.cap
    # kept rows an expert takes from each group, and where each group's
    # rows start in that expert's list
    taken = rt.onehot.sum(dim=(1, 2)).clamp(max=rt.cap)  # (g0, e)
    start = taken.cumsum(dim=0) - taken
    row = start.gather(1, rt.idx.reshape(g0, gs * k)).reshape(
        g0, gs, k) + rt.slot
    row = torch.where(rt.keep, row, rmax)  # a dropped choice: spare row
    xin = x.new_zeros((e, rmax + 1, d))
    src = x.reshape(g0, gs, 1, d).expand(g0, gs, k, d).reshape(-1, d)
    xin.index_put_((rt.idx.reshape(-1), row.reshape(-1)), src)
    xin = xin[:, :rmax]
    counts = taken.sum(dim=0)  # (e,)
    if split > 1:
        xin = xin.repeat_interleave(split, dim=0)
        counts = counts.repeat_interleave(split)

    def experts(w):  # eqs. 6-8 in x's type in QAT mode, as the reference
        return maybe_quant_w(w.to(x.dtype), cim) if cim.mode == "qat" else w

    xin = maybe_quant_a(xin, cim)
    h = F.silu(ops.grouped_matmul(xin, experts(p["w_gate"]), counts))
    h = maybe_quant_a(h * ops.grouped_matmul(xin, experts(p["w_up"]),
                                             counts), cim)
    out = ops.grouped_matmul(h, experts(p["w_down"]), counts)

    # each token's (choice, sub-expert) terms in ascending sub-expert order
    order = rt.idx.argsort(dim=-1)
    pick = lambda t: t.gather(-1, order)
    idx, row, keep = pick(rt.idx), pick(row), pick(rt.keep)
    gate = pick(rt.gate).to(x.dtype).float()
    row = torch.where(keep, row, 0)
    y = None
    for j in range(k):
        for sub in range(split):
            term = gate[..., j, None] * out[idx[..., j] * split + sub,
                                            row[..., j]].float()
            term = torch.where(keep[..., j, None], term, 0.0)
            y = term if y is None else y + term
    y = y.to(x.dtype).reshape(b, s, d)

    frac_tokens = rt.onehot.sum(dim=2).float().mean(dim=(0, 1))  # (e,)
    frac_router = rt.gates.mean(dim=(0, 1))
    aux = e * (frac_tokens * frac_router).sum()
    return y, aux


def embed(emb: torch.Tensor, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return emb[tokens.long()].to(dtype)


def logits_out(head, x: torch.Tensor, cim: CIMConfig) -> torch.Tensor:
    return cim_matmul(x, head, cim)


def logits_rows(head, x: torch.Tensor, cim: CIMConfig) -> torch.Tensor:
    """:func:`logits_out` with a float head's product on the grouped-product
    kernel, whose rows do not depend on the row count: its plan, and each
    output's order of operations (bf16 planes of x on wgmma, steps of K
    folded in a fixed order), follow the types, K and N alone, where the
    library product picks its sum order from the row count on the card.
    The paged decode and verify passes and the batch server's prefill use
    it, so a verify position's logits equal a one-token step's through a
    tied or dense head too. A packed head runs the block-sparse kernel, as
    in :func:`logits_out`."""
    if not torch.is_tensor(head):
        return logits_out(head, x, cim)
    if cim.mode == "qat":
        x, head = maybe_quant_a(x, cim), maybe_quant_w(head, cim)
        x = x.to(torch.promote_types(x.dtype, head.dtype))
    lead = x.shape[:-1]
    y = ops.grouped_matmul(x.reshape(1, -1, x.shape[-1]), head[None])
    return y.reshape(*lead, head.shape[-1])


def maybe_remat(fn, remat: bool, x: torch.Tensor):
    """``fn`` under ``torch.utils.checkpoint`` (non-reentrant) when
    ``remat`` and autograd records ``x``: a layer keeps only its inputs
    and is run again in the backward, with the same numerics. Serving is
    left as it is."""
    if remat and torch.is_grad_enabled() and x.requires_grad:
        return lambda *args: torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over unmasked positions, in f32. logits (B,S,V), labels
    (B,S); a mask's mean divides by its sum + 1e-9, as the reference's."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / (mask.sum() + 1e-9)
    return nll.mean()
