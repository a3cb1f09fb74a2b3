"""Mamba2 SSD (state-space duality) blocks [arXiv:2405.21060].

Chunked SSD for prefill (quadratic within chunks, linear across) and an
O(1)-state recurrent step for decode. The intra-chunk block runs on the
``ssd_intra`` kernel; the chunk states, the inter-chunk recurrence and the
entering-state term stay plain torch, as the reference leaves them to XLA.
All projections route through ``cim_matmul``, so MARS QAT applies to them.
Dtypes follow the reference: f32 inside the SSD, the residual stream, the
SSM state and the conv tail in the model dtype.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ssd_intra as K
from .layers import cim_matmul, rmsnorm


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum a[..., j+1..i], -inf for
    j > i. a: (..., l) -> (..., l, l)."""
    l = a.shape[-1]
    cum = a.cumsum(-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.ones((l, l), dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, chunk: int, h0: Optional[torch.Tensor] = None,
                intra_dtype: torch.dtype = torch.float32
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan. x: (B,S,H,P); a = dt*A: (B,S,H) (negative); b, c: (B,S,N)
    (one group, shared across heads). Returns (y: (B,S,H,P), h_final:
    (B,H,P,N)), both in ``x.dtype``. ``intra_dtype`` bf16 is the
    reference's ``ssd_lowp``: the intra-chunk block takes b, c and x in
    bf16 and gives its result in bf16 (on the kernel's bf16 route); the
    decays, states and the inter-chunk terms stay f32."""
    if intra_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"intra_dtype must be float32 or bfloat16, got "
                         f"{intra_dtype}")
    lowp = intra_dtype == torch.bfloat16
    bsz, s, n_h, p = x.shape
    n = b.shape[-1]
    pad = (-s) % chunk
    if pad:
        # a = 0 -> decay 1 and x = 0 adds nothing: padded steps pass the
        # state through unchanged (exact)
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    s_out, s = s, s + pad
    nc = s // chunk
    xc = x.reshape(bsz, nc, chunk, n_h, p)
    ac = a.reshape(bsz, nc, chunk, n_h).permute(0, 1, 3, 2)  # (B,nc,H,l)
    bc = b.reshape(bsz, nc, chunk, n)
    cc = c.reshape(bsz, nc, chunk, n)
    a_cum = ac.cumsum(-1)

    # 1) intra-chunk block on the kernel, kept in f32 until the sum below
    # (in bf16 under ssd_lowp; the sum promotes it to f32, as jnp does)
    cast = (lambda t: t.to(torch.bfloat16)) if lowp else (lambda t: t)
    y_diag = K.ssd_intra_chunk(
        ac.reshape(bsz * nc, n_h, chunk).contiguous(),
        cast(b).reshape(bsz * nc, chunk, n).contiguous(),
        cast(c).reshape(bsz * nc, chunk, n).contiguous(),
        cast(x).reshape(bsz * nc, chunk, n_h, p).contiguous(),
        out_dtype=intra_dtype,
    ).reshape(bsz, nc, chunk, n_h, p)

    # 2) per-chunk final states (jnp promotes the mixed operands to f32)
    decay = torch.exp(a_cum[..., -1:] - a_cum)  # (B,nc,H,l)
    states = torch.einsum("bcln,bchl,bclhp->bchpn", bc.float(), decay,
                          xc.float())

    # 3) inter-chunk recurrence over chunk boundaries
    chunk_decay = torch.exp(a_cum[..., -1])  # (B,nc,H)
    h = (torch.zeros((bsz, n_h, p, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    h_in = []
    for i in range(nc):
        h_in.append(h)  # the state entering chunk i
        h = h * chunk_decay[:, i, :, None, None] + states[:, i]
    h_in = torch.stack(h_in, dim=1)  # (B,nc,H,P,N)

    # 4) contribution of the entering state to each position of the chunk
    state_decay = torch.exp(a_cum)  # (B,nc,H,l)
    y_off = torch.einsum("bcln,bchpn,bchl->bclhp", cc.float(), h_in,
                         state_decay)

    y = (y_diag + y_off).reshape(bsz, s, n_h, p)[:, :s_out]
    return y.to(x.dtype), h.to(x.dtype)


def ssd_step(h: torch.Tensor, x1: torch.Tensor, a1: torch.Tensor,
             b1: torch.Tensor, c1: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent step. h: (B,H,P,N); x1: (B,H,P); a1: (B,H); b1, c1:
    (B,N). Returns (y1: (B,H,P), h_new in ``h.dtype``)."""
    da = torch.exp(a1)[..., None, None]
    h = (h.float() * da
         + torch.einsum("bhp,bn->bhpn", x1, b1).float()).to(h.dtype)
    return torch.einsum("bhpn,bn->bhp", h, c1), h


# ---------------------------------------------------------------------------
# The full Mamba2 block (in_proj -> conv -> SSD -> gate -> out_proj)
# ---------------------------------------------------------------------------


def mamba_init(g: torch.Generator, cfg, dtype, device: torch.device) -> dict:
    """One layer's parameters (callers stack over L), drawn from ``g``."""
    d, di = cfg.d_model, cfg.d_inner
    n_h, n, w = cfg.n_ssm_heads, cfg.ssm_state, cfg.conv_width
    conv_dim = di + 2 * n
    s = 1.0 / (d ** 0.5)

    def normal(shape, scale):
        return torch.randn(shape, generator=g, dtype=dtype,
                           device=device) * scale

    f32 = dict(dtype=torch.float32, device=device)
    common = {
        "a_log": torch.zeros((n_h,), **f32),  # A = -exp(a_log) = -1
        "dt_bias": torch.zeros((n_h,), **f32),
        "d_skip": torch.ones((n_h,), **f32),
        "norm_g": torch.zeros((di,), **f32),
        "out_proj": normal((di, d), 1.0 / di ** 0.5),
    }
    zeros = lambda k: torch.zeros((k,), dtype=dtype, device=device)
    if cfg.ssm_split_proj:
        # the reference's shard-aligned layout: z|x, b|c and dt weights with
        # per-segment depthwise convs, the same math as the fused in_proj
        return {
            "w_zx": normal((d, 2 * di), s),
            "w_bc": normal((d, 2 * n), s),
            "w_dt": normal((d, n_h), s),
            "conv_xw": normal((w, di), 0.1),
            "conv_xb": zeros(di),
            "conv_bcw": normal((w, 2 * n), 0.1),
            "conv_bcb": zeros(2 * n),
            **common,
        }
    return {
        "in_proj": normal((d, 2 * di + 2 * n + n_h), s),
        "conv_w": normal((w, conv_dim), 0.1),
        "conv_b": zeros(conv_dim),
        **common,
    }


def _split_proj(zxbcdt: torch.Tensor, cfg):
    di, n = cfg.d_inner, cfg.ssm_state
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * n],
            zxbcdt[..., 2 * di + 2 * n:])


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d + SiLU. xbc: (B,S,C); w: (W,C)."""
    width, ch = w.shape
    out = F.conv1d(F.pad(xbc.transpose(1, 2), (width - 1, 0)),
                   w.t().reshape(ch, 1, width), groups=ch)
    return F.silu(out.transpose(1, 2) + b)


def mamba_block(p: dict, x: torch.Tensor, cfg
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence forward. Returns (y, (conv_tail, h_final)) for the
    cache."""
    bsz, s, _ = x.shape
    di, n, n_h, w = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, \
        cfg.conv_width
    hp = di // n_h
    dt_ = x.dtype
    if "w_zx" in p:
        zx = cim_matmul(x, p["w_zx"].to(dt_), cfg.cim)
        z, xin = zx[..., :di], zx[..., di:]
        bc = cim_matmul(x, p["w_bc"].to(dt_), cfg.cim)
        dt = cim_matmul(x, p["w_dt"].to(dt_), cfg.cim)
        conv_tail = torch.cat([xin, bc], dim=-1)[:, -(w - 1):, :]
        xin = _causal_conv(xin, p["conv_xw"].to(dt_), p["conv_xb"].to(dt_))
        bc = _causal_conv(bc, p["conv_bcw"].to(dt_), p["conv_bcb"].to(dt_))
        xs = xin.reshape(bsz, s, n_h, hp)
        b, c = bc[..., :n], bc[..., n:]
    else:
        zxbcdt = cim_matmul(x, p["in_proj"].to(dt_), cfg.cim)
        z, xbc, dt = _split_proj(zxbcdt, cfg)
        conv_tail = xbc[:, -(w - 1):, :]
        xbc = _causal_conv(xbc, p["conv_w"].to(dt_), p["conv_b"].to(dt_))
        xs = xbc[..., :di].reshape(bsz, s, n_h, hp)
        b, c = xbc[..., di:di + n], xbc[..., di + n:]
    dt = F.softplus(dt.float() + p["dt_bias"])  # (B,S,H)
    a = -torch.exp(p["a_log"])[None, None, :] * dt  # (B,S,H), negative
    y, h_last = ssd_chunked((xs * dt[..., None]).to(dt_), a.float(),
                            b.to(dt_), c.to(dt_), min(cfg.ssm_chunk, s),
                            intra_dtype=(torch.bfloat16 if cfg.ssd_lowp
                                         else torch.float32))
    y = y + xs * p["d_skip"][None, None, :, None].to(dt_)
    y = rmsnorm(y.reshape(bsz, s, di), p["norm_g"]) * F.silu(z)
    return (cim_matmul(y, p["out_proj"].to(dt_), cfg.cim),
            (conv_tail.contiguous(), h_last))


def mamba_decode_step(p: dict, x1: torch.Tensor, conv_state: torch.Tensor,
                      h: torch.Tensor, cfg
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode. x1: (B,1,D); conv_state: (B,W-1,conv_dim); h:
    (B,H,P,N). Returns (y1, conv_state, h), new tensors."""
    bsz = x1.shape[0]
    di, n, n_h = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    hp = di // n_h
    dt_ = x1.dtype
    if "w_zx" in p:
        zx = cim_matmul(x1, p["w_zx"].to(dt_), cfg.cim)[:, 0, :]
        z, xin = zx[..., :di], zx[..., di:]
        bc = cim_matmul(x1, p["w_bc"].to(dt_), cfg.cim)[:, 0, :]
        dt = cim_matmul(x1, p["w_dt"].to(dt_), cfg.cim)[:, 0, :]
        xbc = torch.cat([xin, bc], dim=-1)
        conv_w = torch.cat([p["conv_xw"], p["conv_bcw"]], dim=-1)
        conv_b = torch.cat([p["conv_xb"], p["conv_bcb"]], dim=-1)
    else:
        zxbcdt = cim_matmul(x1, p["in_proj"].to(dt_), cfg.cim)
        z, xbc, dt = _split_proj(zxbcdt[:, 0, :], cfg)
        conv_w, conv_b = p["conv_w"], p["conv_b"]
    window = torch.cat([conv_state, xbc[:, None, :]], dim=1)  # (B,W,C)
    conv = torch.einsum("bwc,wc->bc", window, conv_w.to(dt_))
    xbc = F.silu(conv + conv_b.to(dt_))
    xs = xbc[..., :di].reshape(bsz, n_h, hp)
    b, c = xbc[..., di:di + n], xbc[..., di + n:]
    dt = F.softplus(dt.float() + p["dt_bias"])  # (B,H)
    a = -torch.exp(p["a_log"])[None, :] * dt
    y1, h = ssd_step(h, (xs * dt[..., None]).to(dt_), a, b.to(dt_),
                     c.to(dt_))
    y1 = (y1 + xs * p["d_skip"][None, :, None].to(dt_)).to(dt_)
    y1 = rmsnorm(y1.reshape(bsz, 1, di), p["norm_g"]) * F.silu(z[:, None, :])
    return (cim_matmul(y1, p["out_proj"].to(dt_), cfg.cim),
            window[:, 1:, :], h)
