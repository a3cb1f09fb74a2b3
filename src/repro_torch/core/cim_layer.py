"""CIMLinear / CIMConv2D: MARS's technique as functions on dicts of tensors.

``*_init`` returns a params dict (and, for a conv, a BN state dict);
``*_apply`` is a plain function, a conv's returning ``(y, new_state)``.
Modes, selected by :class:`CIMConfig`:

  * dense - plain float matmul/conv (the paper's 32/32 rows);
  * qat   - quantization-aware training: eq. 5 on activations, eqs. 6-8 on
            weights with the BN scale fused (eq. 7), an optional pruning
            mask, the group lasso collected by ``*_regularizer``.

Eq. 5 runs on the fake-quant kernel (``ops.fake_quant``, the clamped
straight-through rule). Eqs. 7 and 8 run there in one launch too: the
reference clips ``w_hat * scale`` with ``jnp.clip`` and rounds it with no
clamp, which is the kernel's signed mode with the clamped rule, forward and
gradient alike (half the slope on a bound). Conv tensors keep the
reference's layouts, NHWC activations and HWIO weights, so eq. 6's column
groups, eq. 4's per-position tiles and the masks lie on the same
(kh kw cin, cout) matrix; the conv itself is ``F.conv2d`` on channels-last
views, as the reference's is ``lax.conv`` outside any Pallas kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..kernels import ops
from . import quant as Q
from . import sparsity as S
from .quant import QuantConfig
from .sparsity import SparsityConfig


@dataclasses.dataclass(frozen=True)
class CIMConfig:
    quant: QuantConfig = dataclasses.field(default_factory=QuantConfig)
    sparsity: SparsityConfig = dataclasses.field(
        default_factory=SparsityConfig)
    mode: str = "dense"  # dense | qat | deploy
    bn_momentum: float = 0.9

    def with_mode(self, mode: str) -> "CIMConfig":
        return dataclasses.replace(self, mode=mode)


DENSE = CIMConfig(mode="dense")


def _quant_weight(w: torch.Tensor, bits: int) -> torch.Tensor:
    """eqs. 7-8 after the scale is applied: clip to [-1, 1], then eq. 8
    (on the kernel; at 32 bits the clip alone, as the reference leaves
    it)."""
    if bits >= 32:
        return Q.clip(w, -1.0, 1.0)
    return ops.fake_quant(w, bits, signed=True, ste="clip")


def _masked(params: dict) -> torch.Tensor:
    """The master weight times its mask; masks never take a gradient."""
    w = params["w"]
    if "mask" in params:
        w = w * params["mask"].detach().to(w.dtype)
    return w


# ---------------------------------------------------------------------------
# CIMLinear
# ---------------------------------------------------------------------------


def linear_init(generator: torch.Generator, d_in: int, d_out: int,
                cfg: CIMConfig = DENSE, dtype: torch.dtype = torch.float32,
                bias: bool = False, device: DeviceLike = None) -> dict:
    """A (d_in, d_out) weight drawn from ``generator`` (on ``device``) at
    scale 1/sqrt(d_in); a zero bias; in qat mode an all-ones mask."""
    dev = resolve_device(device)
    p = {"w": torch.randn((d_in, d_out), generator=generator, dtype=dtype,
                          device=dev) * (1.0 / d_in ** 0.5)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=dev)
    if cfg.mode == "qat":
        p["mask"] = torch.ones((d_in, d_out), dtype=torch.float32,
                               device=dev)
    return p


def effective_weight(params: dict, cfg: CIMConfig,
                     norm_scale: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """The weight actually multiplied: masked, tanh-normalized, scale-fused,
    quantized (eqs. 6-8); in dense mode ``params["w"]`` itself. A 3-D
    weight is a layer stack, normalized as the reference does."""
    w = params["w"]
    if cfg.mode == "dense":
        return w
    w = _masked(params)
    qc = cfg.quant
    if not qc.enabled and norm_scale is None:
        return w
    w_hat = Q.tanh_normalize(w.float(), qc.group_size)
    if norm_scale is not None:  # an RMSNorm gain folded on the input axis
        w_hat = w_hat * norm_scale.float()[..., :, None]
    return _quant_weight(w_hat, qc.w_bits).to(w.dtype)


def linear_apply(params: dict, x: torch.Tensor, cfg: CIMConfig = DENSE,
                 norm_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = quant(x) @ quant(w) + b."""
    if cfg.mode != "dense" and cfg.quant.enabled:
        x = ops.fake_quant(x, cfg.quant.a_bits, cfg.quant.a_signed)
    y = x @ effective_weight(params, cfg, norm_scale).to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def linear_regularizer(params: dict, cfg: CIMConfig) -> torch.Tensor:
    """Group lasso (eq. 4) + L2 (eq. 1) of this layer's master weight."""
    sc = cfg.sparsity
    w = params["w"].float()
    if w.dim() == 3:  # a layer stack
        r = sum(S.group_lasso_2d(m, sc.n, sc.alpha) for m in w)
    else:
        r = S.group_lasso_2d(w, sc.n, sc.alpha)
    total = sc.lambda_g / 2.0 * r
    if sc.lambda_l2 > 0:
        total = total + sc.lambda_l2 / 2.0 * (w * w).sum()
    return total


def linear_prune(params: dict, cfg: CIMConfig) -> dict:
    """A copy of ``params`` with the mask recomputed from the tile norms
    (each layer of a stack on its own)."""
    sc = cfg.sparsity
    w = params["w"].detach()
    if w.dim() == 3:
        mask = torch.stack([S.prune_mask_2d(m, sc.n, sc.alpha,
                                            sc.target_sparsity) for m in w])
    else:
        mask = S.prune_mask_2d(w, sc.n, sc.alpha, sc.target_sparsity)
    return dict(params, mask=mask.float())


# ---------------------------------------------------------------------------
# CIMConv2D (NHWC / HWIO) with BN fusion: the paper's CNN building block
# ---------------------------------------------------------------------------


def conv_init(generator: torch.Generator, kh: int, kw: int, cin: int,
              cout: int, cfg: CIMConfig = DENSE,
              dtype: torch.dtype = torch.float32, with_bn: bool = True,
              device: DeviceLike = None) -> Tuple[dict, dict]:
    """An HWIO weight drawn from ``generator`` (on ``device``) at He scale
    sqrt(2 / fan_in); BN's gamma 1, beta 0, mean 0, var 1; in qat mode an
    all-ones mask."""
    dev = resolve_device(device)
    fan_in = kh * kw * cin
    params = {"w": torch.randn((kh, kw, cin, cout), generator=generator,
                               dtype=dtype, device=dev)
              * (2.0 / fan_in) ** 0.5}
    state = {}
    if with_bn:
        f32 = dict(dtype=torch.float32, device=dev)
        params["gamma"] = torch.ones((cout,), **f32)
        params["beta"] = torch.zeros((cout,), **f32)
        state = {"mean": torch.zeros((cout,), **f32),
                 "var": torch.ones((cout,), **f32)}
    if cfg.mode == "qat":
        params["mask"] = torch.ones((kh, kw, cin, cout), dtype=torch.float32,
                                    device=dev)
    return params, state


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME": ceil(size / stride) outputs, the padding split with
    the odd pixel after (a 3x3 stride-2 conv on an even size pads (0, 1))."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
          padding: str = "SAME") -> torch.Tensor:
    """``lax.conv_general_dilated`` with NHWC x and HWIO w, on F.conv2d;
    ``padding`` is "SAME" or "VALID"."""
    kh, kw = w.shape[:2]
    if padding == "SAME":
        (top, bottom), (left, right) = (_same_pads(x.shape[1], kh, stride),
                                        _same_pads(x.shape[2], kw, stride))
    elif padding == "VALID":
        top = bottom = left = right = 0
    else:
        raise ValueError(f'padding must be "SAME" or "VALID", got {padding!r}')
    if top == bottom and left == right:
        conv_pad = (top, left)
    else:  # uneven: pad the NHWC tensor itself, then no conv padding
        x = F.pad(x, (0, 0, left, right, top, bottom))
        conv_pad = (0, 0)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride, padding=conv_pad)
    return y.permute(0, 2, 3, 1)


def _bn_state(state: dict, y: torch.Tensor, momentum: float):
    """The batch's statistics and the EMA state they give (detached)."""
    mean, var = Q.batch_stats(y)
    return mean, var, {
        "mean": Q.ema_update(state["mean"], mean.detach(), momentum),
        "var": Q.ema_update(state["var"], var.detach(), momentum)}


def conv_apply(params: dict, state: dict, x: torch.Tensor,
               cfg: CIMConfig = DENSE, stride: int = 1,
               padding: str = "SAME", train: bool = False
               ) -> Tuple[torch.Tensor, dict]:
    """Forward; returns (y, new_state). In qat mode the BN scale is fused
    into the quantized weight (eq. 7) and the rest of BN is a per-channel
    bias; train mode normalizes by the batch's statistics and moves the
    EMA state."""
    w = params["w"]
    has_bn = "gamma" in params
    if cfg.mode == "dense":
        y = _conv(x, w, stride, padding)
        if has_bn:
            if train:
                mean, var, state = _bn_state(state, y, cfg.bn_momentum)
            else:
                mean, var = state["mean"], state["var"]
            inv = torch.rsqrt(var + cfg.quant.eps)
            y = (y - mean) * inv * params["gamma"] + params["beta"]
        return y, state

    # --- qat: eqs. 5-8 ---
    qc = cfg.quant
    w = _masked(params)
    xq = ops.fake_quant(x.float(), qc.a_bits, qc.a_signed)  # eq. 5
    kh, kw, cin, cout = w.shape
    w_hat = Q.tanh_normalize(w.reshape(kh * kw * cin, cout).float(),
                             qc.group_size)  # eq. 6
    if has_bn and qc.bn_fuse:
        if train:
            # the statistics of the un-fused output: no gradient reaches
            # the weight through them, but one reaches xq
            u = _conv(xq, w_hat.detach().reshape(kh, kw, cin, cout), stride,
                      padding)
            mean, var, state = _bn_state(state, u, cfg.bn_momentum)
        else:
            mean, var = state["mean"], state["var"]
        w_bar = w_hat * (params["gamma"] / torch.sqrt(var + qc.eps))  # eq. 7
        scale = params["gamma"] * torch.rsqrt(var + qc.eps)
        bias = params["beta"] - scale * mean
    else:
        w_bar, bias = w_hat, None
    w_q = _quant_weight(w_bar, qc.w_bits)  # eqs. 7 (clip) and 8
    y = _conv(xq, w_q.reshape(kh, kw, cin, cout), stride, padding)
    if bias is not None:
        y = y + bias
    return y, state


def conv_regularizer(params: dict, cfg: CIMConfig) -> torch.Tensor:
    """Group lasso (eq. 4, per spatial position) + L2 of the master
    weight."""
    sc = cfg.sparsity
    w = params["w"].float()
    total = sc.lambda_g / 2.0 * S.group_lasso_conv(w, sc.n, sc.alpha)
    if sc.lambda_l2 > 0:
        total = total + sc.lambda_l2 / 2.0 * (w * w).sum()
    return total


def conv_prune(params: dict, cfg: CIMConfig) -> dict:
    """A copy of ``params`` with the mask recomputed from the tile norms."""
    sc = cfg.sparsity
    mask = S.prune_mask_conv(params["w"].detach(), sc.n, sc.alpha,
                             sc.target_sparsity)
    return dict(params, mask=mask.float())
