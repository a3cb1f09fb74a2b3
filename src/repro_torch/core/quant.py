"""MARS quantization (paper §IV.C, eqs. 5-8) on torch tensors.

eq.5  activation:  A_q = round(clamp(A, 0, 1) * (2^bA - 1)) / 2^bA
eq.6  per-group tanh normalization:  W_hat = tanh(W) / max|tanh(W)| (per group)
eq.7  BN fusion:  W_bar = clamp(gamma * W_hat / sqrt(var + eps), -1, 1)
eq.8  symmetric weight quant:  W_q = round(W_bar * (2^{b-1} - 1)) / 2^{b-1}

The quantizers here are the plain forms (no straight-through estimator);
training runs eqs. 5, 7 and 8 on the fake-quant kernel, whose autograd
Function carries the reference's straight-through gradient
(``kernels/fake_quant.py``). ``torch.round`` rounds half to even, as
``jnp.round`` does, and every step stays in the input's dtype. The BN
helpers at the end are differentiable, as the reference's are.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Bit-widths for the MARS quantizer; 32 bits means "leave in float".
    ``group_size`` is G in §IV.C: eq. 6 normalizes per slab of that many
    output columns."""

    w_bits: int = 8
    a_bits: int = 8
    group_size: int = 16
    bn_fuse: bool = True
    a_signed: bool = False  # LM adaptation: SiLU/GELU activations are signed
    eps: float = 1e-5

    @property
    def enabled(self) -> bool:
        return self.w_bits < 32 or self.a_bits < 32


def quantize_activation(a: torch.Tensor, bits: int,
                        signed: bool = False) -> torch.Tensor:
    """eq. 5; ``signed=True`` clamps to [-1, 1] with symmetric levels."""
    if bits >= 32:
        return a
    if signed:
        qmax = 2.0 ** (bits - 1) - 1.0
        return torch.round(a.clamp(-1.0, 1.0) * qmax) / (2.0 ** (bits - 1))
    levels = 2.0 ** bits - 1.0
    return torch.round(a.clamp(0.0, 1.0) * levels) / (2.0 ** bits)


def tanh_normalize(w: torch.Tensor, group_size: int = 0) -> torch.Tensor:
    """eq. 6 over (..., d_in, d_out); groups are slabs of ``group_size``
    output columns, 0 normalizes globally."""
    t = torch.tanh(w)
    d_out = w.shape[-1]
    if group_size <= 0 or d_out % group_size != 0 or d_out == group_size:
        return t / (t.abs().max() + 1e-12)
    lead = tuple(w.shape[:-1])
    tg = t.reshape(lead + (d_out // group_size, group_size))
    dims = tuple(range(len(lead))) + (len(lead) + 1,)
    denom = tg.abs().amax(dim=dims, keepdim=True) + 1e-12
    return (tg / denom).reshape(w.shape)


def fuse_bn_scale(w_hat: torch.Tensor, gamma: Optional[torch.Tensor],
                  var: Optional[torch.Tensor], eps: float = 1e-5
                  ) -> torch.Tensor:
    """eq. 7; None for either statistic skips the fusion."""
    if gamma is None or var is None:
        return w_hat.clamp(-1.0, 1.0)
    return (w_hat * (gamma / torch.sqrt(var + eps))).clamp(-1.0, 1.0)


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: the same values as ``clamp``, and the same gradient as
    the reference's, half the slope on a bound (``torch.clamp`` passes the
    whole slope there), since both frameworks split a tie of min/max
    evenly."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def fold_input_scale(w_hat: torch.Tensor, scale: torch.Tensor
                     ) -> torch.Tensor:
    """An RMSNorm/LayerNorm gain (per input feature) folded into the weight
    the way eq. 7 folds BN, clipped to [-1, 1]."""
    return clip(w_hat * scale[..., :, None], -1.0, 1.0)


def quantize_weight_symmetric(w_bar: torch.Tensor, bits: int) -> torch.Tensor:
    """eq. 8: b=4 -> {-7..7}/8."""
    if bits >= 32:
        return w_bar
    qmax = 2.0 ** (bits - 1) - 1.0
    return torch.round(w_bar * qmax) / (2.0 ** (bits - 1))


def mars_weight_quant(w: torch.Tensor, bits: int, group_size: int = 16,
                      gamma: Optional[torch.Tensor] = None,
                      var: Optional[torch.Tensor] = None,
                      eps: float = 1e-5) -> torch.Tensor:
    """Full MARS weight pipeline: eq.6 -> eq.7 -> eq.8."""
    if bits >= 32 and gamma is None:
        return w
    w_hat = tanh_normalize(w, group_size)
    return quantize_weight_symmetric(fuse_bn_scale(w_hat, gamma, var, eps),
                                     bits)


# ---------------------------------------------------------------------------
# Batch-norm statistics (the EMA that eq. 7 reads in eval mode)
# ---------------------------------------------------------------------------


def ema_update(old: torch.Tensor, batch: torch.Tensor,
               momentum: float = 0.9) -> torch.Tensor:
    return momentum * old + (1.0 - momentum) * batch


def batch_stats(pre_activation: torch.Tensor):
    """Per-channel (last axis) mean and population variance (``jnp.var``'s
    ddof 0, not ``torch.var``'s default) of a conv or linear output."""
    dims = tuple(range(pre_activation.dim() - 1))
    var, mean = torch.var_mean(pre_activation, dim=dims, correction=0)
    return mean, var
