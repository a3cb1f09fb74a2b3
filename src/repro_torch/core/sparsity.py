"""MARS CIM-aware structured sparsity (paper §IV.A-B): tile pruning.

For a 2-D weight (d_in, d_out) the macro's skippable group-set is an
(n x alpha) tile: n input features x alpha output features. Pruning zeroes
the lowest-norm tiles until the target share of tiles is zero.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class SparsityConfig:
    alpha: int = 16  # output filters tied per group-set (BLs on per cycle)
    n: int = 16  # channels sharing one index code (eq. 4)
    lambda_g: float = 1e-4  # group-lasso strength
    lambda_l2: float = 0.0  # non-structured R(w) in eq. 1/2
    target_sparsity: float = 0.95  # pruning threshold selection


def _pad_to_multiple(w: torch.Tensor, axis: int, multiple: int
                     ) -> torch.Tensor:
    """Zero-pad ``axis`` of ``w`` up to a multiple of ``multiple``."""
    pad = (-w.shape[axis]) % multiple
    if pad == 0:
        return w
    pads = [0, 0] * w.dim()
    pads[2 * (w.dim() - 1 - axis) + 1] = pad  # F.pad lists the last axis first
    return F.pad(w, pads)


def tile_view(w2d: torch.Tensor, n: int, alpha: int) -> torch.Tensor:
    """(d_in, d_out) -> (d_in/n, d_out/alpha, n, alpha) tile view (padded)."""
    w2d = _pad_to_multiple(_pad_to_multiple(w2d, 0, n), 1, alpha)
    di, do = w2d.shape
    return w2d.reshape(di // n, n, do // alpha, alpha).permute(0, 2, 1, 3)


def tile_norms(w2d: torch.Tensor, n: int, alpha: int) -> torch.Tensor:
    """L2 norm of every (n x alpha) tile -> (d_in/n, d_out/alpha)."""
    t = tile_view(w2d, n, alpha)
    return torch.sqrt((t * t).sum(dim=(-2, -1)) + 1e-24)


def group_lasso_2d(w2d: torch.Tensor, n: int, alpha: int) -> torch.Tensor:
    """eq. 4 regularizer for a 2-D weight: the sum of its tile L2 norms
    (``n = 1`` is eq. 3). The ``1e-24`` inside each norm's square root
    keeps an all-zero tile's gradient finite."""
    return tile_norms(w2d, n, alpha).sum()


def _quantile_linear(v: torch.Tensor, q: float) -> torch.Tensor:
    """Linear-interpolated quantile of a flat tensor, computed the way
    ``jnp.quantile`` does: sort in the input dtype, interpolate in float32,
    round the result back to the input dtype (``torch.quantile`` refuses
    bfloat16, and interpolating in bfloat16 would move the threshold)."""
    s = torch.sort(v).values
    n = s.numel()
    pos = torch.tensor(q, dtype=torch.float32) * float(n - 1)
    lo = torch.floor(pos)
    hi_w = pos - lo
    lo_w = 1.0 - hi_w
    lo_i = int(min(max(lo.item(), 0), n - 1))
    hi_i = int(min(max(torch.ceil(pos).item(), 0), n - 1))
    out = s[lo_i].float() * lo_w + s[hi_i].float() * hi_w
    return out.to(v.dtype)


def prune_mask_2d(w2d: torch.Tensor, n: int, alpha: int,
                  target_sparsity: float) -> torch.Tensor:
    """Binary mask (same shape as w2d) zeroing the lowest-norm (n x alpha)
    tiles until >= target_sparsity of tiles are zero. ``target_sparsity
    <= 0`` keeps every tile."""
    if target_sparsity <= 0.0:
        return torch.ones_like(w2d)
    norms = tile_norms(w2d, n, alpha)
    keep = norms > _quantile_linear(norms.reshape(-1), target_sparsity)
    mask = keep.repeat_interleave(n, dim=0).repeat_interleave(alpha, dim=1)
    return mask[: w2d.shape[0], : w2d.shape[1]].to(w2d.dtype)
