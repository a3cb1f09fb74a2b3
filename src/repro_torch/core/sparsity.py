"""MARS CIM-aware structured sparsity (paper §IV.A-B, eqs. 1-4): the
group lasso, tile pruning and the statistics the paper reports.

For a 2-D weight (d_in, d_out) the macro's skippable group-set is an
(n x alpha) tile: n input features x alpha output features. A conv weight
is HWIO; its groups are (n channels x alpha filters) at each spatial
position. Pruning zeroes the lowest-norm tiles until the target share of
tiles is zero.
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


def _position_tile_norms(w_hwio: torch.Tensor, n: int, alpha: int
                         ) -> torch.Tensor:
    """(H, W, I, O) -> the tile norms of each spatial position,
    (H W, I/n, O/alpha)."""
    h, w, i, o = w_hwio.shape
    flat = _pad_to_multiple(_pad_to_multiple(w_hwio.reshape(h * w, i, o), 1,
                                             n), 2, alpha)
    t = flat.reshape(h * w, flat.shape[1] // n, n, flat.shape[2] // alpha,
                     alpha)
    return torch.sqrt((t * t).sum(dim=(2, 4)) + 1e-24)


def group_lasso_conv(w_hwio: torch.Tensor, n: int, alpha: int
                     ) -> torch.Tensor:
    """eq. 4 for a conv weight (H, W, I, O): the sum of the L2 norms of its
    (n channels x alpha filters) groups at every spatial position."""
    return _position_tile_norms(w_hwio, n, alpha).sum()


def tensor_leaves(tree) -> list:
    """The tensors of nested dicts, lists and tuples, in the reference's
    leaf order (sorted dict keys); anything else (None, a Python int) is
    skipped."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tensor_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensor_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def regularization(params_tree, cfg: SparsityConfig) -> torch.Tensor:
    """The E(w) terms of eq. 2 over a tree of CIM weights: every floating
    leaf of 2 dims is a linear (d_in, d_out), of 3 a layer stack of them,
    of 4 a conv HWIO; other leaves take only the L2 term."""
    total = torch.zeros(())
    for leaf in tensor_leaves(params_tree):
        if not leaf.is_floating_point():
            continue
        lf = leaf.float()
        total = total.to(lf.device)
        if lf.dim() == 2:
            total = total + cfg.lambda_g / 2.0 * group_lasso_2d(
                lf, cfg.n, cfg.alpha)
        elif lf.dim() == 4:
            total = total + cfg.lambda_g / 2.0 * group_lasso_conv(
                lf, cfg.n, cfg.alpha)
        elif lf.dim() == 3:
            total = total + cfg.lambda_g / 2.0 * sum(
                group_lasso_2d(m, cfg.n, cfg.alpha) for m in lf)
        if cfg.lambda_l2 > 0.0:
            total = total + cfg.lambda_l2 / 2.0 * (lf * lf).sum()
    return total


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


def prune_mask_conv(w_hwio: torch.Tensor, n: int, alpha: int,
                    target_sparsity: float) -> torch.Tensor:
    """Conv version of :func:`prune_mask_2d`: one threshold over the tile
    norms of every spatial position."""
    if target_sparsity <= 0.0:
        return torch.ones_like(w_hwio)
    h, w, i, o = w_hwio.shape
    norms = _position_tile_norms(w_hwio, n, alpha)
    keep = norms > _quantile_linear(norms.reshape(-1), target_sparsity)
    mask = keep.repeat_interleave(n, dim=1).repeat_interleave(alpha, dim=2)
    return mask[:, :i, :o].reshape(h, w, i, o).to(w_hwio.dtype)


# ---------------------------------------------------------------------------
# Statistics the paper reports
# ---------------------------------------------------------------------------


def sparsity_ratio(mask: torch.Tensor) -> torch.Tensor:
    """Fraction of zero weights."""
    return 1.0 - mask.float().mean()


def _alive_groupsets(mask2d: torch.Tensor, group: int, alpha: int
                     ) -> torch.Tensor:
    return (tile_view(mask2d, group, alpha) > 0).any(dim=-1).any(dim=-1)


def zero_groupset_proportion(mask2d: torch.Tensor, group: int, alpha: int
                             ) -> torch.Tensor:
    """Fraction of (group x alpha) group-sets that are entirely zero: the
    rows the CIM macro never stores or computes."""
    return 1.0 - _alive_groupsets(mask2d, group, alpha).float().mean()


def compression_rate(sparsity: float, w_bits: int) -> float:
    """The paper's Table II metric: (32 / w_bits) / (1 - sparsity)."""
    return (32.0 / float(w_bits)) / max(1.0 - float(sparsity), 1e-9)


def index_storage_bits(mask2d: torch.Tensor, group: int, alpha: int
                       ) -> torch.Tensor:
    """A 16-bit index code per surviving group-set (Fig. 6 / Table IV)."""
    return _alive_groupsets(mask2d, group, alpha).sum(dtype=torch.int32) * 16


def weight_storage_bits(mask2d: torch.Tensor, group: int, alpha: int,
                        w_bits: int) -> torch.Tensor:
    """Bits to store the surviving group-sets (whole tiles are kept)."""
    alive = _alive_groupsets(mask2d, group, alpha).sum(dtype=torch.int32)
    return alive * group * alpha * w_bits


def apply_mask(params_tree, mask_tree):
    """Elementwise product over two trees of one structure (nested dicts,
    lists, tuples); a mask of None passes its parameter through."""
    if mask_tree is None:
        return params_tree
    if isinstance(params_tree, dict):
        return {k: apply_mask(v, mask_tree[k]) for k, v in params_tree.items()}
    if isinstance(params_tree, (list, tuple)):
        return type(params_tree)(apply_mask(p, m)
                                 for p, m in zip(params_tree, mask_tree))
    return params_tree * mask_tree.to(params_tree.dtype)
