"""Deployment: master weights -> CIM-packed serving weights.

Every CIM-mapped projection is pruned at the tile granularity, quantized to
int levels (eqs. 6-8) and packed for the block-sparse kernel;
``deployed_matmul`` is the serving replacement for a dense ``x @ w``.

Uniform envelope: :func:`stack_deployed` folds L per-layer packings of one
projection into one :class:`StackedWeight` whose slot axis is padded to the
largest ``nnz_max`` with zero blocks AND zero scales, while the per-layer
``nnz``/``row_idx`` stay exact. ``stacked_matmul`` serves any layer of the
stack through the same layer-indexed kernel, with the layer id on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..kernels import ops
from . import quant as Q
from . import sparsity as S
from .cim_layer import CIMConfig


@dataclasses.dataclass
class DeployedWeight:
    """One projection packed for the kernel: one packed dict per layer of a
    stacked master weight (``blocks``, ``scales``, ``row_idx``, ``nnz``
    tensors and a ``density`` float)."""

    packed: List[dict]
    d_in: int
    d_out: int
    bits: int

    @property
    def density(self) -> float:
        return float(np.mean([p["density"] for p in self.packed]))

    @property
    def tile(self) -> tuple:
        """(bk, bn) block shape the projection was packed with."""
        b = self.packed[0]["blocks"]
        return (int(b.shape[2]), int(b.shape[3]))


@dataclasses.dataclass
class StackedWeight:
    """L layers of one projection in one uniform packing envelope."""

    blocks: torch.Tensor   # (L, go, nnz_max, bk, bn) int8
    scales: torch.Tensor   # (L, go, nnz_max) f32 (0 in padding slots)
    row_idx: torch.Tensor  # (L, go, nnz_max) int32
    nnz: torch.Tensor      # (L, go) int32 true per-layer slot counts
    d_in: int
    d_out: int
    bits: int

    @property
    def n_layers(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def tile(self) -> tuple:
        return (int(self.blocks.shape[3]), int(self.blocks.shape[4]))

    @property
    def density(self) -> float:
        total = (self.d_in // self.tile[0]) * (self.d_out // self.tile[1])
        return float(self.nnz.sum().item()) / max(total * self.n_layers, 1)

    def layer(self, i: int) -> DeployedWeight:
        """Layer ``i`` as a standalone single-layer DeployedWeight."""
        p = {k: getattr(self, k)[i].clone()
             for k in ("blocks", "scales", "row_idx", "nnz")}
        gi = self.d_in // self.tile[0]
        p["density"] = float(p["nnz"].sum().item()) / max(
            gi * int(self.nnz.shape[1]), 1)
        return DeployedWeight([p], self.d_in, self.d_out, self.bits)


class StackedLayerView:
    """One layer of a :class:`StackedWeight`; ``layer`` is a (1,) int32
    device tensor (a slice of the stack's layer ids), so selecting the layer
    never syncs with the host. ``layers.cim_matmul`` dispatches it to
    :func:`stacked_matmul`."""

    __slots__ = ("sw", "layer")

    def __init__(self, sw: StackedWeight, layer):
        self.sw = sw
        self.layer = layer


def stack_deployed(dws: Sequence[DeployedWeight]) -> StackedWeight:
    """Stack per-layer packings of ONE projection into a uniform envelope.
    Every entry must share (d_in, d_out, bits, go, bk, bn); ``nnz_max`` is
    padded up to the largest with zero blocks and zero scales."""
    if isinstance(dws, DeployedWeight):
        dws = [dws]
    dws = list(dws)
    if not dws:
        raise ValueError("stack_deployed needs at least one DeployedWeight")
    ref = dws[0]
    for dw in dws[1:]:
        if (dw.d_in, dw.d_out, dw.bits) != (ref.d_in, ref.d_out, ref.bits):
            raise ValueError(
                "stack_deployed: mixed projection geometry "
                f"{(dw.d_in, dw.d_out, dw.bits)} vs "
                f"{(ref.d_in, ref.d_out, ref.bits)}")
    packed = [p for dw in dws for p in dw.packed]
    shapes = {tuple(p["blocks"].shape[i] for i in (0, 2, 3)) for p in packed}
    if len(shapes) != 1:
        raise ValueError(
            f"stack_deployed: non-uniform (go, bk, bn) across layers "
            f"{sorted(shapes)} - repack with compress(uniform=True)")
    go, bk, bn = shapes.pop()
    nmax = max(int(p["row_idx"].shape[1]) for p in packed)
    n_l = len(packed)
    dev = packed[0]["blocks"].device
    blocks = torch.zeros((n_l, go, nmax, bk, bn), dtype=torch.int8,
                         device=dev)
    scales = torch.zeros((n_l, go, nmax), dtype=torch.float32, device=dev)
    row_idx = torch.zeros((n_l, go, nmax), dtype=torch.int32, device=dev)
    for i, p in enumerate(packed):
        w = p["row_idx"].shape[1]
        blocks[i, :, :w] = p["blocks"]
        scales[i, :, :w] = p["scales"]
        row_idx[i, :, :w] = p["row_idx"]
    nnz = torch.stack([p["nnz"] for p in packed])
    return StackedWeight(blocks, scales, row_idx, nnz, ref.d_in, ref.d_out,
                         ref.bits)


def fit_tile(d_in: int, d_out: int, bk: int, bn: int) -> tuple:
    """Largest (bk, bn) at most the requested tile that exactly divides
    (d_in, d_out) - ``pack_bsr`` requires exact tiling."""
    return (_largest_divisor(d_in, bk), _largest_divisor(d_out, bn))


def _largest_divisor(n: int, at_most: int) -> int:
    for d in range(min(at_most, n), 0, -1):
        if n % d == 0:
            return d
    return 1


def uniform_fit_tile(shapes: Sequence[tuple], bk: int, bn: int) -> tuple:
    """One (bk, bn) for a whole network: the largest tile at most the
    requested one that exactly divides EVERY (d_in, d_out) in ``shapes``."""
    if not shapes:
        return (bk, bn)
    gk = gn = 0
    for d_in, d_out in shapes:
        gk = int(np.gcd(gk, int(d_in)))
        gn = int(np.gcd(gn, int(d_out)))
    return (_largest_divisor(gk, bk), _largest_divisor(gn, bn))


def deploy_weight(w: torch.Tensor, cim: CIMConfig, bk: int = 128,
                  bn: int = 128, target_sparsity: Optional[float] = None
                  ) -> DeployedWeight:
    """Prune + quantize + pack a (d_in, d_out) or stacked (L, d_in, d_out)
    master weight. Pruning and quantization run in the master weight's own
    dtype on its device; only the level rounding goes to float64."""
    stacked = w if w.dim() == 3 else w[None]
    bits = cim.quant.w_bits
    ts = (cim.sparsity.target_sparsity if target_sparsity is None
          else target_sparsity)
    packed = []
    for wl in stacked:
        mask = S.prune_mask_2d(wl, bk, bn, ts)
        wq = Q.mars_weight_quant(wl * mask, bits, cim.quant.group_size)
        packed.append(ops.pack_for_kernel(wq, bits=bits, bk=bk, bn=bn))
    return DeployedWeight(packed, int(stacked.shape[-2]),
                          int(stacked.shape[-1]), bits)


def deployed_matmul(x: torch.Tensor, dw: DeployedWeight, layer: int = 0,
                    a_bits: int = 0) -> torch.Tensor:
    """Serving-path matmul: eq.5 activation quant (the fake-quant kernel) +
    the BSR kernel.

    With ``a_bits`` the activations are quantized in float32 and ``x`` is
    rebound to them, so the result is float32 even for a bf16 model (the
    reference does the same, and the residual stream widens with it)."""
    if a_bits:
        x = ops.fake_quant(x.float(), a_bits, signed=True)
    lead = x.shape[:-1]
    y = ops.bsr_matmul(x.reshape(-1, dw.d_in).contiguous(), dw.packed[layer])
    return y.reshape(*lead, dw.d_out).to(x.dtype)


def stacked_matmul(x: torch.Tensor, sw: StackedWeight, layer,
                   a_bits: int = 0) -> torch.Tensor:
    """Serving-path matmul against layer ``layer`` of a uniform envelope;
    bit-identical to ``deployed_matmul`` on that layer's own packing."""
    if a_bits:
        x = ops.fake_quant(x.float(), a_bits, signed=True)
    lead = x.shape[:-1]
    y = ops.bsr_matmul_stacked(x.reshape(-1, sw.d_in).contiguous(),
                               sw.blocks, sw.scales, sw.row_idx, sw.nnz,
                               layer)
    return y.reshape(*lead, sw.d_out).to(x.dtype)


def deployment_report(deployed: Dict[str, DeployedWeight]) -> dict:
    """Storage accounting across all deployed projections (Table IV-style)."""
    total_dense_bits = total_weight_bits = total_index_bits = 0
    for dw in deployed.values():
        for p in dw.packed:
            nnz_blocks = int(p["nnz"].sum().item())
            bk, bn = p["blocks"].shape[2], p["blocks"].shape[3]
            total_weight_bits += nnz_blocks * bk * bn * dw.bits
            total_index_bits += nnz_blocks * 32  # int32 row index per block
        total_dense_bits += dw.d_in * dw.d_out * len(dw.packed) * 32
    return {
        "dense_Mb": total_dense_bits / 2**20,
        "weight_Mb": total_weight_bits / 2**20,
        "index_Kb": total_index_bits / 2**10,
        "compression_x": total_dense_bits / max(total_weight_bits
                                                + total_index_bits, 1),
    }
