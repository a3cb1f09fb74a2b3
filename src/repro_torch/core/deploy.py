"""Deployment: master weights -> CIM-packed serving weights.

Every CIM-mapped projection is pruned at the tile granularity, quantized to
int levels (eqs. 6-8) and packed for the block-sparse kernel;
``deployed_matmul`` is the serving replacement for a dense ``x @ w``.

Uniform envelope: :func:`stack_deployed` folds L per-layer packings of one
projection into one :class:`StackedWeight` whose slot axis is padded to the
largest ``nnz_max`` with zero blocks AND zero scales, while the per-layer
``nnz``/``row_idx`` stay exact. ``stacked_matmul`` serves any layer of the
stack through the same layer-indexed kernel, with the layer id on the card.

Macro sharding (:func:`shard_weight`): a projection's block columns are
laid over the macros of a serving mesh (``launch.shardings.MacroMesh``),
balanced by surviving-block count (``sched.allocate.device_assignment``,
the scheduler's LPT policy). Only placement changes: each macro runs the
same kernel on its own columns, the outputs are gathered and un-permuted
by ``col_inv``, and the result is the unsharded one bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..kernels import ops
from ..kernels.cim_bsr_matmul import MACRO_AXIS
from . import quant as Q
from . import sparsity as S
from .cim_layer import CIMConfig

if TYPE_CHECKING:
    from ..launch.shardings import MacroMesh

_ARRAYS = ("blocks", "scales", "row_idx", "nnz")


def _macro_shards(arrays: Sequence[torch.Tensor], mesh: "MacroMesh",
                  dim: int) -> tuple:
    """Macro d's (blocks, scales, row_idx, nnz): its run of go / n block
    columns along ``dim`` of the macro-order ``arrays``, contiguous on its
    device (a view where that is a view already)."""
    go = int(arrays[0].shape[dim])
    if go % mesh.size:
        raise ValueError(f"{go} block columns do not split evenly over "
                         f"{mesh.size} macros")
    g = go // mesh.size
    return tuple(tuple(a.narrow(dim, d * g, g).to(dev).contiguous()
                       for a in arrays)
                 for d, dev in enumerate(mesh.devices))


@dataclasses.dataclass
class DeployedWeight:
    """One projection packed for the kernel: one packed dict per layer of a
    stacked master weight (``blocks``, ``scales``, ``row_idx``, ``nnz``
    tensors and a ``density`` float).

    ``mesh`` is None for single-device serving. After :func:`shard_weight`
    it is the serving mesh: each packed dict's block columns are then in
    macro order (equal-cardinality shards, on the mesh's first device), and
    the dict also holds ``col_inv``, the index that restores the logical
    column order after the sharded kernel's gather, and ``shards``, macro
    d's (blocks, scales, row_idx, nnz) on its device."""

    packed: List[dict]
    d_in: int
    d_out: int
    bits: int
    mesh: Optional["MacroMesh"] = None

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
    """L layers of one projection in one uniform packing envelope.

    Stacked from macro-sharded layers, it carries their ``mesh`` and
    ``col_inv`` ((L, go): each layer keeps its own column placement), and
    ``shards``: macro d's (L, go / n, ...) arrays, contiguous on its device,
    which the layer-indexed kernel needs (a slice of the go axis of the
    macro-order stack is not)."""

    blocks: torch.Tensor   # (L, go, nnz_max, bk, bn) int8
    scales: torch.Tensor   # (L, go, nnz_max) f32 (0 in padding slots)
    row_idx: torch.Tensor  # (L, go, nnz_max) int32
    nnz: torch.Tensor      # (L, go) int32 true per-layer slot counts
    d_in: int
    d_out: int
    bits: int
    col_inv: Optional[torch.Tensor] = None  # (L, go) int32 when sharded
    mesh: Optional["MacroMesh"] = None
    shards: tuple = dataclasses.field(default=(), init=False, repr=False)

    def __post_init__(self):
        if self.mesh is not None:
            self.shards = _macro_shards(
                [getattr(self, k) for k in _ARRAYS], self.mesh, 1)

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
        if self.mesh is not None:
            p["col_inv"] = self.col_inv[i].clone()
            p["shards"] = tuple(tuple(a[i] for a in s) for s in self.shards)
        return DeployedWeight([p], self.d_in, self.d_out, self.bits,
                              mesh=self.mesh)


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
    padded up to the largest with zero blocks and zero scales. Placement is
    kept: macro-sharded inputs, all on one mesh, stack into a sharded
    envelope with their per-layer ``col_inv``."""
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
        if dw.mesh != ref.mesh:
            raise ValueError("stack_deployed: mixed meshes across layers")
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
    col_inv = (torch.stack([p["col_inv"] for p in packed])
               if ref.mesh is not None else None)
    return StackedWeight(blocks, scales, row_idx, nnz, ref.d_in, ref.d_out,
                         ref.bits, col_inv=col_inv, mesh=ref.mesh)


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


def shardable_columns(dw: DeployedWeight, n_devices: int) -> bool:
    """True when every layer's block-column count splits evenly over
    ``n_devices``: the precondition for equal-shaped macro shards."""
    return all(int(p["blocks"].shape[0]) % n_devices == 0
               for p in dw.packed)


def deployed_weight_specs() -> Dict[str, tuple]:
    """The layout contract :func:`shard_weight` applies to a packed dict,
    as the reference's PartitionSpecs (tuples here): the block-column axis
    over the macros, the un-permute index replicated."""
    return {
        "blocks": (MACRO_AXIS, None, None, None),
        "scales": (MACRO_AXIS, None),
        "row_idx": (MACRO_AXIS, None),
        "nnz": (MACRO_AXIS,),
        "col_inv": (),
        "density": (),
    }


def shard_weight(dw: DeployedWeight, mesh: "MacroMesh",
                 assign: Optional[Callable] = None) -> DeployedWeight:
    """Column-shard a packed projection over the serving macros.

    ``assign(nnz_counts, n_devices) -> (go,) macro ids`` chooses which
    block columns live on which macro (``sched.allocate.device_assignment``
    is the LPT policy; None = contiguous runs). Each packed dict's arrays
    are permuted into macro order on the column axis, on the mesh's first
    device, with ``col_inv`` (int32) to restore the logical order after the
    gather, and each macro's shard is laid on its device. A projection
    whose columns do not split evenly is returned unchanged (served
    replicated): sharding never changes which weights exist, only where
    they live."""
    n_dev = mesh.size
    if dw.mesh is not None or n_dev <= 1 or not shardable_columns(dw, n_dev):
        return dw
    packed = []
    for p in dw.packed:
        counts = p["nnz"].cpu().numpy()
        go = counts.shape[0]
        dev = (np.repeat(np.arange(n_dev), go // n_dev) if assign is None
               else np.asarray(assign(counts, n_dev)))
        if (np.bincount(dev, minlength=n_dev) != go // n_dev).any():
            raise ValueError(f"assign must give each of {n_dev} macros "
                             f"{go // n_dev} of the {go} columns")
        perm = np.concatenate([np.flatnonzero(dev == d)
                               for d in range(n_dev)])
        idx = torch.from_numpy(perm).to(p["blocks"].device)
        q = {k: p[k].index_select(0, idx).to(mesh.device) for k in _ARRAYS}
        q["col_inv"] = torch.from_numpy(
            np.argsort(perm).astype(np.int32)).to(mesh.device)
        q["density"] = p["density"]
        q["shards"] = _macro_shards([q[k] for k in _ARRAYS], mesh, 0)
        packed.append(q)
    return DeployedWeight(packed, dw.d_in, dw.d_out, dw.bits, mesh=mesh)


def unshard_weight(dw: DeployedWeight) -> DeployedWeight:
    """Undo :func:`shard_weight`: the logical column order (by ``col_inv``)
    and no placement, on the mesh's first device. This is the
    serialization form: artifacts store placement-free packings, sharded
    again at boot onto whatever mesh the serving host has."""
    if dw.mesh is None:
        return dw
    packed = []
    for p in dw.packed:
        inv = p["col_inv"].long()
        packed.append({**{k: p[k].index_select(0, inv) for k in _ARRAYS},
                       "density": p["density"]})
    return DeployedWeight(packed, dw.d_in, dw.d_out, dw.bits)


def _unpermute(y: torch.Tensor, col_inv: torch.Tensor) -> torch.Tensor:
    """(M, go * bn) columns in macro order -> logical order, a block
    column at a time."""
    m, go = y.shape[0], int(col_inv.shape[-1])
    return y.view(m, go, -1).index_select(1, col_inv).view(m, -1)


def bm_for_rows(rows: int) -> int:
    """The reference's kernel row tile for an activation row count: the
    next power of two in [8, 128], a fixed ladder so that changing batch
    sizes map to few compiled kernels. The port's kernel picks its own tile
    height from M (``cim_bsr_matmul.plan``) and takes no ``bm``; this
    ladder stays for the autotuner's signature and for static-shape
    bucketing."""
    b = 8
    while b < rows and b < 128:
        b *= 2
    return b


def deployed_matmul(x: torch.Tensor, dw: DeployedWeight, layer: int = 0,
                    a_bits: int = 0) -> torch.Tensor:
    """Serving-path matmul: eq.5 activation quant (the fake-quant kernel) +
    the BSR kernel.

    With ``a_bits`` the activations are quantized in float32 and ``x`` is
    rebound to them, so the result is float32 even for a bf16 model (the
    reference does the same, and the residual stream widens with it)."""
    if a_bits:
        x = ops.fake_quant(x, a_bits, signed=True,
                           out_dtype=torch.float32)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, dw.d_in).contiguous()
    p = dw.packed[layer]
    if dw.mesh is not None:  # one launch a macro, gathered, un-permuted
        y = _unpermute(ops.bsr_matmul_sharded(x2, p), p["col_inv"])
    else:
        y = ops.bsr_matmul(x2, p)
    return y.reshape(*lead, dw.d_out).to(x.dtype)


def stacked_matmul(x: torch.Tensor, sw: StackedWeight, layer,
                   a_bits: int = 0) -> torch.Tensor:
    """Serving-path matmul against layer ``layer`` of a uniform envelope;
    bit-identical to ``deployed_matmul`` on that layer's own packing."""
    if a_bits:
        x = ops.fake_quant(x, a_bits, signed=True,
                           out_dtype=torch.float32)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, sw.d_in).contiguous()
    if sw.mesh is not None:
        # the layer's un-permute index read on the device by its layer id
        inv = (sw.col_inv.index_select(0, layer).reshape(-1)
               if torch.is_tensor(layer) else sw.col_inv[int(layer)])
        y = _unpermute(ops.bsr_matmul_stacked_sharded(x2, sw.shards, layer),
                       inv)
    else:
        y = ops.bsr_matmul_stacked(x2, sw.blocks, sw.scales, sw.row_idx,
                                   sw.nnz, layer)
    return y.reshape(*lead, sw.d_out).to(x.dtype)


def reference_matmul(x: torch.Tensor, w: torch.Tensor, cim: CIMConfig,
                     target_sparsity: Optional[float] = None,
                     bk: int = 128, bn: int = 128) -> torch.Tensor:
    """Dense oracle for ``deployed_matmul``: the same mask, weight quant and
    eq. 5 activation quant, then a plain f32 product."""
    ts = (cim.sparsity.target_sparsity if target_sparsity is None
          else target_sparsity)
    mask = S.prune_mask_2d(w, bk, bn, ts)
    wq = Q.mars_weight_quant(w * mask, cim.quant.w_bits, cim.quant.group_size)
    xq = Q.quantize_activation(x.float(), cim.quant.a_bits, signed=True)
    return (xq @ wq.float()).to(x.dtype)


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
