"""Multi-pod dry run and roofline terms: the reference's sizing sweep over
the production meshes, with no card.

For every (architecture x input shape) cell and mesh it runs the cell's
train, prefill or decode step once as a DTensor program on torch's fake
process group (``launch.mesh.make_production_mesh``: 256 or 512 ranks,
this process rank 0) over the meta device, torch's counterpart of the
reference's 512 fake host devices and GSPMD:

  1. every parameter, optimizer moment (ZeRO-1, ``zero1_specs``), batch and
     cache leaf is a DTensor with the ported specs' placements
     (``launch.shardings``), and the outputs are redistributed to the
     reference's out specs at the end. A cell PASSes when DTensor
     propagates a sharding through every op; a FAIL names the op it could
     not (or the error of the step);
  2. the same step at one and two pattern periods of depth gives per-layer
     FLOPs, bytes and collective bytes, extrapolated to the full depth as
     the reference's ``cost_terms`` does, with its clamp;
  3. roofline terms against an H100 SXM5 80GB at 700 W, data-sheet peaks:
     989e12 dense bf16 FLOP/s, 3.35e12 B/s of HBM3, and one link rate of
     50e9 B/s (400 Gb/s NDR, one NIC a card) for every collective: each
     axis of the production meshes spans more than one node of 8 cards,
     so a ring over it crosses the network.

What is counted, on rank 0's local shards. A dispatch mode sees each aten
op that DTensor runs on the local tensors (it lets DTensor desugar an op
first, as torch's ``CommDebugMode`` does):

* FLOPs: torch's flop formulas (``torch.utils.flop_counter``) on the
  local shapes, so an op that the sharding leaves replicated counts on
  every device, as XLA's per-device cost analysis counts it;
* bytes: the operand and result bytes of each local op (view ops
  excluded). No fusion: every intermediate is written and read back, so
  this is an upper bound where XLA fuses;
* collectives: each c10d functional collective's result bytes times the
  reference's wire factor for its kind (all-reduce 2, the others 1), and
  the counts by kind;
* memory: ``argument_bytes_per_dev`` and ``output_bytes_per_dev`` are the
  local shards' bytes of the step's inputs and outputs;
  ``temp_bytes_per_dev`` is the peak of the live bytes the step allocates
  (each non-aliasing op result from its creation until its tensor dies,
  what autograd saves included); ``peak_bytes_per_dev`` is argument +
  temp. Unlike XLA's ``memory_analysis`` there is no fusion and no buffer
  reuse beyond those lifetimes (the caching allocator's reuse is not
  modelled), and the optimizer updates the state in place, where the
  reference donates it.

``compile_s`` is the seconds of the full-depth traced step. The kernel
wrappers take their plain versions on the meta device, so the program is
the port's own model code, shape only. Where DTensor lays out an op
otherwise than GSPMD would, the dry run adds a rule (``dryrun_rules``): a
depthwise conv sharded by channel, a view that splits heads out of a dim
sharded over more devices than heads, a gather over a sharded dim reduced
at once, an attention einsum's batched product sharded by heads, and
Megatron-SP for ``--opt``'s ``seq_shard_residual`` stream (the sequence
gathered before a column-parallel product, the head's included, which so
computes vocabulary-sharded, and the gradient reduce-scattered back; K and
V moved from the sequence to the heads for the attention einsum). The
model code holds no DTensor branch.

Needs torch 2.13 or later (``REQUIRED_TORCH``): older DTensor refuses to
flatten a sharded dim (no strided shard), so most cells would fail on
torch's layout rules, not the model's; the CLI refuses to run there.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
  python -m repro_torch.launch.dryrun --all --multi-pod both --out r.json
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import json
import math
import sys
import time
import weakref
from typing import Optional

import torch

from ..models import registry
from ..models.config import SHAPES, ModelConfig, ShapeConfig
from ..train import optimizer as optim
from ..train.trainer import TrainConfig, make_train_step
from . import shardings as SH
from .mesh import make_production_mesh

# H100 SXM5 80GB at 700 W, data-sheet peaks
PEAK_FLOPS = 989e12  # dense bf16 FLOP/s a card
HBM_BW = 3.35e12  # B/s a card
LINK_BW = 50e9  # B/s a card: one 400 Gb/s NDR NIC

# wire-volume factor per collective kind (ring algorithms, asymptotic)
_WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}
# c10d functional collectives (either namespace) -> the reference's kinds
_COLLECTIVES = {"all_reduce": "all-reduce", "all_reduce_coalesced":
                "all-reduce", "all_gather_into_tensor": "all-gather",
                "all_gather_into_tensor_coalesced": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "reduce_scatter_tensor_coalesced": "reduce-scatter",
                "all_to_all_single": "all-to-all"}

# the torch the dry run is verified with, and the DTensor internals it
# patches or calls (module, attribute); ``check_torch`` holds both
REQUIRED_TORCH = (2, 13)
_INTERNALS = (
    ("torch.distributed.tensor._sharding_prop", "ShardingPropagator",
     "_propagate_tensor_meta_non_cached"),
    ("torch.distributed.tensor._ops.utils", "redistribute_cost"),
    ("torch.distributed.tensor._redistribute", "_gen_transform_infos"),
    ("torch.distributed.tensor._redistribute", "get_redistribute_planner"),
    ("torch.distributed.tensor._collective_utils", "redistribute_cost"),
    ("torch.distributed.tensor", "DTensor", "_op_dispatcher",
     "_custom_op_handlers"),
    ("torch.distributed.tensor._utils",
     "compute_local_shape_and_global_offset"),
    ("torch.distributed.tensor.placement_types", "_StridedShard"),
)


def check_torch() -> None:
    """Raises RuntimeError unless torch is REQUIRED_TORCH or later and has
    every DTensor internal the dry run patches or calls."""
    import importlib
    import re
    found = tuple(int(v) for v in re.match(
        r"(\d+)\.(\d+)", torch.__version__).groups())
    if found < REQUIRED_TORCH:
        raise RuntimeError(
            f"the dry run needs torch >= {'.'.join(map(str, REQUIRED_TORCH))}"
            f" (found {torch.__version__}): older DTensor cannot flatten a "
            "sharded dim, so the cells would fail on its layout rules")
    missing = []
    for mod, *attrs in _INTERNALS:
        obj = importlib.import_module(mod)
        for a in attrs:
            if not hasattr(obj, a):
                missing.append(f"{mod}.{'.'.join(attrs)}")
                break
            obj = getattr(obj, a)
    if missing:
        raise RuntimeError(f"torch {torch.__version__} lacks the DTensor "
                           f"internals the dry run uses: {missing}")


OPT_OVERRIDES = dict(attn_chunk=1024, head_pad=16, moe_group_size=128,
                     capacity_factor=1.0, ssm_chunk=128, ssd_lowp=True,
                     ssm_split_proj=True, vocab_pad_multiple=256)


# ---------------------------------------------------------------------------
# Inputs and model FLOPs (shapes only)
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The cell's batch as meta tensors (the reference's
    ``ShapeDtypeStruct`` stand-ins)."""
    b, s = shape.global_batch, shape.seq_len
    meta = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")
    if shape.kind == "decode":
        return {"tokens": meta((b, 1), torch.int32)}
    s_text = s - cfg.n_patches if cfg.family == "vlm" else s
    batch = {"tokens": meta((b, s_text), torch.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = meta((b, cfg.n_patches, cfg.d_model),
                                     torch.bfloat16)
    if cfg.family == "encdec":
        batch["frames"] = meta((b, cfg.enc_seq, cfg.d_model), torch.bfloat16)
    return batch


def _params_shape(cfg: ModelConfig) -> dict:
    """The parameters on the meta device (shapes and types, no values)."""
    return registry.model_fns(cfg).init_params(cfg, None, "meta")


def _named_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], path + (k,))
    else:
        yield path, tree


def active_param_count(cfg: ModelConfig) -> float:
    """N (active) for MODEL_FLOPS = 6 N D / 2 N D: embedding tables and
    vectors excluded, the moe expert weights scaled by top_k / n_experts."""
    total = 0.0
    for path, leaf in _named_leaves(_params_shape(cfg)):
        name = path[-1] if path else ""
        if name in ("embed", "pos_dec") or leaf.dim() < 2:
            continue
        n = float(math.prod(leaf.shape))
        if cfg.family == "moe" and name in ("w_gate", "w_up", "w_down"):
            n *= cfg.top_k / cfg.n_experts
        total += n
    return total


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    n = active_param_count(cfg)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token a sequence


# ---------------------------------------------------------------------------
# The counting mode
# ---------------------------------------------------------------------------


def _tensors(tree):
    if isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the local aten ops of a DTensor program (module docstring):
    ``flops``, ``bytes``, collective bytes and counts by kind, and the
    peak of live allocated bytes. ``recent`` holds the last ops DTensor
    was asked to run, the last first (the ops a failing cell names)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.coll = {k: 0.0 for k in _WIRE_FACTOR}
        self.coll_counts = {k: 0 for k in _WIRE_FACTOR}
        self.live = 0
        self.peak = 0
        self.recent = collections.deque(maxlen=3)
        self.paused = False  # DTensor's own shape inference is running

    def _free(self, n: int) -> None:
        self.live -= n

    @contextlib.contextmanager
    def ignoring_shape_inference(self):
        """DTensor infers an op's output shape the first time it sees its
        input specs by running it on fake global-shape tensors; those runs
        are not the program's, so the counter pauses for them."""
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        real = ShardingPropagator._propagate_tensor_meta_non_cached
        counter = self

        def paused(prop, op_schema):
            counter.paused = True
            try:
                return real(prop, op_schema)
            finally:
                counter.paused = False

        ShardingPropagator._propagate_tensor_meta_non_cached = paused
        try:
            yield
        finally:
            ShardingPropagator._propagate_tensor_meta_non_cached = real

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if self.paused or isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            self.recent.appendleft(str(func))
            return NotImplemented  # DTensor desugars it into local ops
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in self._flop_registry:
            self.flops += float(self._flop_registry[packet](
                *args, **kwargs, out_val=out))
        name = packet.__name__
        kind = _COLLECTIVES.get(name) if func.namespace in (
            "_c10d_functional", "c10d_functional") else None
        if kind is not None:
            self.coll[kind] += sum(_nbytes(t) for t in _tensors(out)
                                   ) * _WIRE_FACTOR[kind]
            self.coll_counts[kind] += 1
        elif not func.is_view:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in _tensors(out))
        aliased = any(r.alias_info is not None for r in func._schema.returns)
        if not aliased:
            for t in _tensors(out):
                n = t.untyped_storage().nbytes()
                self.live += n
                weakref.finalize(t, self._free, n)
            self.peak = max(self.peak, self.live)
        return out


# ---------------------------------------------------------------------------
# Steps over DTensors
# ---------------------------------------------------------------------------


def _distribute(t: torch.Tensor, mesh, spec, requires_grad=False):
    """``t`` (meta) as a DTensor of ``spec``'s placements: rank 0's local
    shard on the meta device, the global shape and stride given."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    placements = SH.to_placements(spec, mesh)
    local_shape, _ = compute_local_shape_and_global_offset(
        t.shape, mesh, placements)
    local = torch.empty(local_shape, dtype=t.dtype, device="meta")
    dt = DTensor.from_local(local, mesh, placements, run_check=False,
                            shape=t.shape, stride=t.stride())
    return dt.requires_grad_() if requires_grad else dt


def _tree_zip(fn, tree, spec):
    if isinstance(tree, dict):
        return {k: _tree_zip(fn, tree[k], spec[k]) for k in tree}
    return fn(tree, spec)


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    return sum(_nbytes(t._local_tensor if isinstance(t, DTensor) else t)
               for t in _tensors(tree))


def _to(t, mesh, spec):
    """The reference's out sharding: ``t`` redistributed to ``spec``."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(mesh, SH.to_placements(spec, mesh))


def _logits_spec(cfg, mesh, b):
    dp = SH.data_axes(mesh)
    vx = ("model" if cfg.vocab_eff % SH.mesh_axes(mesh)["model"] == 0
          and cfg.vocab_eff == cfg.vocab else None)
    return SH._spec(dp if b > 1 else None, vx)


def _train_cell(cfg, shape, mesh, opt):
    tcfg = TrainConfig(opt=optim.OptConfig(kind="adamw", clip_norm=1.0))
    pshape = _params_shape(cfg)
    pspecs = SH.param_specs(cfg, SH.mesh_axes(mesh)["model"], opt=opt)
    ospecs = SH.zero1_specs(pspecs, pshape, mesh)
    params = _tree_zip(lambda t, s: _distribute(t, mesh, s, True), pshape,
                       pspecs)
    moments = _tree_zip(lambda t, s: _distribute(
        torch.empty(t.shape, dtype=torch.float32, device="meta"), mesh, s),
        pshape, ospecs)
    state = {"params": params, "opt": {"m": moments, "v": _tree_zip(
        lambda t, s: _distribute(torch.empty(t.shape, dtype=torch.float32,
                                             device="meta"), mesh, s),
        pshape, ospecs)}, "step": 0}
    bspecs = SH.batch_specs(cfg, mesh, shape)
    batch = _tree_zip(lambda t, s: _distribute(t, mesh, s),
                      input_specs(cfg, shape), bspecs)
    step = make_train_step(cfg, tcfg)

    def run():
        new, metrics = step(state, batch)
        metrics = {k: _to(v, mesh, ()) for k, v in metrics.items()}
        out = {"params": _tree_zip(lambda t, s: _to(t, mesh, s),
                                   new["params"], pspecs),
               "opt": {k: _tree_zip(lambda t, s: _to(t, mesh, s), v, ospecs)
                       for k, v in new["opt"].items()}}
        return out, metrics

    return run, (state, batch)


def _prefill_cell(cfg, shape, mesh, opt):
    fns = registry.model_fns(cfg)
    pspecs = SH.param_specs(cfg, SH.mesh_axes(mesh)["model"], opt=opt)
    params = _tree_zip(lambda t, s: _distribute(t, mesh, s),
                       _params_shape(cfg), pspecs)
    batch = _tree_zip(lambda t, s: _distribute(t, mesh, s),
                      input_specs(cfg, shape),
                      SH.batch_specs(cfg, mesh, shape))
    cspecs = SH.cache_specs(cfg, mesh, shape.global_batch, opt=opt)
    lspec = _logits_spec(cfg, mesh, shape.global_batch)

    def run():
        with torch.no_grad():
            logits, cache = fns.prefill(params, batch, cfg)
        return _to(logits, mesh, lspec), {
            k: _to(v, mesh, cspecs[k]) for k, v in cache.items()}

    return run, (params, batch)


def _decode_cell(cfg, shape, mesh, opt):
    fns = registry.model_fns(cfg)
    b = shape.global_batch
    pspecs = SH.param_specs(cfg, SH.mesh_axes(mesh)["model"], opt=opt)
    params = _tree_zip(lambda t, s: _distribute(t, mesh, s),
                       _params_shape(cfg), pspecs)
    cspecs = SH.cache_specs(cfg, mesh, b, opt=opt)
    cache = fns.init_cache(cfg, b, shape.seq_len, device="meta")
    cache = {k: (_distribute(v, mesh, cspecs[k]) if torch.is_tensor(v)
                 else v) for k, v in cache.items()}
    dp = SH.data_axes(mesh)
    tokens = _distribute(input_specs(cfg, shape)["tokens"], mesh,
                         SH._spec(dp, None) if b > 1 else (None, None))
    lspec = _logits_spec(cfg, mesh, b)

    def run():
        with torch.no_grad():
            logits, new = fns.decode_step(params, cache, tokens, cfg)
        return _to(logits, mesh, lspec), {
            k: _to(v, mesh, cspecs[k]) for k, v in new.items()}

    return run, (params, cache, tokens)


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, opt=False):
    """(run, args): ``run()`` runs the cell's step once over DTensors of
    ``args`` and returns its outputs in the reference's out shardings."""
    if shape.kind == "train":
        return _train_cell(cfg, shape, mesh, opt)
    if shape.kind == "prefill":
        return _prefill_cell(cfg, shape, mesh, opt)
    return _decode_cell(cfg, shape, mesh, opt)


class CellFailed(RuntimeError):
    """A step DTensor could not run; ``op`` names the op it failed in (and
    the ops before it, which may have given it a wrong placement)."""

    def __init__(self, ops, err: BaseException):
        ops = list(ops) or ["(before any DTensor op)"]
        self.op = ops[0]
        before = f" (after {', '.join(ops[1:])})" if ops[1:] else ""
        first = str(err).strip().splitlines()
        super().__init__(f"op {self.op}{before}: {type(err).__name__}: "
                         f"{first[0][:300] if first else ''}")


# ---------------------------------------------------------------------------
# Sharding rules the dry run adds to DTensor's
# ---------------------------------------------------------------------------


def _depthwise_layout(x, w):
    """A depthwise conv's layout: on each mesh dim, the channels (dim 1 of
    the input, 0 of the weight) sharded where the input's or the weight's
    are, else the input's batch shard kept, else replicated; (input,
    weight) placements."""
    from torch.distributed.tensor import Replicate, Shard
    px, pw = [], []
    for a, b in zip(x.placements, w.placements):
        if a.is_shard(1) or b.is_shard(0):
            px.append(Shard(1))
            pw.append(Shard(0))
        else:
            px.append(Shard(0) if a.is_shard(0) else Replicate())
            pw.append(Replicate())
    return px, pw


def _local(t, mesh, placements):
    return None if t is None else t.redistribute(mesh, placements
                                                 )._local_tensor


def _wrap(local, mesh, placements, shape):
    """``local`` as the DTensor of global ``shape``, contiguous (its
    strides computed, not taken from a tensor: an allocation here would
    count as the program's)."""
    from torch.distributed.tensor import DTensor
    if local is None:
        return None
    stride, n = [], 1
    for size in reversed(shape):
        stride.insert(0, n)
        n *= size
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def _is_depthwise(x, groups) -> bool:
    return groups > 1 and groups == x.shape[1]


def depthwise_conv(real, op_call, args, kwargs):
    """``aten.convolution`` of a depthwise conv (groups = channels, the
    mamba2 block's): each channel is its own conv, so the channels shard
    as they are and every device convolves its own (DTensor's own rule
    shards a conv by its spatial dim only). Other convs go to ``real``."""
    x, w, bias, stride, padding, dilation, transposed, out_pad, groups = args
    if kwargs or not _is_depthwise(x, groups):
        return real(op_call, args, kwargs)
    mesh = x.device_mesh
    px, pw = _depthwise_layout(x, w)
    lx, lw = _local(x, mesh, px), _local(w, mesh, pw)
    lb = _local(bias, mesh, pw) if bias is not None else None
    y = op_call(lx, lw, lb, stride, padding, dilation, transposed, out_pad,
                lx.shape[1])
    return _wrap(y, mesh, px, (x.shape[0], x.shape[1], y.shape[2]))


def depthwise_conv_backward(real, op_call, args, kwargs):
    """``aten.convolution_backward`` of :func:`depthwise_conv`: the same
    channel layout; the weight's and bias's gradients are partial sums
    over the mesh dims that shard the batch."""
    (dy, x, w, bias_sizes, stride, padding, dilation, transposed, out_pad,
     groups, mask) = args
    if kwargs or not _is_depthwise(x, groups):
        return real(op_call, args, kwargs)
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    px, pw = _depthwise_layout(x, w)
    lx, lw, ldy = _local(x, mesh, px), _local(w, mesh, pw), _local(
        dy, mesh, px)
    lbias = None if bias_sizes is None else [lx.shape[1]]
    dx, dw, db = op_call(ldy, lx, lw, lbias, stride, padding, dilation,
                         transposed, out_pad, lx.shape[1], mask)
    pg = [Shard(0) if b.is_shard(0) else Partial() if a.is_shard(0)
          else Replicate() for a, b in zip(px, pw)]
    return (_wrap(dx, mesh, px, x.shape), _wrap(dw, mesh, pg, w.shape),
            _wrap(db, mesh, pg, (w.shape[0],)))


def _changed_dims(src, dst) -> set:
    """The dims of shape ``src`` that a view to ``dst`` does not keep (all
    but its common leading and trailing sizes)."""
    src, dst = list(src), list(dst)
    lead = 0
    while lead < min(len(src), len(dst)) and src[lead] == dst[lead]:
        lead += 1
    trail = 0
    while (trail < min(len(src), len(dst)) - lead
           and src[-1 - trail] == dst[-1 - trail]):
        trail += 1
    return set(range(lead, len(src) - trail))


def reshard_on_refusal(real, op_call, args, kwargs):
    """A view that DTensor refuses for its input's layout (heads split out
    of a dim sharded over more devices than there are heads, a flatten of
    a dim sharded unevenly) runs with the fewest shards of the dims it
    changes gathered, inner dims first, as GSPMD gathers them. The
    gathers are collectives the counter counts."""
    from torch.distributed.tensor import DTensor, Replicate
    try:
        return real(op_call, args, kwargs)
    except Exception as refused:  # noqa: BLE001 - try gathered inputs
        x = args[0]
        if not isinstance(x, DTensor):
            raise
        changed = _changed_dims(x.shape, args[1])
        placements = list(x.placements)
        order = sorted((i for i, p in enumerate(placements)
                        if getattr(p, "dim", None) in changed),
                       key=lambda i: -placements[i].dim)
        for i in order:
            placements[i] = Replicate()
            try:
                return real(op_call, (x.redistribute(
                    x.device_mesh, placements), *args[1:]), kwargs)
            except Exception:  # noqa: BLE001 - gather one more
                continue
        raise refused


def reduce_gathered(real, op_call, args, kwargs):
    """A gather over a sharded dim leaves each device a masked partial
    sum; it is reduced at once, as GSPMD reduces it (DTensor would carry
    the mask on, and a later select loses track of it)."""
    from torch.distributed.tensor import DTensor, Replicate
    out = real(op_call, args, kwargs)
    if isinstance(out, DTensor) and any(p.is_partial()
                                        for p in out.placements):
        out = out.redistribute(out.device_mesh, [
            Replicate() if p.is_partial() else p for p in out.placements])
    return out


def _strided(p) -> bool:
    """A strided shard: a dim sharded after it was flattened with a dim
    before it (the sequence in ``(B*S, D)`` rows, heads in ``(B*H, ...)``
    batches)."""
    from torch.distributed.tensor.placement_types import _StridedShard
    return isinstance(p, _StridedShard)


def bmm_by_heads(real, op_call, args, kwargs):
    """``aten.bmm`` with its batch dim under a strided shard (an attention
    einsum's heads, flattened into the batch, sharded) on a mesh dim where
    the other operand is replicated or sharded alike: the replicated
    operand is cut the same way (a local slice, no collective) and each
    device multiplies its own heads, as GSPMD shards the einsum by heads.
    DTensor's own rule has no strided shard and gathers the batch, which
    replicates the attention. Other layouts go to ``real``."""
    from torch.distributed.tensor import DTensor
    a, b = args
    if kwargs or not (isinstance(a, DTensor) and isinstance(b, DTensor)):
        return real(op_call, args, kwargs)
    pa, pb = list(a.placements), list(b.placements)
    if not any(map(_strided, pa + pb)):
        return real(op_call, args, kwargs)
    batch = lambda p: getattr(p, "dim", None) == 0 and not p.is_partial()
    for i, (p, q) in enumerate(zip(a.placements, b.placements)):
        if batch(p) and (q == p or q.is_replicate()):
            pb[i] = p
        elif batch(q) and p.is_replicate():
            pa[i] = q
        elif not (p.is_replicate() and q.is_replicate()):
            return real(op_call, args, kwargs)
    mesh = a.device_mesh
    y = op_call(_local(a, mesh, pa), _local(b, mesh, pb))
    return _wrap(y, mesh, pa, (a.shape[0], a.shape[1], b.shape[2]))


def _column_parallel(q) -> bool:
    return q.is_shard() and q.dim == 1


def gather_sequence_rows(real, op_call, args, kwargs):
    """``aten.mm`` where, on a mesh dim, one operand's rows or
    contraction is a flattened sequence under a strided shard and the
    other is sharded there by a dim the product keeps (a weight's columns,
    an activation's features): the sequence is gathered over that mesh
    dim first, as Megatron-SP gathers it before a column-parallel product
    and, in the backward, gathers the gradient that a row-parallel
    product's reduce-scatter left sharded by the sequence. The forward's
    own products gather above autograd (:class:`SequenceParallel`); these
    are the backward's, which autograd runs below it. DTensor, left alone,
    shards the contraction and all-reduces a result replicated on every
    device, or gathers the larger operand."""
    from torch.distributed.tensor import DTensor, Replicate
    a, b = args
    if not (isinstance(a, DTensor) and isinstance(b, DTensor)):
        return real(op_call, args, kwargs)
    pa, pb = list(a.placements), list(b.placements)
    for i, (p, q) in enumerate(zip(a.placements, b.placements)):
        if _strided(p) and _column_parallel(q):
            pa[i] = Replicate()
        elif _strided(q) and q.dim == 0 and p.is_shard() and p.dim == 0:
            pb[i] = Replicate()
    if pa != list(a.placements):
        a = a.redistribute(a.device_mesh, pa)
    if pb != list(b.placements):
        b = b.redistribute(b.device_mesh, pb)
    return real(op_call, (a, b), kwargs)


def _rules() -> dict:
    aten = torch.ops.aten
    return {aten.mm.default: gather_sequence_rows,
            aten.bmm.default: bmm_by_heads,
            aten.convolution.default: depthwise_conv,
            aten.convolution_backward.default: depthwise_conv_backward,
            aten.view.default: reshard_on_refusal,
            aten._unsafe_view.default: reshard_on_refusal,
            aten.gather.default: reduce_gathered}


def _sequence_gathered(x, w):
    """The placements ``x`` takes before ``x @ w`` under Megatron-SP, or
    None to keep its own: the sequence gathered (a dim between the batch
    and the features of a 3-D or wider ``x``) on each mesh dim that shards
    the 2-D weight ``w`` by columns."""
    from torch.distributed.tensor import DTensor, Replicate
    if not (isinstance(x, DTensor) and isinstance(w, DTensor)
            and w.ndim == 2 and x.ndim >= 3):
        return None
    px = [Replicate() if _column_parallel(q)
          and 0 < getattr(p, "dim", -1) < x.ndim - 1 else p
          for p, q in zip(x.placements, w.placements)]
    return px if px != list(x.placements) else None


def _einsum_by_shared_letters(equation: str, operands):
    """The operands of ``torch.einsum(equation, *operands)`` resharded so
    that, on each mesh dim where one of them is sharded by a letter every
    operand has (a batch letter: an attention einsum's heads), the others
    sharded there by another letter (the sequence of K or V) take that
    letter too; the einsum then needs no collective. None when nothing
    moves."""
    from torch.distributed.tensor import DTensor, Shard
    ins = equation.replace(" ", "").split("->")[0].split(",")
    if (len(ins) != len(operands) or "." in equation
            or not all(isinstance(t, DTensor) for t in operands)):
        return None
    shared = set.intersection(*map(set, ins))
    new = list(operands)
    for m in range(operands[0].device_mesh.ndim):
        sharded = [(i, spec[t.placements[m].dim])
                   for i, (spec, t) in enumerate(zip(ins, new))
                   if t.placements[m].is_shard()]
        lead = next((c for _, c in sharded if c in shared), None)
        for i, c in sharded:
            if lead is not None and c != lead:
                placements = list(new[i].placements)
                placements[m] = Shard(ins[i].index(lead))
                new[i] = new[i].redistribute(new[i].device_mesh, placements)
    return new if any(a is not b for a, b in zip(new, operands)) else None


class SequenceParallel(torch.overrides.TorchFunctionMode):
    """Megatron-SP's layout, as GSPMD lays out the reference's
    ``seq_shard_residual`` stream, in the rules that act above autograd (a
    torch function mode; a handler in DTensor's dispatcher runs below it):

    * a product ``x @ w`` of the sequence-sharded stream with a
      column-parallel weight (a block's wq, w_gate and w_up, the head
      sharded on the vocabulary) takes the stream gathered over the
      weight's mesh dims, once a tensor (the copy lives as long as its
      source), and keeps the weight's columns sharded. Autograd records
      the gather, so its gradient is reduce-scattered back to the
      sequence. Left alone, DTensor shards the product's contraction
      instead and computes the head with the whole vocabulary on every
      device;
    * an einsum whose operands are sharded on one mesh dim by different
      letters, one of them a letter all share, runs on that letter
      (:func:`_einsum_by_shared_letters`): the attention's K and V, made
      from the sequence-sharded stream by weights that replication keeps
      whole (GQA's K/V), move from the sequence to the heads, and their
      gradients back, so the K/V products stay sharded by the sequence in
      the backward too."""

    _MATMULS = (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__)

    def __init__(self):
        super().__init__()
        self.gathered = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self._MATMULS and len(args) == 2:
            x, w = args
            px = _sequence_gathered(x, w)
            if px is not None:
                key = (id(x), tuple(px))
                if key not in self.gathered:  # dropped when x dies
                    self.gathered[key] = x.redistribute(x.device_mesh, px)
                    weakref.finalize(x, self.gathered.pop, key, None)
                args = (self.gathered[key], w)
        elif func is torch.einsum and isinstance(args[0], str):
            moved = _einsum_by_shared_letters(args[0], args[1:])
            if moved is not None:
                args = (args[0], *moved)
        return func(*args, **kwargs)


@contextlib.contextmanager
def dryrun_rules():
    """The rules above installed for the duration: the handlers in
    DTensor's dispatcher (its custom op handlers; torch's own handler, or
    its default propagation, is what a rule calls ``real``) and
    :class:`SequenceParallel`."""
    from torch.distributed.tensor import DTensor
    handlers = DTensor._op_dispatcher._custom_op_handlers
    ops = _rules()
    saved = {op: handlers.get(op) for op in ops}

    def real_of(op):
        def real(op_call, args, kwargs):
            if saved[op] is not None:
                return saved[op](op_call, args, kwargs)
            mine = handlers.pop(op)  # DTensor's own propagation
            try:
                return op_call(*args, **kwargs)
            finally:
                handlers[op] = mine
        return real

    for op, rule in ops.items():
        handlers[op] = functools.partial(rule, real_of(op))
    try:
        with SequenceParallel():
            yield
    finally:
        for op, h in saved.items():
            if h is None:
                handlers.pop(op, None)
            else:
                handlers[op] = h


@contextlib.contextmanager
def greedy_strategy_costs():
    """DTensor ranks an op's candidate shardings by the cost of
    redistributing its inputs to each, and plans that redistribution by a
    minimum-cost graph search wherever a strided shard appears (a dim
    sharded over two mesh dims and then reshaped). On a 3-D mesh that
    search takes minutes an op. Inside this context the ranking prices
    each candidate with DTensor's greedy plan instead (the plan it takes
    by default elsewhere); a plan it cannot make prices the candidate out.
    The redistributions that run are still planned by DTensor itself."""
    from torch.distributed.tensor import _collective_utils as CU
    from torch.distributed.tensor import _redistribute as R
    from torch.distributed.tensor._ops import utils as OU
    real_cost, real_infos = OU.redistribute_cost, R._gen_transform_infos

    @functools.cache
    def greedy(src, dst, use_graph_based_transform=None):
        return R.get_redistribute_planner(
            src.mesh, src.tensor_meta).generate_greedy_transform_infos(
                src, dst)

    def cost(current, target):
        R._gen_transform_infos = greedy
        try:
            return CU.redistribute_cost(current, target)
        except Exception:  # noqa: BLE001 - no greedy plan: not a candidate
            return float("inf")
        finally:
            R._gen_transform_infos = real_infos

    OU.redistribute_cost = cost
    try:
        yield
    finally:
        OU.redistribute_cost = real_cost


def measure(cfg: ModelConfig, shape: ShapeConfig, mesh, opt=False) -> dict:
    """One traced step: its local FLOPs, bytes, collectives and memory."""
    from torch.distributed.tensor.experimental import implicit_replication
    run, args = build_cell(cfg, shape, mesh, opt)
    counter = CostCounter()
    arg_bytes = _local_bytes(args)
    try:
        # the model's own plain tensors (positions, masks, scalars) are
        # replicated on every device, as the reference's constants are
        with counter, counter.ignoring_shape_inference(), \
                implicit_replication(), greedy_strategy_costs(), \
                dryrun_rules():
            out = run()
    except Exception as e:  # noqa: BLE001 - the cell's verdict
        raise CellFailed(counter.recent, e) from e
    rec = {"flops": counter.flops, "bytes": counter.bytes,
           "coll": sum(counter.coll.values()),
           "coll_by_kind": dict(counter.coll),
           "coll_counts": dict(counter.coll_counts),
           "argument_bytes_per_dev": arg_bytes,
           "output_bytes_per_dev": _local_bytes(out),
           "temp_bytes_per_dev": counter.peak}
    del out
    return rec


# ---------------------------------------------------------------------------
# Cost extrapolation (as the reference's cost_terms)
# ---------------------------------------------------------------------------


def _pattern_period(cfg: ModelConfig) -> int:
    if cfg.local_global_ratio > 0:
        return cfg.local_global_ratio + 1
    if cfg.family == "hybrid":
        return cfg.attn_every
    return 1


def _reduced(cfg: ModelConfig, n_layers: int) -> ModelConfig:
    kw = dict(n_layers=n_layers, scan_unroll=True)
    if cfg.family == "encdec":
        kw["enc_layers"] = max(1, cfg.enc_layers * n_layers // cfg.n_layers)
    return dataclasses.replace(cfg, **kw)


def cost_terms(cfg: ModelConfig, shape: ShapeConfig, mesh, opt=False
               ) -> dict:
    """FLOPs / bytes / collective bytes a device, extrapolated to depth L
    from steps at one and two pattern periods."""
    p = _pattern_period(cfg)
    a = measure(_reduced(cfg, p), shape, mesh, opt)
    b = measure(_reduced(cfg, 2 * p), shape, mesh, opt)
    scale = (cfg.n_layers - p) / p

    def extra(ka, kb):
        # a period's delta may come out slightly negative on tiny decode
        # graphs; clamp at zero, as the reference does
        return ka + max(kb - ka, 0.0) * scale

    return {
        "flops": extra(a["flops"], b["flops"]),
        "bytes": extra(a["bytes"], b["bytes"]),
        "coll": extra(a["coll"], b["coll"]),
        "coll_by_kind": {k: extra(a["coll_by_kind"][k], b["coll_by_kind"][k])
                         for k in a["coll_by_kind"]},
        "coll_counts_1period": a["coll_counts"],
        "period": p,
    }


def roofline(cfg: ModelConfig, shape: ShapeConfig, mesh, chips: int,
             opt=False) -> dict:
    costs = cost_terms(cfg, shape, mesh, opt=opt)
    t_compute = costs["flops"] / PEAK_FLOPS
    t_memory = costs["bytes"] / HBM_BW
    t_coll = costs["coll"] / LINK_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    mf = model_flops(cfg, shape)
    hlo_global = costs["flops"] * chips
    return {
        **costs,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "bottleneck": max(terms, key=terms.get),
        "model_flops_global": mf,
        "hlo_flops_global": hlo_global,
        "useful_ratio": mf / hlo_global if hlo_global else 0.0,
        "roofline_fraction": (mf / chips / PEAK_FLOPS) / max(
            max(terms.values()), 1e-12),
    }


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def cell_config(arch: str, cim=False, opt=False,
                cfg: Optional[ModelConfig] = None) -> ModelConfig:
    """The cell's config: ``--cim`` turns on MARS QAT w8a8, ``--opt``
    applies OPT_OVERRIDES and, for dense and vlm, ``seq_shard_residual``
    (as the reference's ``run_cell``)."""
    cfg = cfg or registry.get_config(arch)
    if cim:
        cfg = dataclasses.replace(cfg, cim_mode="qat", w_bits=8, a_bits=8,
                                  lambda_g=1e-5)
    if opt:
        cfg = dataclasses.replace(cfg, **OPT_OVERRIDES)
        if cfg.family in ("dense", "vlm"):
            cfg = dataclasses.replace(cfg, seq_shard_residual=True)
    return cfg


def run_cell(arch: str, shape_name: str, mesh, cim=False,
             with_roofline=True, opt=False,
             cfg: Optional[ModelConfig] = None,
             shape: Optional[ShapeConfig] = None) -> dict:
    """One cell's record (the reference's keys) on ``mesh``."""
    cfg = cell_config(arch, cim, opt, cfg)
    shape = shape or SHAPES[shape_name]
    sizes = SH.mesh_axes(mesh)
    chips = math.prod(sizes.values())
    t0 = time.time()
    full = measure(cfg, shape, mesh, opt)
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(v) for v in sizes.values()),
        "cim": cim, "opt": opt,
        "compile_s": round(time.time() - t0, 1),
        "argument_bytes_per_dev": int(full["argument_bytes_per_dev"]),
        "output_bytes_per_dev": int(full["output_bytes_per_dev"]),
        "temp_bytes_per_dev": int(full["temp_bytes_per_dev"]),
        "peak_bytes_per_dev": int(full["argument_bytes_per_dev"]
                                  + full["temp_bytes_per_dev"]),
    }
    if with_roofline:
        rec.update(roofline(cfg, shape, mesh, chips, opt=opt))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--all", action="store_true",
                    help="every architecture and shape (the defaults)")
    ap.add_argument("--multi-pod", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--cim", action="store_true",
                    help="the MARS QAT path in the traced step")
    ap.add_argument("--opt", action="store_true",
                    help="the reference's optimization set (OPT_OVERRIDES)")
    ap.add_argument("--no-roofline", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if args.all:
        args.arch = args.shape = "all"

    import torch.distributed as dist
    try:
        check_torch()
    except RuntimeError as e:
        print(f"dryrun: {e}", file=sys.stderr)
        return 2
    archs = registry.ARCH_IDS if args.arch == "all" else [args.arch]
    pods = {"single": [False], "multi": [True],
            "both": [False, True]}[args.multi_pod]
    results, failures = [], []
    for mp in pods:
        mesh = make_production_mesh(multi_pod=mp)
        mesh_name = "x".join(str(v) for v in SH.mesh_axes(mesh).values())
        try:
            for arch in archs:
                shapes = (registry.supported_cells(arch)
                          if args.shape == "all" else [args.shape])
                for shape_name in shapes:
                    tag = f"{arch} x {shape_name} x {mesh_name}"
                    t0 = time.time()
                    try:
                        rec = run_cell(arch, shape_name, mesh, cim=args.cim,
                                       opt=args.opt, with_roofline=(
                                           not args.no_roofline and not mp))
                    except Exception as e:  # noqa: BLE001 - keep sweeping
                        failures.append({"cell": tag, "error": str(e)[:500],
                                         "seconds": round(time.time() - t0,
                                                          1)})
                        print(f"FAIL {tag}: {str(e)[:300]}", flush=True)
                        continue
                    rec["seconds"] = round(time.time() - t0, 1)
                    results.append(rec)
                    extra = ""
                    if "t_compute_s" in rec:
                        extra = (f" compute={rec['t_compute_s']*1e3:.2f}ms"
                                 f" memory={rec['t_memory_s']*1e3:.2f}ms"
                                 f" coll={rec['t_collective_s']*1e3:.2f}ms"
                                 f" bound={rec['bottleneck']}"
                                 f" roofline={rec['roofline_fraction']:.2f}")
                    print(f"PASS {tag} compile={rec['compile_s']}s "
                          f"temp={rec['temp_bytes_per_dev']/2**30:.2f}GiB"
                          f" seconds={rec['seconds']}{extra}", flush=True)
        finally:
            dist.destroy_process_group()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"results": results, "failures": failures}, f,
                      indent=1)
    print(f"\n{len(results)} cells passed, {len(failures)} failed")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
