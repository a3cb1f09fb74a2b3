"""Meshes and sharding specs: the serving mesh (the macro cluster that
compressed projections and the paged KV views are laid over) and the
training specs of the reference's dry run.

The reference's ``launch/shardings.py`` builds a ``jax.sharding.Mesh``
whose ``macro`` axis one controller drives through ``shard_map``. The port
keeps that shape: one process, one :class:`MacroMesh`, one ``BatchServer``;
each macro is a ``torch.device``, and the sharded kernel wrappers run one
launch a macro on its own device and gather on the first. Several macros
may share one card (the port's target machine has one H100), so a mesh is
a placement of the work, not a count of cards; a process group would not
do (NCCL refuses two ranks on one GPU).

The training specs (``data_axes``, ``param_specs``, ``cache_specs``,
``batch_specs``, ``zero1_specs``) mirror the reference's line for line. A
spec is a :data:`Spec` tuple, one entry a tensor dim: ``None``
(replicated), a mesh axis name, or a tuple of names (``("pod", "data")``)
that shard that dim together. They read only a mesh's axis names and
sizes (:func:`mesh_axes`), so a ``DeviceMesh``, a :class:`MacroMesh` or
any object with the reference's ``shape``/``axis_names`` serves, and no
device is needed. :func:`to_placements` turns a spec into DTensor
placements over a ``DeviceMesh`` and :class:`NamedSharding` pairs a spec
with its mesh (the elastic restore's sharding); :func:`constrain` is the
reference's ``with_sharding_constraint``: a redistribute for a DTensor,
nothing for a plain tensor.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict, Optional, Tuple, Union

import torch

from ..device import DeviceLike, is_dtensor, resolve_device
from ..kernels.cim_bsr_matmul import MACRO_AXIS

Axis = Optional[Union[str, Tuple[str, ...]]]
Spec = Tuple[Axis, ...]


def _indexed(device: DeviceLike) -> torch.device:
    """``device`` resolved, a cuda device with its index (as tensors on it
    report theirs), so that devices compare equal to tensors' devices."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class MacroMesh:
    """A 1-D serving mesh: macro ``d`` computes on ``devices[d]``; the
    gathered results land on ``devices[0]``. ``MacroMesh(devices)`` puts
    one macro on each given device (one card per macro, say);
    :func:`macro_mesh` puts n macros on one."""

    devices: Tuple[torch.device, ...]
    axis_names: ClassVar[Tuple[str, ...]] = (MACRO_AXIS,)

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a macro mesh needs at least one macro")
        object.__setattr__(self, "devices",
                           tuple(_indexed(d) for d in self.devices))

    @property
    def shape(self) -> Dict[str, int]:
        return {MACRO_AXIS: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """Where the replicated tensors live and the gathers land."""
        return self.devices[0]


class KVShards:
    """A gathered K or V view split by KV head over the macros:
    ``parts[d]`` (..., KV / n, dh) holds macro d's heads, contiguous on its
    device. ``shape`` is the whole view's; indexing and assignment act on
    every part alike (``views[i]`` is layer i's view), an assigned value's
    KV heads (dim -2) split as the parts' are, and the index tensors of a
    key copied to each part's device."""

    __slots__ = ("parts",)

    def __init__(self, parts):
        self.parts = tuple(parts)

    @property
    def shape(self) -> torch.Size:
        p = self.parts[0].shape
        return torch.Size((*p[:-2], p[-2] * len(self.parts), p[-1]))

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    def split(self, t: torch.Tensor):
        """``t``'s KV heads (dim -2) as the parts hold them, each part's
        slice on that part's device."""
        w = self.parts[0].shape[-2]
        return [t[..., d * w:(d + 1) * w, :].to(p.device)
                for d, p in enumerate(self.parts)]

    def __getitem__(self, key) -> "KVShards":
        return KVShards(p[key] for p in self.parts)

    def __setitem__(self, key, value: torch.Tensor) -> None:
        key = key if isinstance(key, tuple) else (key,)
        for p, v in zip(self.parts, self.split(value)):
            p[tuple(k.to(p.device) if torch.is_tensor(k) else k
                    for k in key)] = v


def macro_mesh(n: int, device: DeviceLike = None) -> MacroMesh:
    """``n`` macros on one device (None means cuda). Unlike the reference,
    whose macros are distinct devices (``n`` at most the devices visible),
    macros here may share a card, so only ``n < 1`` is refused."""
    n = int(n)
    if n < 1:
        raise ValueError(f"a macro mesh needs n >= 1 macros, got {n}")
    return MacroMesh((_indexed(device),) * n)


def deployed_weight_specs() -> Dict[str, Spec]:
    """The layout contract of one macro-sharded packed projection dict,
    as the reference's PartitionSpecs: the block-column axis over the
    macros, the un-permute index replicated. Delegates to
    ``core.deploy.deployed_weight_specs``, which ``shard_weight`` applies."""
    from ..core.deploy import deployed_weight_specs as _specs
    return _specs()


def serve_kv_view_spec(cfg, mesh: MacroMesh) -> Spec:
    """Spec of the gathered paged-KV views (L, B, Sv, KV, dh): heads over
    the macros when the macro count divides the KV heads, else replicated
    (``()``). Delegates to ``serve.batching.kv_view_spec``, the predicate
    ``PagedKVCache`` applies."""
    from ..serve.batching import kv_view_spec
    spec = kv_view_spec(cfg, mesh)
    return spec if spec is not None else ()


# ---------------------------------------------------------------------------
# Training specs (the reference's dry-run shardings)
# ---------------------------------------------------------------------------


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (``mesh_dim_names`` and its
    ``shape`` tuple) or of a mesh with the reference's ``shape`` dict."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def data_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh_axes(mesh) else ("data",)


def _spec(*entries: Axis) -> Spec:
    """A spec with each one-axis tuple entry as its name, as a
    ``PartitionSpec`` normalizes it (``(("data",), None)`` is ``("data",
    None)``)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def _attn_layer_specs(cfg, stacked: bool, model_n: int = 16,
                      opt: bool = False) -> Dict[str, Spec]:
    pre = (None,) if stacked else ()
    # opt mode: K/V weights replicated when the KV heads do not divide the
    # TP axis (Megatron's GQA layout)
    kv_spec = ((*pre, None, None)
               if opt and cfg.n_kv_heads % model_n != 0
               else (*pre, None, "model"))
    sp = {
        "ln1": pre, "ln2": pre,
        "wq": (*pre, None, "model"),
        "wk": kv_spec,
        "wv": kv_spec,
        "wo": (*pre, "model", None),
    }
    if cfg.family == "moe":
        sp["router"] = pre
        sp["w_gate"] = (*pre, "data", None, "model")
        sp["w_up"] = (*pre, "data", None, "model")
        sp["w_down"] = (*pre, "data", "model", None)
    else:
        sp["w_gate"] = (*pre, None, "model")
        sp["w_up"] = (*pre, None, "model")
        sp["w_down"] = (*pre, "model", None)
    return sp


def _mamba_layer_specs(cfg, pre: Spec, opt: bool = False) -> Dict[str, Spec]:
    if opt:
        # the split layout (ssm_split_proj): z|x over the TP axis, the
        # small b|c and dt weights replicated
        return {
            "ln": pre,
            "w_zx": (*pre, None, "model"),
            "w_bc": pre,
            "w_dt": pre,
            "conv_xw": (*pre, None, "model"),
            "conv_xb": (*pre, "model"),
            "conv_bcw": pre, "conv_bcb": pre,
            "a_log": pre, "dt_bias": pre, "d_skip": pre,
            "norm_g": (*pre, "model"),
            "out_proj": (*pre, "model", None),
        }
    return {
        "ln": pre,
        "in_proj": (*pre, None, "model"),
        "conv_w": (*pre, None, "model"),
        "conv_b": (*pre, "model"),
        "a_log": pre, "dt_bias": pre, "d_skip": pre,
        "norm_g": (*pre, "model"),
        "out_proj": (*pre, "model", None),
    }


def _embed_specs(cfg, model_n: int) -> Tuple[Spec, Spec]:
    """Vocab-parallel embedding and head when the (padded) vocab divides
    the TP axis, else both sharded on d."""
    if cfg.vocab_eff % model_n == 0:
        return ("model", None), (None, "model")
    return (None, "model"), ("model", None)


def param_specs(cfg, model_n: int = 16, opt: bool = False) -> dict:
    """Specs of ``registry.model_fns(cfg).init_params``'s tree."""
    emb_spec, head_spec = _embed_specs(cfg, model_n)
    if cfg.family == "encdec":
        kv = ((None, None, None) if opt and cfg.n_kv_heads % model_n != 0
              else (None, None, "model"))
        attn = {"wq": (None, None, "model"), "wk": kv,
                "wv": kv, "wo": (None, "model", None)}
        ln = {"g": (None,), "b": (None,)}
        mlp = {"w_up": (None, None, "model"), "w_down": (None, "model", None)}
        return {
            "embed": emb_spec,
            "pos_dec": (),
            "enc_layers": {"ln1": ln, "attn": attn, "ln2": ln, "mlp": mlp},
            "dec_layers": {"ln1": ln, "self": attn, "lnx": ln, "cross": attn,
                           "ln2": ln, "mlp": mlp},
            "enc_ln": {"g": (), "b": ()},
            "dec_ln": {"g": (), "b": ()},
        }

    sp: dict = {"embed": emb_spec, "final_ln": ()}
    if not cfg.tie_embeddings:
        sp["head"] = head_spec
    if cfg.family in ("dense", "moe", "vlm"):
        sp["layers"] = _attn_layer_specs(cfg, stacked=True, model_n=model_n,
                                         opt=opt)
    elif cfg.family == "ssm":
        sp["layers"] = _mamba_layer_specs(cfg, (None,), opt=opt)
    elif cfg.family == "hybrid":
        sp["layers_body"] = _mamba_layer_specs(cfg, (None, None), opt=opt)
        n_tail = cfg.n_layers - (cfg.n_layers // cfg.attn_every
                                 ) * cfg.attn_every
        if n_tail:
            sp["layers_tail"] = _mamba_layer_specs(cfg, (None,), opt=opt)
        sp["shared_attn"] = _attn_layer_specs(cfg, stacked=False,
                                              model_n=model_n, opt=opt)
        sp["attn_gate"] = ()
    else:
        raise ValueError(cfg.family)
    if cfg.family == "vlm":
        sp["mm_proj"] = (None, "model")
    return sp


def _kv_cache_spec(cfg, mesh, batch: int, lead: int = 1,
                   opt: bool = False) -> Spec:
    """Spec of (lead..., B, S, KV, dh) caches."""
    dp = data_axes(mesh)
    axes = mesh_axes(mesh)
    model_n = axes["model"]
    pre = (None,) * lead
    if opt:
        # the cache sharded on its length: a decode step's write stays on
        # one shard
        if batch == 1:
            return (*pre, None, ("data", "model") if "pod" not in axes
                    else ("pod", "data", "model"), None, None)
        return _spec(*pre, dp, "model", None, None)
    if batch == 1:
        # sequence parallel: the cache length over the data axes
        if cfg.n_kv_heads and cfg.n_kv_heads % model_n == 0:
            return _spec(*pre, None, dp, "model", None)
        return _spec(*pre, None, dp, None, None)
    if cfg.n_kv_heads and cfg.n_kv_heads % model_n == 0:
        return _spec(*pre, dp, None, "model", None)
    if cfg.dh % model_n == 0:
        return _spec(*pre, dp, None, None, "model")
    return _spec(*pre, dp, None, None, None)


def cache_specs(cfg, mesh, batch: int, opt: bool = False) -> dict:
    """Specs of a decode cache (the reference's stacked layout; ``pos`` a
    replicated scalar)."""
    dp = data_axes(mesh)
    model_n = mesh_axes(mesh)["model"]
    if cfg.family in ("dense", "moe", "vlm"):
        kv = _kv_cache_spec(cfg, mesh, batch, opt=opt)
        return {"k": kv, "v": kv, "pos": ()}
    if cfg.family == "ssm":
        h_ax = "model" if cfg.n_ssm_heads % model_n == 0 else None
        bp = dp if batch > 1 else None
        return {
            "conv": _spec(None, bp, None, "model"),
            "ssm": _spec(None, bp, h_ax, None, None),
            "pos": (),
        }
    if cfg.family == "hybrid":
        bp = dp if batch > 1 else None
        h_ax = "model" if cfg.n_ssm_heads % model_n == 0 else None
        kv = _kv_cache_spec(cfg, mesh, batch, opt=opt)
        sp = {
            "conv": _spec(None, None, bp, None, "model"),
            "ssm": _spec(None, None, bp, h_ax, None, None),
            "k": kv, "v": kv, "pos": (),
        }
        n_tail = cfg.n_layers - (cfg.n_layers // cfg.attn_every
                                 ) * cfg.attn_every
        if n_tail:
            sp["conv_tail"] = _spec(None, bp, None, "model")
            sp["ssm_tail"] = _spec(None, bp, h_ax, None, None)
        return sp
    if cfg.family == "encdec":
        kv = _kv_cache_spec(cfg, mesh, batch, opt=opt)
        return {"k": kv, "v": kv, "xk": kv, "xv": kv, "pos": ()}
    raise ValueError(cfg.family)


def batch_specs(cfg, mesh, shape) -> dict:
    """Specs of a batch of ``shape`` (a ``config.ShapeConfig``)."""
    dp = data_axes(mesh)
    if shape.kind == "decode":
        tok = _spec(dp, None) if shape.global_batch > 1 else (None, None)
    elif shape.global_batch == 1:
        tok = _spec(None, dp)  # sequence parallel
    else:
        tok = _spec(dp, None)
    sp = {"tokens": tok}
    bp = dp if shape.global_batch > 1 else None
    if cfg.family == "vlm":
        sp["patch_embeds"] = _spec(bp, None, None)
    if cfg.family == "encdec":
        sp["frames"] = _spec(bp, None, None)
    return sp


def zero1_specs(pspecs, params_shape, mesh):
    """Optimizer-moment specs (ZeRO-1): each parameter's spec with its
    largest free dim (one the spec leaves replicated, divisible by the
    data axes' size) also sharded over the data axes the spec does not
    use; the parameter's spec when nothing fits. ``params_shape`` holds
    anything with a ``shape`` (tensors, meta tensors), in ``pspecs``'s
    tree."""
    dp = data_axes(mesh)
    axes = mesh_axes(mesh)

    def one(spec: Spec, leaf) -> Spec:
        shape = tuple(leaf.shape)
        dims = list(spec) + [None] * (len(shape) - len(spec))
        used = set()
        for d in dims:
            for a in (d if isinstance(d, tuple) else (d,)):
                if a is not None:
                    used.add(a)
        free = tuple(a for a in dp if a not in used)  # moe uses "data" on E
        if not free:
            return spec
        n_free = 1
        for a in free:
            n_free *= axes[a]
        best, best_size = None, 0
        for i, (sz, d) in enumerate(zip(shape, dims)):
            if d is None and sz % n_free == 0 and sz > best_size:
                best, best_size = i, sz
        if best is None:
            return spec
        dims[best] = free if len(free) > 1 else free[0]
        return tuple(dims)

    def walk(sp, shp):
        if isinstance(sp, dict):
            return {k: walk(sp[k], shp[k]) for k in sp}
        return one(sp, shp)

    return walk(pspecs, params_shape)


def to_placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` over the ``DeviceMesh`` ``mesh``:
    ``Shard(d)`` on each mesh dim whose axis names tensor dim d,
    ``Replicate()`` on the others. A tuple entry shards d over its axes,
    the first the major one, as JAX splits it; DTensor splits a dim over
    several mesh dims in mesh order, so the entry must list its axes in
    mesh order (the reference's specs do), and any other order, or an
    axis named twice, raises ValueError."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    owner: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        axes = [a for a in (entry if isinstance(entry, tuple) else (entry,))
                if a is not None]
        if any(a in owner for a in axes) or len(set(axes)) < len(axes):
            raise ValueError(f"spec {spec} names an axis twice")
        if [names.index(a) for a in axes] != sorted(names.index(a)
                                                    for a in axes):
            raise ValueError(
                f"spec entry {entry} lists its axes out of mesh order "
                f"{names}: DTensor would split the dim in mesh order, JAX "
                "in the entry's")
        owner.update((a, d) for a in axes)
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in names)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """The port's counterpart of ``jax.sharding.NamedSharding``: a
    ``DeviceMesh`` and a spec in the reference's tuple form (one-axis
    tuple entries as their names, as a ``PartitionSpec`` normalizes
    them). ``train.checkpoint.restore(shardings=)`` places each leaf by
    one."""

    mesh: object
    spec: Spec

    def __post_init__(self):
        object.__setattr__(self, "spec", _spec(*self.spec))

    def placements(self) -> tuple:
        return to_placements(self.spec, self.mesh)


def constrain(t: torch.Tensor, spec: Spec) -> torch.Tensor:
    """The reference's ``with_sharding_constraint``: a DTensor ``t``
    redistributed to ``spec`` over its mesh; any other tensor as it is."""
    if not is_dtensor(t):
        return t
    mesh = t.device_mesh
    return t.redistribute(mesh, to_placements(spec, mesh))
