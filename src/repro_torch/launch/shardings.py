"""The serving mesh: the macro cluster that compressed projections and the
paged KV views are laid over.

The reference's ``launch/shardings.py`` builds a ``jax.sharding.Mesh``
whose ``macro`` axis one controller drives through ``shard_map``. The port
keeps that shape: one process, one :class:`MacroMesh`, one ``BatchServer``;
each macro is a ``torch.device``, and the sharded kernel wrappers run one
launch a macro on its own device and gather on the first. Several macros
may share one card (the port's target machine has one H100), so a mesh is
a placement of the work, not a count of cards; a process group would not
do (NCCL refuses two ranks on one GPU).

Only the serving specs are here. The training specs of the reference's
module (``param_specs``, ``cache_specs``, ``zero1_specs``, ...) belong to
its dry-run and pipeline paths, which the port has not taken over.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..kernels.cim_bsr_matmul import MACRO_AXIS

Spec = Tuple[Optional[str], ...]


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
