"""Meshes: the production meshes of the dry run and the local training
mesh.

:func:`make_production_mesh` is the reference's production mesh, (16, 16)
``("data", "model")`` or (2, 16, 16) ``("pod", "data", "model")``, as a
``DeviceMesh`` on torch's fake process group (:func:`make_fake_mesh`):
256 or 512 ranks of which this process is rank 0, device type ``cpu``, no
collective ever run. It is
torch's counterpart of the reference's fake host devices; the dry run
(``launch/dryrun.py``) traces its steps over it on the meta device. The
function creates the process group; the caller destroys it
(``torch.distributed.destroy_process_group``). Only it imports
``torch.testing._internal`` (where the fake store lives).

:func:`make_local_mesh` is the single-controller training mesh over the
cards present: one process drives them, as one controller drives the
reference's mesh, with no process group (NCCL refuses two ranks on one
GPU). Compressed data parallelism (``train/compression.py``) and the
pipeline (``train/pipeline.py``) take it; a mesh may put several replicas
or stages on one card, as ``launch.shardings.macro_mesh`` puts macros.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..device import DeviceLike, resolve_device

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) or (2, 16, 16) production ``DeviceMesh`` on a fresh
    fake process group (module docstring)."""
    return make_fake_mesh(*PRODUCTION_SHAPES[bool(multi_pod)])


def make_fake_mesh(shape: Sequence[int], names: Sequence[str],
                   rank: int = 0, device_type: str = "cpu"):
    """A ``DeviceMesh`` of ``shape`` with axes ``names`` on a fresh fake
    process group of ``prod(shape)`` ranks, this process rank ``rank``
    (the production meshes, or a small one for tests and for standing as
    any rank of a mesh, as the elastic restore's checks do), its shards on
    ``device_type``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape, names = tuple(shape), tuple(names)
    world = 1
    for n in shape:
        world *= n
    if dist.is_initialized():
        raise RuntimeError("a process group exists already; destroy it "
                           "before making a production mesh")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not in a mesh of {world} ranks")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """A single-controller mesh: ``devices[i]`` holds position i along the
    first axis (a replica, or a pipeline stage), the model axis is 1.
    ``shape`` and ``axis_names`` are the reference's mesh attributes."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("data", "model")

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a local mesh needs at least one device")
        object.__setattr__(self, "devices", tuple(
            torch.device(d) for d in self.devices))

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: len(self.devices),
                **{n: 1 for n in self.axis_names[1:]}}


def make_local_mesh(n: Optional[int] = None, device: DeviceLike = None,
                    names: Sequence[str] = ("data", "model")) -> LocalMesh:
    """The ``(n, 1)`` single-controller mesh. With no ``device``: one
    position per card present (``n`` defaults to the card count; a larger
    ``n`` wraps around the cards). With ``device`` (``"cpu"``, say): all
    ``n`` positions on it. Raises without a GPU unless a device is named."""
    if device is not None:
        dev = resolve_device(device)
        n = 1 if n is None else int(n)
        devs = (dev,) * n
    else:
        resolve_device(None)
        cards = torch.cuda.device_count()
        n = cards if n is None else int(n)
        devs = tuple(torch.device("cuda", i % cards) for i in range(n))
    if n < 1:
        raise ValueError(f"a local mesh needs n >= 1, got {n}")
    return LocalMesh(devs, tuple(names))
