"""Device resolution for the port's entry points.

``None`` means the GPU. There is no quiet CPU fallback: the CPU runs only
when the caller names it, as the tests do.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]

# the devices whose tensors the kernel wrappers hand to their plain
# versions: the CPU, and ``meta``, where the dry run traces shapes only; a
# CUDA tensor launches its kernel or raises
PLAIN_DEVICES = ("cpu", "meta")


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a GPU); anything else as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on an NVIDIA GPU by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    return dev


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (the dry run's sharded tensors). Reads
    ``torch.distributed.tensor`` only once something imported it: no
    tensor can be a DTensor before that, so plain callers never import
    it."""
    import sys
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)
