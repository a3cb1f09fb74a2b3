"""PyTorch/CUDA port of the MARS compressed-serving stack.

The package mirrors ``repro``'s layout (``core/``, ``kernels/``, ``models/``,
``serve/``) so each module's counterpart is easy to find, and imports
neither JAX nor ``repro``. Every public entry point takes ``device=None``,
which means ``"cuda"``: without a GPU it raises unless the caller asked for
``device="cpu"`` (see :mod:`repro_torch.device`). On the CPU the kernel
wrappers run their plain PyTorch versions; on a CUDA tensor they launch the
hand-written kernels in ``csrc/`` or raise.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
