"""Checkpoints (the template-free pytree half, which serving artifacts
use); the trainer comes with training."""
from . import checkpoint  # noqa: F401
