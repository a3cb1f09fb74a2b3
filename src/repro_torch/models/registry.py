"""Architecture name -> ModelConfig (the configs ported so far)."""
from __future__ import annotations

import dataclasses
import importlib

from .config import ModelConfig


def _module(arch: str):
    return importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))


def get_config(arch: str, **overrides) -> ModelConfig:
    """``configs/<arch>.py``'s CONFIG with ``overrides`` applied."""
    cfg = _module(arch).CONFIG
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_smoke_config(arch: str, **overrides) -> ModelConfig:
    cfg = _module(arch).SMOKE
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
