"""Architecture registry: family -> model functions, name -> ModelConfig
(the configs ported so far)."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable

from . import transformer
from .config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ModelFns:
    init_params: Callable
    train_loss: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable


def model_fns(cfg: ModelConfig) -> ModelFns:
    """The model functions of ``cfg``'s family (dense, moe and ssm so
    far)."""
    if cfg.family not in transformer.FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet "
            f"({transformer.FAMILIES} are)")
    return ModelFns(
        init_params=transformer.init_params,
        train_loss=transformer.train_loss,
        prefill=transformer.prefill,
        decode_step=transformer.decode_step,
        init_cache=transformer.init_cache,
    )


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
