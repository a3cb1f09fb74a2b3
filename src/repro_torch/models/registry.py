"""Architecture registry: family -> model functions, name -> ModelConfig."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable

from . import encdec, transformer
from .config import SHAPES, ModelConfig, ShapeConfig

# the language models of the zoo, in the reference's order (the CNNs have
# configs too, but no cells)
ARCH_IDS = [
    "llava-next-34b",
    "mamba2-780m",
    "zamba2-1.2b",
    "whisper-tiny",
    "stablelm-12b",
    "yi-6b",
    "gemma3-27b",
    "granite-8b",
    "phi3.5-moe-42b-a6.6b",
    "grok-1-314b",
]

# the families the port serves: models.encdec's and models.transformer's
FAMILIES = transformer.FAMILIES + ("encdec",)


@dataclasses.dataclass(frozen=True)
class ModelFns:
    init_params: Callable
    train_loss: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable


def model_fns(cfg: ModelConfig) -> ModelFns:
    """The model functions of ``cfg``'s family: ``models.encdec``'s for
    the encdec family, ``models.transformer``'s for the others."""
    if cfg.family == "encdec":
        mod = encdec
    elif cfg.family in transformer.FAMILIES:
        mod = transformer
    else:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported ({FAMILIES} are)")
    return ModelFns(init_params=mod.init_params, train_loss=mod.train_loss,
                    prefill=mod.prefill, decode_step=mod.decode_step,
                    init_cache=mod.init_cache)


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


def shape_config(name: str) -> ShapeConfig:
    return SHAPES[name]


def supported_cells(arch: str):
    """The (arch x shape) cells of ``config.SHAPES`` that ``arch`` takes:
    long_500k only for the sub-quadratic decoders (ssm, hybrid, and the
    sliding-window pattern), as the reference's."""
    cfg = get_config(arch)
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.family in ("ssm", "hybrid") or cfg.local_global_ratio > 0:
        cells.append("long_500k")
    return cells
