"""CIM configuration shared by the model code and deployment."""
from __future__ import annotations

import dataclasses

from .quant import QuantConfig
from .sparsity import SparsityConfig


@dataclasses.dataclass(frozen=True)
class CIMConfig:
    quant: QuantConfig = dataclasses.field(default_factory=QuantConfig)
    sparsity: SparsityConfig = dataclasses.field(
        default_factory=SparsityConfig)
    mode: str = "dense"  # dense | qat | deploy
    bn_momentum: float = 0.9
