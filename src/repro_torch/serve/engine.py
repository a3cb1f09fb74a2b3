"""Serving configuration and token sampling."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0  # 0 => greedy
    eos_id: int = -1  # -1 => never stop early
    seed: int = 0


def sample_tokens(logits: torch.Tensor, generator: Optional[torch.Generator],
                  scfg: ServeConfig) -> torch.Tensor:
    """(B, V) logits -> (B,) int32 tokens: argmax at temperature <= 0, else
    a temperature-scaled categorical draw from ``generator`` (it cannot
    follow JAX's PRNG stream, so it matches the reference only in
    distribution)."""
    if scfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / scfg.temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)
