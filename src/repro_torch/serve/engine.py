"""Static-batch serving engine: prefill + decode with KV/state caches.

:class:`Engine` serves the dense and ssm families: greedy or temperature
sampling, per-sequence EOS tracking (a finished row keeps decoding but its
output is frozen), the cache updated in place by every decode step. For
request-level continuous batching see ``serve.server.BatchServer``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..models import registry, transformer
from ..models.config import ModelConfig


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


class Engine:
    def __init__(self, cfg: ModelConfig, params: dict,
                 scfg: Optional[ServeConfig] = None,
                 fns: Optional[registry.ModelFns] = None):
        """``params`` is what ``fns`` consumes (the registry's model params
        by default). ``scfg`` defaults to a fresh ServeConfig per engine."""
        if cfg.family not in transformer.FAMILIES:
            raise NotImplementedError(
                f"Engine serves the {transformer.FAMILIES} families; "
                f"{cfg.family!r} is not ported yet")
        self.cfg = cfg
        self.params = params
        self.scfg = scfg if scfg is not None else ServeConfig()
        self.fns = fns if fns is not None else registry.model_fns(cfg)

    @torch.no_grad()
    def generate(self, batch: dict, max_new_tokens: Optional[int] = None
                 ) -> np.ndarray:
        """batch: ``tokens`` (B, S) on the params' device. Returns
        (B, max_new_tokens) generated ids; a row's ids after its EOS are 0."""
        scfg = self.scfg
        n_new = max_new_tokens or scfg.max_new_tokens
        bsz, s = batch["tokens"].shape
        logits, cache = self.fns.prefill(self.params, batch, self.cfg)
        if self.cfg.family == "dense":
            cache = transformer.pad_cache(cache, s + n_new)
        gen = None
        if scfg.temperature > 0.0:
            gen = torch.Generator(device=logits.device).manual_seed(scfg.seed)
        out = np.zeros((bsz, n_new), np.int32)
        done = np.zeros((bsz,), bool)
        tok = self._sample(logits, gen)
        for t in range(n_new):
            host = tok[:, 0].cpu().numpy()
            out[:, t] = np.where(done, 0, host)
            done |= host == scfg.eos_id
            if done.all():
                break
            logits, cache = self.fns.decode_step(self.params, cache, tok,
                                                 self.cfg)
            tok = self._sample(logits, gen)
        return out

    def _sample(self, logits: torch.Tensor,
                gen: Optional[torch.Generator]) -> torch.Tensor:
        return sample_tokens(logits, gen, self.scfg)[:, None]
