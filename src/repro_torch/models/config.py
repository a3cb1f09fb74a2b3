"""Model configuration (the fields of ``repro.models.config.ModelConfig``);
``param_dtype`` is a ``torch.dtype``."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..core.cim_layer import CIMConfig
from ..core.quant import QuantConfig
from ..core.sparsity import SparsityConfig


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    expert_split: int = 1

    # SSM (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4

    # attention patterns
    window: int = 0  # sliding-window size for local layers (0 = full)
    local_global_ratio: int = 0  # gemma3: local layers per global
    attn_every: int = 0  # zamba2: shared attention block every k ssm layers

    # encoder-decoder (whisper) / vlm (llava)
    enc_layers: int = 0
    enc_seq: int = 1500
    n_patches: int = 0

    # numerics
    dtype: str = "bfloat16"
    rope_theta: float = 10000.0
    remat: str = "full"
    scan_unroll: bool = False
    tie_embeddings: bool = False

    # performance knobs of the reference
    attn_chunk: int = 0
    head_pad: int = 1
    moe_group_size: int = 512
    ssd_lowp: bool = False
    ssm_split_proj: bool = False
    vocab_pad_multiple: int = 1
    moe_hints: bool = False
    seq_shard_residual: bool = False

    # MARS compression
    cim_mode: str = "dense"  # dense | qat
    w_bits: int = 8
    a_bits: int = 8
    lambda_g: float = 0.0
    cim_alpha: int = 128
    cim_n: int = 128

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_heads_eff(self) -> int:
        """Q heads after head padding (zero-init pads keep math identical)."""
        if self.head_pad <= 1 or self.n_heads == 0:
            return self.n_heads
        return -(-self.n_heads // self.head_pad) * self.head_pad

    @property
    def n_kv_heads_eff(self) -> int:
        return self.n_kv_heads

    @property
    def vocab_eff(self) -> int:
        m = max(self.vocab_pad_multiple, 1)
        return -(-self.vocab // m) * m

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def d_inner(self) -> int:  # ssm inner width
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.ssm_heads or max(1, self.d_inner // 64)

    @property
    def cim(self) -> CIMConfig:
        return CIMConfig(
            quant=QuantConfig(w_bits=self.w_bits, a_bits=self.a_bits,
                              group_size=self.cim_alpha, a_signed=True),
            sparsity=SparsityConfig(alpha=self.cim_alpha, n=self.cim_n,
                                    lambda_g=self.lambda_g),
            mode=self.cim_mode,
        )

    def layer_kinds(self) -> Tuple[int, ...]:
        """Per-layer kind codes. dense/moe/vlm: 0=full attn, 1=windowed.
        hybrid: 1 where the shared attention block fires."""
        if self.local_global_ratio > 0:
            period = self.local_global_ratio + 1
            return tuple(0 if (i % period == self.local_global_ratio) else 1
                         for i in range(self.n_layers))
        if self.attn_every > 0:
            return tuple(1 if (i % self.attn_every == self.attn_every - 1)
                         else 0 for i in range(self.n_layers))
        return tuple(0 for _ in range(self.n_layers))
