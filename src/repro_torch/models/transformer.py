"""Decoder-only LM, dense family: parameters and the per-layer block.

Parameters keep the reference's pytree layout as a plain dict: ``embed``,
``final_ln``, ``head`` (absent with tied embeddings) and ``layers``, whose
leaves are stacked along a leading layer axis.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from . import layers as L
from .config import ModelConfig


def _attn_layer_init(g: torch.Generator, cfg: ModelConfig, dtype,
                     device: torch.device) -> dict:
    d, dh = cfg.d_model, cfg.dh
    nh, nkv = cfg.n_heads_eff, cfg.n_kv_heads_eff
    s = 1.0 / d ** 0.5

    def normal(shape, scale):
        return torch.randn(shape, generator=g, dtype=dtype,
                           device=device) * scale

    def padded(shape, pad_axis, true_n, eff_n):
        """Zero the head-padding slices (forward-identical)."""
        w = normal(shape, s)
        if eff_n == true_n:
            return w
        m = (torch.arange(eff_n * dh, device=device) < true_n * dh).to(dtype)
        return w * (m[None, :] if pad_axis == 1 else m[:, None])

    zeros = lambda: torch.zeros((d,), dtype=torch.float32, device=device)
    return {
        "ln1": zeros(),
        "wq": padded((d, nh * dh), 1, cfg.n_heads, nh),
        "wk": padded((d, nkv * dh), 1, cfg.n_kv_heads, nkv),
        "wv": padded((d, nkv * dh), 1, cfg.n_kv_heads, nkv),
        "wo": padded((nh * dh, d), 0, cfg.n_heads, nh)
        * (d ** 0.5 / (nh * dh) ** 0.5),
        "ln2": zeros(),
        "w_gate": normal((d, cfg.d_ff), s),
        "w_up": normal((d, cfg.d_ff), s),
        "w_down": normal((cfg.d_ff, d), 1.0 / cfg.d_ff ** 0.5),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = None) -> dict:
    """Random dense-family parameters drawn from ``generator`` (which must
    live on ``device``). The numbers differ from the reference's
    ``jax.random`` stream; tests carry the reference's own parameters
    across with :mod:`repro_torch.convert`."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense only)")
    dev = resolve_device(device)
    dtype = cfg.param_dtype
    d = cfg.d_model
    params = {
        "embed": torch.randn((cfg.vocab_eff, d), generator=generator,
                             dtype=dtype, device=dev) * 0.02,
        "final_ln": torch.zeros((d,), dtype=torch.float32, device=dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = torch.randn((d, cfg.vocab_eff), generator=generator,
                                     dtype=dtype, device=dev) * 0.02
    per_layer = [_attn_layer_init(generator, cfg, dtype, dev)
                 for _ in range(cfg.n_layers)]
    params["layers"] = {k: torch.stack([p[k] for p in per_layer])
                        for k in per_layer[0]}
    return params


def _attn_mlp_body(p: dict, x: torch.Tensor, cfg: ModelConfig, window: int,
                   theta: Optional[float], positions: torch.Tensor):
    """One transformer block (full sequence). Returns (x, (k, v))."""
    cfg_l = cfg if theta is None else _with_theta(cfg, theta)
    h = L.rmsnorm(x, p["ln1"])
    attn, kv = L.self_attention(p, h, cfg_l, window=window,
                                positions=positions)
    x = x + attn
    h = L.rmsnorm(x, p["ln2"])
    return x + L.gated_mlp(p, h, cfg.cim), kv


def _with_theta(cfg: ModelConfig, theta: float) -> ModelConfig:
    """The config with a per-layer RoPE theta."""
    if theta == cfg.rope_theta:
        return cfg
    return dataclasses.replace(cfg, rope_theta=theta)


def _embed_inputs(params: dict, batch: dict, cfg: ModelConfig):
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    return L.embed(params["embed"], batch["tokens"], cfg.param_dtype)


def _layer_kind_arrays(cfg: ModelConfig) -> Tuple[List[int], List[float]]:
    """Per-layer (window, rope theta) as Python values: the layer loop runs
    on the host, only the kernel's layer id lives on the card."""
    kinds = cfg.layer_kinds()
    windows = [cfg.window if k == 1 else 0 for k in kinds]
    if cfg.local_global_ratio > 0:
        thetas = [cfg.rope_theta if k == 1 else 1e6 for k in kinds]
    else:
        thetas = [cfg.rope_theta] * cfg.n_layers
    return windows, thetas
