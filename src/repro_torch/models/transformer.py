"""Decoder-only LM, dense and ssm (mamba2) families: parameters, the
full-sequence forward, and the static-batch serving entry points
(``prefill``, ``init_cache``, ``pad_cache``, ``decode_step``).

Parameters keep the reference's pytree layout as a plain dict: ``embed``,
``final_ln``, ``head`` (absent with tied embeddings) and ``layers``, whose
leaves are stacked along a leading layer axis. The layer loop runs on the
host, where the reference scans. A decode cache is a dict of stacked
tensors (dense: ``k``/``v`` (L,B,S,KV,dh); ssm: ``conv`` (L,B,W-1,C) and
``ssm`` (L,B,H,P,N)) plus ``pos``, a Python int; ``decode_step`` updates
its tensors in place, where the reference donates the cache to its jit.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from . import layers as L
from . import ssm as SSM
from .config import ModelConfig

FAMILIES = ("dense", "ssm")  # the families ported so far


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
    """Random parameters drawn from ``generator`` (which must live on
    ``device``). The numbers differ from the reference's ``jax.random``
    stream; tests carry the reference's own parameters across with
    :mod:`repro_torch.convert`."""
    _check_family(cfg)
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
    if cfg.family == "ssm":
        def layer_init():
            return {"ln": torch.zeros((d,), dtype=torch.float32, device=dev),
                    **SSM.mamba_init(generator, cfg, dtype, dev)}
    else:
        def layer_init():
            return _attn_layer_init(generator, cfg, dtype, dev)
    per_layer = [layer_init() for _ in range(cfg.n_layers)]
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


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet ({FAMILIES} are)")


def _embed_inputs(params: dict, batch: dict, cfg: ModelConfig):
    _check_family(cfg)
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


def _layer(params: dict, i: int) -> dict:
    return {k: v[i] for k, v in params["layers"].items()}


def _head(params: dict) -> torch.Tensor:
    return params["head"] if "head" in params else params["embed"].T


# ---------------------------------------------------------------------------
# Full-sequence forward and the serving entry points
# ---------------------------------------------------------------------------


def forward_hidden(params: dict, batch: dict, cfg: ModelConfig,
                   collect_cache: bool = False):
    """Returns (hidden (B,S,D), aux loss (0 for these families),
    cache-or-None)."""
    x = _embed_inputs(params, batch, cfg)
    parts = []
    if cfg.family == "dense":
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        windows, thetas = _layer_kind_arrays(cfg)
        for i in range(cfg.n_layers):
            x, kv = _attn_mlp_body(_layer(params, i), x, cfg, windows[i],
                                   thetas[i], positions)
            parts.append(kv)
        names = ("k", "v")
    else:  # ssm
        for i in range(cfg.n_layers):
            p = _layer(params, i)
            y, tails = SSM.mamba_block(p, L.rmsnorm(x, p["ln"]), cfg)
            x = x + y
            parts.append(tails)
        names = ("conv", "ssm")
    cache = None
    if collect_cache:
        cache = {name: torch.stack([t[j] for t in parts])
                 for j, name in enumerate(names)}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return L.rmsnorm(x, params["final_ln"]), aux, cache


def train_loss(params: dict, batch: dict, cfg: ModelConfig):
    raise NotImplementedError("training (with a straight-through backward "
                              "for fake_quant) is not ported yet")


def prefill(params: dict, batch: dict, cfg: ModelConfig):
    """Returns (last-position logits (B,V), cache dict with ``pos``)."""
    hidden, _, cache = forward_hidden(params, batch, cfg, collect_cache=True)
    logits = L.logits_out(_head(params), hidden[:, -1:, :],
                          cfg.cim)[:, 0, :cfg.vocab]
    cache["pos"] = int(batch["tokens"].shape[1])
    return logits, cache


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, dtype=None,
               device: DeviceLike = None) -> dict:
    """Empty decode cache."""
    _check_family(cfg)
    dev = resolve_device(device)
    z = lambda *shape: torch.zeros(shape, dtype=dtype or cfg.param_dtype,
                                   device=dev)
    if cfg.family == "dense":
        shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads_eff,
                 cfg.dh)
        return {"k": z(*shape), "v": z(*shape), "pos": 0}
    di, n, n_h = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    return {"conv": z(cfg.n_layers, batch_size, cfg.conv_width - 1,
                      di + 2 * n),
            "ssm": z(cfg.n_layers, batch_size, n_h, di // n_h, n),
            "pos": 0}


def pad_cache(cache: dict, max_len: int) -> dict:
    """Grow a prefill cache's seq axis to ``max_len`` for decoding."""
    out = dict(cache)
    for key in ("k", "v"):
        if key in cache and max_len > cache[key].shape[2]:
            pad = [0, 0] * (cache[key].dim() - 3) + [
                0, max_len - cache[key].shape[2]]
            out[key] = torch.nn.functional.pad(cache[key], pad)
    return out


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                cfg: ModelConfig):
    """One decode step. tokens: (B, 1). Returns (logits (B,V), cache): the
    cache's tensors are updated in place and ``pos`` advanced."""
    x = L.embed(params["embed"], tokens, cfg.param_dtype)
    pos = cache["pos"]
    if cfg.family == "dense":
        windows, thetas = _layer_kind_arrays(cfg)
        pos_b = torch.full((x.shape[0],), pos, dtype=torch.long,
                           device=x.device)
        for i in range(cfg.n_layers):
            p, cfg_l = _layer(params, i), _with_theta(cfg, thetas[i])
            attn, k, v = L.decode_attention_multi(
                p, L.rmsnorm(x, p["ln1"]), cache["k"][i], cache["v"][i],
                pos_b, cfg_l, window=windows[i])
            cache["k"][i, :, pos] = k[:, 0].to(cache["k"].dtype)
            cache["v"][i, :, pos] = v[:, 0].to(cache["v"].dtype)
            x = x + attn
            x = x + L.gated_mlp(p, L.rmsnorm(x, p["ln2"]), cfg.cim)
    else:
        _check_family(cfg)
        for i in range(cfg.n_layers):
            p = _layer(params, i)
            y, conv, h = SSM.mamba_decode_step(
                p, L.rmsnorm(x, p["ln"]), cache["conv"][i], cache["ssm"][i],
                cfg)
            cache["conv"][i].copy_(conv)
            cache["ssm"][i].copy_(h)
            x = x + y
    cache["pos"] = pos + 1
    x = L.rmsnorm(x, params["final_ln"])
    return L.logits_out(_head(params), x, cfg.cim)[:, 0, :cfg.vocab], cache
