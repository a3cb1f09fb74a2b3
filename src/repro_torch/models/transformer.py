"""Decoder-only LM, dense, moe, vlm, ssm (mamba2) and hybrid (zamba2)
families: parameters, the full-sequence forward, and the static-batch
serving entry points (``prefill``, ``init_cache``, ``pad_cache``,
``ring_cache``, ``decode_step``). Every family trains through
``train_loss``.

Parameters keep the reference's pytree layout as a plain dict: ``embed``,
``final_ln``, ``head`` (absent with tied embeddings) and ``layers``, whose
leaves are stacked along a leading layer axis; the vlm family adds
``mm_proj``, the projector of the precomputed patch embeddings it
prepends to the text. The hybrid family has ``layers_body`` (leaves
(n_super, attn_every, ...): super-layers of ``attn_every`` mamba blocks,
each followed by the one ``shared_attn`` block, attention and gated MLP,
scaled by that super-layer's ``attn_gate``) and ``layers_tail`` (the
mamba blocks left over, if any). The layer loop runs on the host, where
the reference scans. A decode cache is a dict of stacked tensors (dense,
moe and vlm: ``k``/``v`` (L,B,S,KV,dh); ssm: ``conv`` (L,B,W-1,C) and
``ssm`` (L,B,H,P,N); hybrid: ``conv``/``ssm`` with leading (n_super,
attn_every), ``conv_tail``/``ssm_tail``, and the shared block's ``k``/``v``
(n_super,B,S,KV,dh), a ring of at most ``window`` slots) plus ``pos``, a
Python int; ``decode_step`` updates its tensors in place, where the
reference donates the cache to its jit.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..launch.shardings import constrain
from . import layers as L
from . import ssm as SSM
from .config import ModelConfig

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")
ATTENTION = ("dense", "moe", "vlm")  # the families with a KV cache a layer


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
        **_mlp_init(g, cfg, dtype, device, normal, s),
    }


def _mlp_init(g: torch.Generator, cfg: ModelConfig, dtype,
              device: torch.device, normal, s: float) -> dict:
    """The gated MLP's weights, or the moe family's f32 router and expert
    stacks (``expert_split`` sub-experts of d_ff / split each)."""
    d = cfg.d_model
    if cfg.family != "moe":
        return {"w_gate": normal((d, cfg.d_ff), s),
                "w_up": normal((d, cfg.d_ff), s),
                "w_down": normal((cfg.d_ff, d), 1.0 / cfg.d_ff ** 0.5)}
    e_eff = cfg.n_experts * cfg.expert_split
    ff = cfg.d_ff // cfg.expert_split
    return {"router": torch.randn((d, cfg.n_experts), generator=g,
                                  dtype=torch.float32, device=device) * s,
            "w_gate": normal((e_eff, d, ff), s),
            "w_up": normal((e_eff, d, ff), s),
            "w_down": normal((e_eff, ff, d), 1.0 / cfg.d_ff ** 0.5)}


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

    def mamba_init():
        return {"ln": torch.zeros((d,), dtype=torch.float32, device=dev),
                **SSM.mamba_init(generator, cfg, dtype, dev)}

    def stacked(init, n):
        per_layer = [init() for _ in range(n)]
        return {k: torch.stack([p[k] for p in per_layer])
                for k in per_layer[0]}

    if cfg.family == "hybrid":
        n_super, n_tail = _hybrid_split(cfg)
        body = stacked(mamba_init, n_super * cfg.attn_every)
        params["layers_body"] = {
            k: v.reshape(n_super, cfg.attn_every, *v.shape[1:])
            for k, v in body.items()}
        if n_tail:
            params["layers_tail"] = stacked(mamba_init, n_tail)
        params["shared_attn"] = _attn_layer_init(generator, cfg, dtype, dev)
        params["attn_gate"] = torch.ones((n_super,), dtype=torch.float32,
                                         device=dev)
        return params
    params["layers"] = stacked(
        mamba_init if cfg.family == "ssm"
        else lambda: _attn_layer_init(generator, cfg, dtype, dev),
        cfg.n_layers)
    if cfg.family == "vlm":
        params["mm_proj"] = torch.randn(
            (d, d), generator=generator, dtype=dtype, device=dev) * (
                1.0 / d ** 0.5)
    return params


def _hybrid_split(cfg: ModelConfig) -> Tuple[int, int]:
    """(super-layers, tail mamba blocks) of the hybrid family."""
    n_super = cfg.n_layers // cfg.attn_every
    return n_super, cfg.n_layers - n_super * cfg.attn_every


def _attn_mlp_body(p: dict, x: torch.Tensor, cfg: ModelConfig, window: int,
                   theta: Optional[float], positions: torch.Tensor):
    """One transformer block (full sequence). Returns (x, aux, (k, v)):
    aux is the moe family's load-balancing loss, None for the dense one."""
    cfg_l = cfg if theta is None else _with_theta(cfg, theta)
    h = L.rmsnorm(x, p["ln1"])
    attn, kv = L.self_attention(p, h, cfg_l, window=window,
                                positions=positions)
    x = x + attn
    y, aux = mlp(p, L.rmsnorm(x, p["ln2"]), cfg)
    x = x + y
    if cfg.seq_shard_residual:
        # the reference's Megatron-SP hint: the residual stream's sequence
        # dim over the TP axis between layers (a no-op on plain tensors)
        x = constrain(x, ("data", "model", None))
    return x, aux, kv


def mlp(p: dict, h: torch.Tensor, cfg: ModelConfig):
    """The block's MLP: the moe family's ``moe_block``, else the gated MLP
    (no aux loss). Returns (y, aux or None)."""
    if cfg.family == "moe":
        return L.moe_block(p, h, cfg)
    return L.gated_mlp(p, h, cfg.cim), None


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
    """The token embeddings; the vlm family prepends ``patch_embeds`` (B,
    P, D) through ``mm_proj``, a plain product in the model dtype."""
    _check_family(cfg)
    x = L.embed(params["embed"], batch["tokens"], cfg.param_dtype)
    if cfg.family == "vlm":
        patches = batch["patch_embeds"].to(cfg.param_dtype)
        patches = patches @ params["mm_proj"].to(patches.dtype)
        x = torch.cat([patches, x], dim=1)
    return x


def _prompt_len(batch: dict, cfg: ModelConfig) -> int:
    """The positions a prefill fills: the tokens and any patches."""
    n = int(batch["tokens"].shape[1])
    if cfg.family == "vlm":
        n += int(batch["patch_embeds"].shape[1])
    return n


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


def _mamba_body(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """One mamba2 layer with its pre-norm and residual. Returns (x,
    (conv_tail, h_final))."""
    y, tails = SSM.mamba_block(p, L.rmsnorm(x, p["ln"]), cfg)
    return x + y, tails


def _maybe_remat(fn, cfg: ModelConfig, x: torch.Tensor):
    """``cfg.remat`` as :func:`layers.maybe_remat`. "dots" (the reference
    keeps the matmul outputs) recomputes the whole layer too."""
    return L.maybe_remat(fn, cfg.remat in ("full", "dots"), x)


def forward_hidden(params: dict, batch: dict, cfg: ModelConfig,
                   collect_cache: bool = False):
    """Returns (hidden (B,S,D), aux loss (the moe family's summed over
    layers, else 0), cache-or-None)."""
    x = _embed_inputs(params, batch, cfg)
    parts = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family in ATTENTION:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        windows, thetas = _layer_kind_arrays(cfg)
        body = _maybe_remat(_attn_mlp_body, cfg, x)
        for i in range(cfg.n_layers):
            x, a, kv = body(_layer(params, i), x, cfg, windows[i], thetas[i],
                            positions)
            aux = aux if a is None else aux + a
            parts.append(kv)
        names = ("k", "v")
    elif cfg.family == "hybrid":
        x, cache = _hybrid_forward(params, x, cfg, collect_cache)
        return L.rmsnorm(x, params["final_ln"]), aux, cache
    else:  # ssm
        body = _maybe_remat(_mamba_body, cfg, x)
        for i in range(cfg.n_layers):
            x, tails = body(_layer(params, i), x, cfg)
            parts.append(tails)
        names = ("conv", "ssm")
    cache = None
    if collect_cache:
        cache = {name: torch.stack([t[j] for t in parts])
                 for j, name in enumerate(names)}
    return L.rmsnorm(x, params["final_ln"]), aux, cache


def _shared_block(shared: dict, x: torch.Tensor, gate: torch.Tensor,
                  cfg: ModelConfig, positions: torch.Tensor):
    """The hybrid family's shared attention + gated MLP block at one
    super-layer, both halves scaled by its gate; the attention windowed by
    ``cfg.window``. Returns (x, (k, v))."""
    g = gate.to(x.dtype)
    attn, kv = L.self_attention(shared, L.rmsnorm(x, shared["ln1"]), cfg,
                                window=cfg.window, positions=positions)
    x = x + g * attn
    x = x + g * L.gated_mlp(shared, L.rmsnorm(x, shared["ln2"]), cfg.cim)
    return x, kv


def _body_layer(params: dict, s: int, j: int) -> dict:
    return {k: v[s, j] for k, v in params["layers_body"].items()}


def _tail_layer(params: dict, i: int) -> dict:
    return {k: v[i] for k, v in params["layers_tail"].items()}


def _hybrid_forward(params: dict, x: torch.Tensor, cfg: ModelConfig,
                    collect_cache: bool):
    """The hybrid family's full-sequence forward: each super-layer's mamba
    blocks, then the shared block; then the tail's mamba blocks. Returns
    (x, cache-or-None)."""
    n_super, n_tail = _hybrid_split(cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    mamba = _maybe_remat(_mamba_body, cfg, x)
    shared = _maybe_remat(_shared_block, cfg, x)
    tails, kvs, tail_tails = [], [], []
    for s in range(n_super):
        row = []
        for j in range(cfg.attn_every):
            x, t = mamba(_body_layer(params, s, j), x, cfg)
            row.append(t)
        tails.append(row)
        x, kv = shared(params["shared_attn"], x, params["attn_gate"][s], cfg,
                       positions)
        kvs.append(kv)
    for i in range(n_tail):
        x, t = mamba(_tail_layer(params, i), x, cfg)
        tail_tails.append(t)
    if not collect_cache:
        return x, None
    grid = lambda j: torch.stack([torch.stack([t[j] for t in row])
                                  for row in tails])
    cache = {"conv": grid(0), "ssm": grid(1),
             "k": torch.stack([kv[0] for kv in kvs]),
             "v": torch.stack([kv[1] for kv in kvs])}
    if n_tail:
        cache["conv_tail"] = torch.stack([t[0] for t in tail_tails])
        cache["ssm_tail"] = torch.stack([t[1] for t in tail_tails])
    return x, cache


def train_loss(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Next-token CE + 0.01 aux (the moe family's load-balancing loss
    summed over layers, 0 for the others). batch: tokens (B,S) [,
    patch_embeds (vlm), loss_mask (B,S)]; padded vocab columns are masked
    before the softmax."""
    hidden, aux, _ = forward_hidden(params, batch, cfg)
    if cfg.family == "vlm":  # the patches prepend; labels cover text only
        hidden = hidden[:, batch["patch_embeds"].shape[1]:, :]
    logits = L.logits_out(_head(params), hidden, cfg.cim)
    if cfg.vocab_eff != cfg.vocab:
        pad = torch.arange(cfg.vocab_eff, device=logits.device) >= cfg.vocab
        logits = torch.where(pad, L.NEG_INF, logits.float())
    labels = batch["tokens"][:, 1:]
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = mask[:, 1:]
    return L.cross_entropy(logits[:, :-1, :], labels, mask) + 0.01 * aux


def prefill(params: dict, batch: dict, cfg: ModelConfig):
    """Returns (last-position logits (B,V), cache dict with ``pos``)."""
    hidden, _, cache = forward_hidden(params, batch, cfg, collect_cache=True)
    logits = L.logits_out(_head(params), hidden[:, -1:, :],
                          cfg.cim)[:, 0, :cfg.vocab]
    cache["pos"] = _prompt_len(batch, cfg)
    return logits, cache


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, dtype=None,
               device: DeviceLike = None) -> dict:
    """Empty decode cache."""
    _check_family(cfg)
    dev = resolve_device(device)
    z = lambda *shape: torch.zeros(shape, dtype=dtype or cfg.param_dtype,
                                   device=dev)
    if cfg.family in ATTENTION:
        shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads_eff,
                 cfg.dh)
        return {"k": z(*shape), "v": z(*shape), "pos": 0}
    di, n, n_h = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    conv = (batch_size, cfg.conv_width - 1, di + 2 * n)
    state = (batch_size, n_h, di // n_h, n)
    if cfg.family == "ssm":
        return {"conv": z(cfg.n_layers, *conv),
                "ssm": z(cfg.n_layers, *state), "pos": 0}
    n_super, n_tail = _hybrid_split(cfg)
    kv = (n_super, batch_size, ring_len(cfg, max_len), cfg.n_kv_heads_eff,
          cfg.dh)
    cache = {"conv": z(n_super, cfg.attn_every, *conv),
             "ssm": z(n_super, cfg.attn_every, *state),
             "k": z(*kv), "v": z(*kv), "pos": 0}
    if n_tail:
        cache["conv_tail"] = z(n_tail, *conv)
        cache["ssm_tail"] = z(n_tail, *state)
    return cache


def ring_len(cfg: ModelConfig, max_len: int) -> int:
    """The hybrid family's shared-attention KV ring for ``max_len``
    positions: the window, or all of them when they fit in it (or there is
    no window)."""
    return min(max_len, cfg.window) if cfg.window else max_len


def ring_cache(cache: dict, kv_len: int) -> dict:
    """The hybrid family's prefill cache as the decode ring of ``kv_len``
    slots, position p's K/V in slot ``p % kv_len``: a prompt that fits is
    padded; of a longer one (past the window) the last ``kv_len`` positions
    are kept, which are exactly those the next token's window reaches. The
    reference keeps the whole prompt there and its decode then attends
    without the window, overwriting the prompt's last position."""
    s = cache["k"].shape[2]
    if s <= kv_len:
        return pad_cache(cache, kv_len)
    out = dict(cache)
    for key in ("k", "v"):
        last = cache[key][:, :, s - kv_len:]
        out[key] = torch.roll(last, (s - kv_len) % kv_len, dims=2
                              ).contiguous()
    return out


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
    if cfg.family in ATTENTION:
        x = decode_layers_dense(
            (_layer(params, i) for i in range(cfg.n_layers)), x, cache, cfg)
    elif cfg.family == "hybrid":
        x = _hybrid_decode(params, cache, x, cfg)
    else:
        _check_family(cfg)
        for i in range(cfg.n_layers):
            x = _mamba_step(_layer(params, i), x, cache["conv"][i],
                            cache["ssm"][i], cfg)
    cache["pos"] += 1
    x = L.rmsnorm(x, params["final_ln"])
    return L.logits_out(_head(params), x, cfg.cim)[:, 0, :cfg.vocab], cache


def decode_layers_dense(layers, x: torch.Tensor, cache: dict,
                        cfg: ModelConfig) -> torch.Tensor:
    """The dense, moe and vlm families' decode over per-layer param dicts
    (``layers``, one per layer, in order): x (B, 1, D) at position
    ``cache["pos"]``, each layer's new K/V written into the contiguous
    cache in place.
    Returns the residual stream after the last layer; ``pos`` is left for
    the caller to advance."""
    pos = cache["pos"]
    windows, thetas = _layer_kind_arrays(cfg)
    pos_b = torch.full((x.shape[0],), pos, dtype=torch.long, device=x.device)
    for i, p in enumerate(layers):
        cfg_l = _with_theta(cfg, thetas[i])
        attn, k, v = L.decode_attention_multi(
            p, L.rmsnorm(x, p["ln1"]), cache["k"][i], cache["v"][i], pos_b,
            cfg_l, window=windows[i])
        cache["k"][i, :, pos] = k[:, 0].to(cache["k"].dtype)
        cache["v"][i, :, pos] = v[:, 0].to(cache["v"].dtype)
        x = x + attn
        x = x + mlp(p, L.rmsnorm(x, p["ln2"]), cfg)[0]
    return x


def _mamba_step(p: dict, x: torch.Tensor, conv: torch.Tensor,
                state: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One mamba2 layer's decode step with its pre-norm and residual; the
    layer's conv tail and SSM state are updated in place."""
    y, c, h = SSM.mamba_decode_step(p, L.rmsnorm(x, p["ln"]), conv, state,
                                    cfg)
    conv.copy_(c)
    state.copy_(h)
    return x + y


def _hybrid_decode(params: dict, cache: dict, x: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """The hybrid family's decode step: the mamba blocks' states in place,
    the shared block's attention over its KV ring
    (``layers.decode_attention(..., ring=True)``, on the decode-attention
    kernel).
    The ring must not outgrow the window (:func:`ring_cache`)."""
    n_super, n_tail = _hybrid_split(cfg)
    pos = cache["pos"]
    if cfg.window and cache["k"].shape[2] > cfg.window:
        raise ValueError(
            f"the shared-attention cache holds {cache['k'].shape[2]} "
            f"positions, more than the window {cfg.window}: make it the "
            "decode ring with ring_cache first")
    shared = params["shared_attn"]
    for s in range(n_super):
        for j in range(cfg.attn_every):
            x = _mamba_step(_body_layer(params, s, j), x,
                            cache["conv"][s, j], cache["ssm"][s, j], cfg)
        g = params["attn_gate"][s].to(x.dtype)
        x = x + g * L.decode_attention(
            shared, L.rmsnorm(x, shared["ln1"]), cache["k"][s],
            cache["v"][s], pos, cfg, ring=True)[0]
        x = x + g * L.gated_mlp(shared, L.rmsnorm(x, shared["ln2"]),
                                cfg.cim)
    for i in range(n_tail):
        x = _mamba_step(_tail_layer(params, i), x, cache["conv_tail"][i],
                        cache["ssm_tail"][i], cfg)
    return x
