"""Whisper-style encoder-decoder backbone (the encdec family).

The conv/mel frontend is a stub, as in the reference: ``frames`` (B,
enc_seq, d_model) are precomputed frame embeddings. The rest is the
whisper transformer: LayerNorm with bias, learned decoder positions
(``MAX_DEC_POS``; later positions clamp to the last), no RoPE anywhere, MHA
(kv == heads), GELU MLP, tied output head.

Parameters keep the reference's pytree layout as a plain dict: ``embed``
(vocab, D), ``pos_dec`` (MAX_DEC_POS, D), ``enc_layers`` (``ln1``, ``attn``,
``ln2``, ``mlp``) and ``dec_layers`` (``ln1``, ``self``, ``lnx``,
``cross``, ``ln2``, ``mlp``) with leaves stacked along a leading layer
axis, ``enc_ln`` and ``dec_ln``; every norm is ``{"g", "b"}``. A decode
cache holds the decoder's self-attention ``k``/``v`` (L,B,S,KV,dh), the
cross-attention ``xk``/``xv`` (L,B,enc_seq,KV,dh) the prefill computed once
from the encoder, and ``pos``, a Python int; ``decode_step`` writes its
tensors in place. The decoder's decode self-attention runs on the
decode-attention kernel (``layers.decode_attention_multi``); the encoder's
bidirectional and every cross attention are plain torch, as the reference
writes them in jnp.
"""
from __future__ import annotations

import torch

from ..device import DeviceLike, resolve_device
from . import layers as L
from .config import ModelConfig

MAX_DEC_POS = 8192  # learned decoder positions; later positions clamp


def _ln_init(d: int, dev: torch.device) -> dict:
    return {"g": torch.ones((d,), dtype=torch.float32, device=dev),
            "b": torch.zeros((d,), dtype=torch.float32, device=dev)}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = None) -> dict:
    """Random parameters drawn from ``generator`` (which must live on
    ``device``), in the reference's tree and scales; the numbers differ
    from its ``jax.random`` stream."""
    dev = resolve_device(device)
    dtype = cfg.param_dtype
    d, dh = cfg.d_model, cfg.dh
    nh, nkv = cfg.n_heads_eff, cfg.n_kv_heads_eff

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=dev) * scale

    def attn():
        s = 1.0 / d ** 0.5
        return {"wq": normal((d, nh * dh), s), "wk": normal((d, nkv * dh), s),
                "wv": normal((d, nkv * dh), s),
                "wo": normal((nh * dh, d), 1.0 / (nh * dh) ** 0.5)}

    def mlp():
        return {"w_up": normal((d, cfg.d_ff), 1.0 / d ** 0.5),
                "w_down": normal((cfg.d_ff, d), 1.0 / cfg.d_ff ** 0.5)}

    def enc_layer():
        return {"ln1": _ln_init(d, dev), "attn": attn(),
                "ln2": _ln_init(d, dev), "mlp": mlp()}

    def dec_layer():
        return {"ln1": _ln_init(d, dev), "self": attn(),
                "lnx": _ln_init(d, dev), "cross": attn(),
                "ln2": _ln_init(d, dev), "mlp": mlp()}

    def stacked(init, n):
        layers = [init() for _ in range(n)]
        return {k: {n2: torch.stack([p[k][n2] for p in layers])
                    for n2 in layers[0][k]} for k in layers[0]}

    return {
        "embed": normal((cfg.vocab, d), 0.02),
        "pos_dec": normal((MAX_DEC_POS, d), 0.01),
        "enc_layers": stacked(enc_layer, cfg.enc_layers),
        "dec_layers": stacked(dec_layer, cfg.n_layers),
        "enc_ln": _ln_init(d, dev),
        "dec_ln": _ln_init(d, dev),
    }


def _ln(x: torch.Tensor, p: dict) -> torch.Tensor:
    return L.layernorm(x, p["g"], p["b"])


def _layer(stack: dict, i: int) -> dict:
    return {k: {n: v[i] for n, v in sub.items()} for k, sub in stack.items()}


def _head(params: dict) -> torch.Tensor:
    return params["embed"].T


def _remat(fn, params: dict, cfg: ModelConfig):
    """A layer under ``cfg.remat == "full"`` (the reference's
    ``jax.checkpoint``) while autograd records the parameters: the
    encoder's input, the stub frames, needs no gradient."""
    return L.maybe_remat(fn, cfg.remat == "full", params["embed"])


def _enc_layer(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = x + L.bidir_attention(p["attn"], _ln(x, p["ln1"]), cfg)
    return x + L.gelu_mlp(p["mlp"], _ln(x, p["ln2"]), cfg.cim)


def encode(params: dict, frames: torch.Tensor, cfg: ModelConfig
           ) -> torch.Tensor:
    """frames (B, T, D), the stub's embeddings -> encoder hidden (B, T, D)."""
    x = frames.to(cfg.param_dtype)
    layer = _remat(_enc_layer, params, cfg)
    for i in range(cfg.enc_layers):
        x = layer(_layer(params["enc_layers"], i), x, cfg)
    return _ln(x, params["enc_ln"])


def _dec_embed(params: dict, tokens: torch.Tensor, pos0: int,
               cfg: ModelConfig) -> torch.Tensor:
    x = L.embed(params["embed"], tokens, cfg.param_dtype)
    pidx = (pos0 + torch.arange(tokens.shape[1], device=tokens.device)
            ).clamp(0, MAX_DEC_POS - 1)
    return x + params["pos_dec"][pidx][None].to(x.dtype)


def _cross_kv(p: dict, enc: torch.Tensor, cfg: ModelConfig):
    """A decoder layer's cross-attention K/V (B, T, KV, dh) over the
    encoder output."""
    b, t, _ = enc.shape
    kx = L.cim_matmul(enc, p["cross"]["wk"], cfg.cim)
    vx = L.cim_matmul(enc, p["cross"]["wv"], cfg.cim)
    return (kx.reshape(b, t, cfg.n_kv_heads_eff, cfg.dh),
            vx.reshape(b, t, cfg.n_kv_heads_eff, cfg.dh))


def _decoder(params: dict, tokens: torch.Tensor, enc: torch.Tensor,
             cfg: ModelConfig):
    """The teacher-forced decoder over the whole sequence. Returns (hidden
    (B, S, D), per layer (k, v, xk, xv))."""
    x = _dec_embed(params, tokens, 0, cfg)
    layer = _remat(_dec_layer, params, cfg)
    kvs = []
    for i in range(cfg.n_layers):
        x, kv = layer(_layer(params["dec_layers"], i), x, enc, cfg)
        kvs.append(kv)
    return _ln(x, params["dec_ln"]), kvs


def _dec_layer(p: dict, x: torch.Tensor, enc: torch.Tensor,
               cfg: ModelConfig):
    """One decoder layer over the whole sequence. Returns (x, (k, v, xk,
    xv))."""
    attn, (k, v) = L.self_attention(p["self"], _ln(x, p["ln1"]), cfg,
                                    use_rope=False)
    x = x + attn
    kx, vx = _cross_kv(p, enc, cfg)
    x = x + L.cross_attention(p["cross"], _ln(x, p["lnx"]), (kx, vx), cfg)
    x = x + L.gelu_mlp(p["mlp"], _ln(x, p["ln2"]), cfg.cim)
    return x, (k, v, kx, vx)


def decode_full(params: dict, tokens: torch.Tensor, enc: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """Teacher-forced decoder over the full sequence (train)."""
    return _decoder(params, tokens, enc, cfg)[0]


def train_loss(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Next-token CE of the decoder. batch: frames (B, T, D), tokens
    (B, S)."""
    enc = encode(params, batch["frames"], cfg)
    hidden = decode_full(params, batch["tokens"], enc, cfg)
    logits = L.logits_out(_head(params), hidden[:, :-1, :], cfg.cim)
    return L.cross_entropy(logits, batch["tokens"][:, 1:])


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, dtype=None,
               device: DeviceLike = None) -> dict:
    """Empty decode cache: self K/V of ``max_len`` positions, cross K/V of
    ``enc_seq``."""
    dev = resolve_device(device)
    z = lambda *shape: torch.zeros(shape, dtype=dtype or cfg.param_dtype,
                                   device=dev)
    lc = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads_eff, cfg.dh)
    xc = (cfg.n_layers, batch_size, cfg.enc_seq, cfg.n_kv_heads_eff, cfg.dh)
    return {"k": z(*lc), "v": z(*lc), "xk": z(*xc), "xv": z(*xc), "pos": 0}


def prefill(params: dict, batch: dict, cfg: ModelConfig):
    """Encode, then the teacher-forced decoder over the prompt. Returns
    (last-position logits (B, V), cache: the prompt's self K/V and the
    cross K/V, ``pos`` the prompt length)."""
    enc = encode(params, batch["frames"], cfg)
    tokens = batch["tokens"]
    hidden, kvs = _decoder(params, tokens, enc, cfg)
    logits = L.logits_out(_head(params), hidden[:, -1:, :], cfg.cim)[:, 0]
    cache = {name: torch.stack([t[j] for t in kvs])
             for j, name in enumerate(("k", "v", "xk", "xv"))}
    cache["pos"] = int(tokens.shape[1])
    return logits, cache


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                cfg: ModelConfig):
    """One decoder token. tokens (B, 1). Returns (logits (B, V), cache):
    each layer's self K/V written at ``pos`` in place, ``pos`` advanced."""
    pos = cache["pos"]
    x = _dec_embed(params, tokens, pos, cfg)
    pos_b = torch.full((x.shape[0],), pos, dtype=torch.long, device=x.device)
    for i in range(cfg.n_layers):
        p = _layer(params["dec_layers"], i)
        attn, k, v = L.decode_attention_multi(
            p["self"], _ln(x, p["ln1"]), cache["k"][i], cache["v"][i], pos_b,
            cfg, use_rope=False)
        cache["k"][i, :, pos] = k[:, 0].to(cache["k"].dtype)
        cache["v"][i, :, pos] = v[:, 0].to(cache["v"].dtype)
        x = x + attn
        xkv = (cache["xk"][i].to(x.dtype), cache["xv"][i].to(x.dtype))
        x = x + L.cross_attention(p["cross"], _ln(x, p["lnx"]), xkv, cfg)
        x = x + L.gelu_mlp(p["mlp"], _ln(x, p["ln2"]), cfg.cim)
    cache["pos"] += 1
    x = _ln(x, params["dec_ln"])
    return L.logits_out(_head(params), x, cfg.cim)[:, 0], cache
