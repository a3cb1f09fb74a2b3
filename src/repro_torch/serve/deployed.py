"""Compressed serving: model params -> BSR-packed weights on the hot path.

* :class:`ServingParams` holds per-layer serving weights; projection
  leaves are raw tensors (dense serving) or
  :class:`~repro_torch.core.deploy.DeployedWeight` (compressed serving), and
  ``layers.cim_matmul`` dispatches per leaf, so the same forward code serves
  both.
* :func:`compress` runs every 2-D CIM projection (QKV/O, MLP, head) through
  ``deploy_weight``.
* The forward functions below are the LOOP runtime: a Python loop over
  per-layer weights. They take any params object with ``embed``,
  ``final_ln``, ``head``/``head_t`` and ``layer_params()``, so the stacked
  runtime (``serve.stacked``) runs the same code over layer-indexed views.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..core import deploy as D
from ..models import layers as L
from ..models import transformer
from ..models.config import ModelConfig

# projections deployed per transformer block
PROJECTIONS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")

SUPPORTED_FAMILIES = ("dense",)


@dataclasses.dataclass
class ServingParams:
    """Per-layer serving weights. ``head_t`` is the tied-embeddings head
    (``embed.T``), built once; None whenever an explicit ``head`` exists."""

    embed: Any
    final_ln: Any
    layers: List[dict]
    head: Any = None
    head_t: Any = None

    def layer_params(self) -> List[dict]:
        return self.layers

    def deployed(self) -> Dict[str, D.DeployedWeight]:
        """Name -> DeployedWeight for every compressed projection."""
        out = {}
        for i, p in enumerate(self.layers):
            for k, v in p.items():
                if isinstance(v, D.DeployedWeight):
                    out[f"blk{i}_{k}"] = v
        if isinstance(self.head, D.DeployedWeight):
            out["head"] = self.head
        return out

    def report(self) -> dict:
        """Table IV-style storage accounting over the deployed projections."""
        return D.deployment_report(self.deployed())


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in SUPPORTED_FAMILIES:
        raise NotImplementedError(
            f"repro_torch serving supports families {SUPPORTED_FAMILIES}, "
            f"not {cfg.family!r}")


def from_params(cfg: ModelConfig, params: dict) -> ServingParams:
    """Unstack model params (leading layer axis) into per-layer dicts,
    without compressing anything."""
    _check_family(cfg)
    layers = [{k: v[i] for k, v in params["layers"].items()}
              for i in range(cfg.n_layers)]
    head = params.get("head")
    return ServingParams(
        embed=params["embed"], final_ln=params["final_ln"], layers=layers,
        head=head,
        head_t=None if head is not None else params["embed"].T.contiguous())


def _projection_shapes(sp: ServingParams) -> List[Tuple[int, int]]:
    """(d_in, d_out) of every 2-D projection compress() packs."""

    def dims(w) -> Optional[Tuple[int, int]]:
        if isinstance(w, D.DeployedWeight):
            return (w.d_in, w.d_out)
        if getattr(w, "ndim", 0) == 2:
            return (int(w.shape[-2]), int(w.shape[-1]))
        return None

    shapes = [dims(p.get(proj)) for p in sp.layers for proj in PROJECTIONS]
    if sp.head is not None:
        shapes.append(dims(sp.head))
    return [s for s in shapes if s is not None]


def compress(cfg: ModelConfig, params: dict,
             target_sparsity: Optional[float] = None,
             tile: Optional[Tuple[int, int]] = None,
             uniform: bool = False) -> ServingParams:
    """Pack every CIM-mapped 2-D projection for the BSR kernel, on the
    params' device.

    ``tile`` (default: the model's ``cim_alpha`` square) is clipped per
    projection to exact divisors; ``uniform=True`` clips it once to the
    largest tile dividing EVERY projection (head included), the envelope
    ``serve.stacked`` requires. ``target_sparsity=0`` packs every block."""
    sp = from_params(cfg, params)
    fallback = tile if tile is not None else (cfg.cim_alpha, cfg.cim_alpha)
    if uniform:
        fallback = D.uniform_fit_tile(_projection_shapes(sp), *fallback)

    def pack(w) -> D.DeployedWeight:
        bk, bn = D.fit_tile(int(w.shape[-2]), int(w.shape[-1]), *fallback)
        return D.deploy_weight(w, cfg.cim, bk=bk, bn=bn,
                               target_sparsity=target_sparsity)

    for p in sp.layers:
        for proj in PROJECTIONS:
            if getattr(p.get(proj), "ndim", 0) == 2:
                p[proj] = pack(p[proj])
    if sp.head is not None:
        sp.head = pack(sp.head)
    return sp


def _head(sp):
    """Output head: explicit, or the build-time transposed tied embedding."""
    if sp.head is not None:
        return sp.head
    return sp.head_t if sp.head_t is not None else sp.embed.T


def _mlp(p: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Dense-family MLP. It is position-independent, so a T-token pass has
    sequential-decode semantics per token as it is."""
    return L.gated_mlp(p, h, cfg.cim)


def prefill_hidden(sp, batch: dict, cfg: ModelConfig):
    """Full-sequence forward. Returns (hidden (B,S,D), cache k/v
    (L,B,S,KV,dh))."""
    x = transformer._embed_inputs({"embed": sp.embed}, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    windows, thetas = transformer._layer_kind_arrays(cfg)
    ks, vs = [], []
    for i, p in enumerate(sp.layer_params()):
        x, (k, v) = transformer._attn_mlp_body(p, x, cfg, windows[i],
                                               thetas[i], positions)
        ks.append(k)
        vs.append(v)
    return L.rmsnorm(x, sp.final_ln), {"k": torch.stack(ks),
                                       "v": torch.stack(vs)}


def prefill_last(sp, tokens: torch.Tensor, true_len: int, cfg: ModelConfig):
    """Prefill for the batch server: ``tokens`` (B, S_pad) may be padded
    past the prompt; logits are taken at ``true_len - 1``. Causality keeps
    the pad positions out of them, and their cache entries sit at positions
    >= true_len, which decode overwrites before it attends to them."""
    hidden, cache = prefill_hidden(sp, {"tokens": tokens}, cfg)
    h_last = hidden[:, int(true_len) - 1]
    logits = L.logits_out(_head(sp), h_last[:, None, :],
                          cfg.cim)[:, 0, : cfg.vocab]
    return logits, cache["k"], cache["v"]


def verify_step(sp, views_k: torch.Tensor, views_v: torch.Tensor,
                pos: torch.Tensor, tokens: torch.Tensor, cfg: ModelConfig):
    """Batched multi-token pass over gathered paged views.

    ``tokens`` (B, T) are row b's next T input tokens at absolute positions
    ``pos[b] .. pos[b]+T-1``; position t's logits equal what T sequential
    :func:`decode_step_paged` calls produce. The prefix-cache suffix pass
    runs the unshared prompt span through this in one call.

    Returns (logits (B, T, V), k_new (L, B, T, KV, dh), v_new)."""
    x = L.embed(sp.embed, tokens, cfg.param_dtype)  # (B, T, D)
    windows, thetas = transformer._layer_kind_arrays(cfg)
    ks, vs = [], []
    for i, p in enumerate(sp.layer_params()):
        cfg_l = transformer._with_theta(cfg, thetas[i])
        h = L.rmsnorm(x, p["ln1"])
        attn, kn, vn = L.decode_attention_multi(
            p, h, views_k[i], views_v[i], pos, cfg_l, window=windows[i])
        x = x + attn
        h = L.rmsnorm(x, p["ln2"])
        x = x + _mlp(p, h, cfg)
        ks.append(kn)
        vs.append(vn)
    x = L.rmsnorm(x, sp.final_ln)
    logits = L.logits_out(_head(sp), x, cfg.cim)[..., : cfg.vocab]
    return logits, torch.stack(ks), torch.stack(vs)


def decode_step_paged(sp, views_k: torch.Tensor, views_v: torch.Tensor,
                      pos: torch.Tensor, tokens: torch.Tensor,
                      cfg: ModelConfig):
    """One continuous-batching decode step over gathered paged-KV views.

    views_k/views_v: (L, B, Sv, KV, dh); pos: (B,) per-slot positions;
    tokens: (B, 1). Returns (logits (B, V), k_new (L, B, KV, dh), v_new)
    for the caller to write back into the block pool."""
    logits, ks, vs = verify_step(sp, views_k, views_v, pos, tokens, cfg)
    return logits[:, 0], ks[:, :, 0], vs[:, :, 0]
