"""Compressed serving: model params -> BSR-packed weights on the hot path.

* :class:`ServingParams` holds per-layer serving weights; projection
  leaves are raw tensors (dense serving) or
  :class:`~repro_torch.core.deploy.DeployedWeight` (compressed serving), and
  ``layers.cim_matmul`` dispatches per leaf, so the same forward code serves
  both.
* :func:`compress` runs every 2-D CIM projection (QKV/O, MLP, head) through
  ``deploy_weight``, with the per-projection tiles of a
  :func:`default_schedule` (the MARS mapping search) or one given tile.
* :func:`save_artifact` / :func:`load_artifact` are the offline artifact
  flow: quantize + prune + pack run once, the packed ServingParams lands on
  disk through ``train.checkpoint`` in the reference's format, and a
  serving host boots from the directory without re-packing. Artifacts the
  reference wrote load here, and the reference loads the port's (except
  bf16 leaves, which it cannot read back, its own included).
* The forward functions below are the LOOP runtime: a Python loop over
  per-layer weights. They take any params object with ``embed``,
  ``final_ln``, ``head``/``head_t`` and ``layer_params()``, so the stacked
  runtime (``serve.stacked``) runs the same code over layer-indexed views.
  :func:`model_fns` plugs them into ``serve.Engine``.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..core import deploy as D
from ..device import DeviceLike
from ..models import layers as L
from ..models import registry, transformer
from ..models.config import ModelConfig
from ..sched.executor import NetworkSchedule, schedule_from_search
from ..sched.graph import lm_graph
from ..sched.search import search_mapping
from ..train import checkpoint as ckpt

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


def default_schedule(cfg: ModelConfig, seq_len: int = 128,
                     groups=(16, 32, 64), alphas=(16, 32, 64),
                     sparsity_gs: float = 0.6,
                     uniform: bool = False) -> NetworkSchedule:
    """Mapping search over the model's CIM projection graph (numpy, on the
    host): the returned schedule's per-layer (group, alpha) becomes the
    serving (bk, bn). ``uniform=True`` restricts the search to tiles that
    exactly divide every projection (the stacked-deployment envelope)."""
    graph = lm_graph(cfg, seq_len=seq_len, sparsity_gs=sparsity_gs)
    result = search_mapping(graph, w_bits=cfg.w_bits, a_bits=cfg.a_bits,
                            groups=groups, alphas=alphas, uniform=uniform)
    return schedule_from_search(graph, result, w_bits=cfg.w_bits,
                                a_bits=cfg.a_bits)


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
             schedule: Optional[NetworkSchedule] = None,
             tile: Optional[Tuple[int, int]] = None,
             uniform: bool = False) -> ServingParams:
    """Pack every CIM-mapped 2-D projection for the BSR kernel, on the
    params' device.

    ``schedule`` (from :func:`default_schedule`) supplies each projection's
    tile, keyed ``blk{i}_{proj}``; a projection it does not name (the head:
    ``lm_graph`` has no head node) takes ``tile``, or the model's
    ``cim_alpha`` square. Tiles are clipped per projection to exact
    divisors. ``uniform=True`` packs the whole network (head included)
    with one tile: the schedule's ``uniform_tile`` (or ``tile``) clipped
    once to the largest tile dividing EVERY projection, the envelope
    ``serve.stacked`` requires. ``target_sparsity=0`` packs every block."""
    sp = from_params(cfg, params)
    tiles = {}
    if schedule is not None:
        tiles = {s.name: (s.group, s.alpha) for s in schedule.layers}
    fallback = tile if tile is not None else (cfg.cim_alpha, cfg.cim_alpha)
    if uniform:
        g, a = schedule.uniform_tile if schedule is not None else fallback
        tiles, fallback = {}, D.uniform_fit_tile(_projection_shapes(sp), g, a)

    def pack(name: str, w) -> D.DeployedWeight:
        g, a = tiles.get(name, fallback)
        bk, bn = D.fit_tile(int(w.shape[-2]), int(w.shape[-1]), g, a)
        return D.deploy_weight(w, cfg.cim, bk=bk, bn=bn,
                               target_sparsity=target_sparsity)

    for i, p in enumerate(sp.layers):
        for proj in PROJECTIONS:
            if getattr(p.get(proj), "ndim", 0) == 2:
                p[proj] = pack(f"blk{i}_{proj}", p[proj])
    if sp.head is not None:
        sp.head = pack("head", sp.head)
    return sp


# ---------------------------------------------------------------------------
# Offline serving artifacts: pack once, boot many times
# ---------------------------------------------------------------------------

# Manifest schema version: loaders refuse artifacts NEWER than they
# understand (artifacts saved before versioning carry none and load).
ARTIFACT_SCHEMA = 1


def packed_tiles(sp: ServingParams) -> List[Tuple[int, int]]:
    """Sorted unique (bk, bn) tiles across every deployed projection; one
    element means the packing is uniform (the stacked envelope fits)."""
    return sorted({dw.tile for dw in sp.deployed().values()})


def validate_artifact(path: str, extra: dict, *,
                      arch: Optional[str] = None,
                      family: Optional[str] = None,
                      tile: Optional[Tuple[int, int]] = None) -> None:
    """Check a manifest's extra against what the serving host expects and
    raise with the artifact path and expected vs found. Each check is
    skipped when the expectation or the manifest field is absent, so
    artifacts written before versioning still load."""
    schema = extra.get("schema")
    if schema is not None and int(schema) > ARTIFACT_SCHEMA:
        raise ValueError(
            f"{path}: artifact manifest schema {schema} is newer than this "
            f"host supports ({ARTIFACT_SCHEMA}) - upgrade the serving host "
            "or re-save the artifact")
    if arch is not None and extra.get("arch") not in (None, arch):
        raise ValueError(
            f"{path}: artifact arch mismatch - expected {arch!r}, found "
            f"{extra['arch']!r}")
    if family is not None and extra.get("family") not in (None, family):
        raise ValueError(
            f"{path}: artifact family mismatch - expected {family!r}, "
            f"found {extra['family']!r}")
    if tile is not None and extra.get("tiles"):
        found = [tuple(t) for t in extra["tiles"]]
        if len(found) != 1 or found[0] != tuple(tile):
            raise ValueError(
                f"{path}: artifact tile mismatch - expected uniform "
                f"{tuple(tile)}, found {found} (re-pack with that tile, or "
                "stage a re-jit instead of hot-swapping)")


def _strip_placement(sp: ServingParams) -> ServingParams:
    """Serialization form: no derived tied-head cache. (The port never
    shards a packing, so there is no placement to undo.)"""
    return ServingParams(embed=sp.embed, final_ln=sp.final_ln,
                         layers=sp.layers, head=sp.head, head_t=None)


def save_artifact(path: str, sp: ServingParams, cfg: ModelConfig,
                  extra: Optional[dict] = None,
                  draft: Optional[ServingParams] = None) -> str:
    """Persist a (compressed or dense) ServingParams as a boot-ready
    artifact, atomically, without the tied-head cache (the loader rebuilds
    it). ``draft`` makes it two-tier; dense leaves the tiers share by
    reference are stored once."""
    meta = {"schema": ARTIFACT_SCHEMA, "arch": cfg.name,
            "family": cfg.family, "n_layers": cfg.n_layers,
            "tiles": [list(t) for t in packed_tiles(sp)],
            **(extra or {})}
    clean = _strip_placement(sp)
    if draft is None:
        return ckpt.save_pytree(path, clean, extra=meta)
    meta["two_tier"] = True
    tree = {"target": clean, "draft": _strip_placement(draft)}
    return ckpt.save_pytree(path, tree, extra=meta)


def _rebuild_tied_head(sp: ServingParams) -> ServingParams:
    if sp.head is None and sp.head_t is None:
        sp.head_t = sp.embed.T.contiguous()
    return sp


def load_artifact_tiers(path: str, *, arch: Optional[str] = None,
                        tile: Optional[Tuple[int, int]] = None,
                        device: DeviceLike = None
                        ) -> Tuple[ServingParams, Optional[ServingParams],
                                   dict]:
    """Boot every tier of an artifact from one deserialization pass onto
    ``device`` (None means cuda): (target, draft-or-None, manifest-extra).
    Leaves the tiers share are one tensor on the device. ``arch``/``tile``
    are checked against the manifest before any array is read."""
    probe = load_artifact_extra(path)
    if probe:
        validate_artifact(path, probe, arch=arch, tile=tile)
    tree, manifest = ckpt.load_pytree(path, device=device)
    extra = manifest.get("extra", manifest)
    if isinstance(tree, ServingParams):
        return _rebuild_tied_head(tree), None, extra
    if isinstance(tree, dict) and "target" in tree:
        draft = tree.get("draft")
        return (_rebuild_tied_head(tree["target"]),
                _rebuild_tied_head(draft) if draft is not None else None,
                extra)
    raise TypeError(f"{path}: artifact does not contain ServingParams")


def load_artifact(path: str, tier: str = "target", *,
                  arch: Optional[str] = None,
                  tile: Optional[Tuple[int, int]] = None,
                  device: DeviceLike = None) -> Tuple[ServingParams, dict]:
    """Boot one tier (``"target"``, or ``"draft"`` of a two-tier artifact)
    without re-packing: (sp, manifest-extra)."""
    target, draft, extra = load_artifact_tiers(path, arch=arch, tile=tile,
                                               device=device)
    if tier == "target":
        return target, extra
    if tier == "draft":
        if draft is None:
            raise ValueError(
                f"{path}: artifact has no draft packing - re-save with "
                "save_artifact(..., draft=...) for speculative serving")
        return draft, extra
    raise ValueError(f"{path}: unknown tier {tier!r}")


def load_artifact_extra(path: str) -> dict:
    """Only the manifest-extra of an artifact (no array is read); {} when
    there is no artifact at ``path``."""
    step = ckpt.latest_step(path)
    if step is None:
        return {}
    with open(os.path.join(path, f"step_{step:08d}", "manifest.json")) as f:
        manifest = json.load(f)
    return manifest.get("extra", {}) or {}


def update_artifact_extra(path: str, updates: dict) -> None:
    """Merge ``updates`` into an artifact's manifest-extra, rewriting the
    manifest atomically and leaving the arrays untouched."""
    step = ckpt.latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no artifact at {path}")
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    manifest.setdefault("extra", {}).update(updates)
    tmp = os.path.join(d, ".manifest.json.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, os.path.join(d, "manifest.json"))


# ---------------------------------------------------------------------------
# Forward paths: the LOOP runtime
# ---------------------------------------------------------------------------


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


def prefill(sp, batch: dict, cfg: ModelConfig):
    """Engine-signature prefill: (last-position logits (B, V), contiguous
    cache with ``pos`` the prompt length)."""
    hidden, cache = prefill_hidden(sp, batch, cfg)
    logits = L.logits_out(_head(sp), hidden[:, -1:, :],
                          cfg.cim)[:, 0, : cfg.vocab]
    cache["pos"] = int(batch["tokens"].shape[1])
    return logits, cache


def decode_step(sp, cache: dict, tokens: torch.Tensor, cfg: ModelConfig):
    """Engine-signature decode over a contiguous cache with a scalar
    ``pos``, updated in place; the same math as ``transformer.decode_step``
    (dense branch), layer by layer over ``sp.layer_params()``."""
    x = L.embed(sp.embed, tokens, cfg.param_dtype)
    x = transformer.decode_layers_dense(sp.layer_params(), x, cache, cfg)
    cache["pos"] += 1
    x = L.rmsnorm(x, sp.final_ln)
    return L.logits_out(_head(sp), x, cfg.cim)[:, 0, : cfg.vocab], cache


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


def _paged_pass(sp, views_k: torch.Tensor, views_v: torch.Tensor,
                pos: torch.Tensor, tokens: torch.Tensor, cfg: ModelConfig,
                attn_on=None, mlp_on=None):
    """The multi-token pass over gathered paged views behind
    :func:`verify_step`, :func:`decode_step_paged` and
    :func:`decode_step_masked`. ``attn_on``/``mlp_on`` (host 0/1 per
    layer, None = all on) skip sublayers: a skipped one runs no op at all,
    and a skipped attention returns zero K/V rows. The attention takes its
    sums in an order fixed by each query row (the decode-attention kernel)
    and the norms theirs row by row (``rmsnorm_rows``), so a position's
    logits do not depend on T, the batch or the view's length."""
    x = L.embed(sp.embed, tokens, cfg.param_dtype)  # (B, T, D)
    windows, thetas = transformer._layer_kind_arrays(cfg)
    ks, vs = [], []
    zeros = None
    for i, p in enumerate(sp.layer_params()):
        if attn_on is None or attn_on[i]:
            cfg_l = transformer._with_theta(cfg, thetas[i])
            h = L.rmsnorm_rows(x, p["ln1"])
            attn, kn, vn = L.decode_attention_multi(
                p, h, views_k[i], views_v[i], pos, cfg_l, window=windows[i])
            x = x + attn
        else:
            if zeros is None:
                zeros = views_k.new_zeros(tuple(x.shape[:2])
                                          + tuple(views_k.shape[3:]))
            kn = vn = zeros
        if mlp_on is None or mlp_on[i]:
            h = L.rmsnorm_rows(x, p["ln2"])
            x = x + _mlp(p, h, cfg)
        ks.append(kn)
        vs.append(vn)
    x = L.rmsnorm_rows(x, sp.final_ln)
    logits = L.logits_out(_head(sp), x, cfg.cim)[..., : cfg.vocab]
    return logits, torch.stack(ks), torch.stack(vs)


def verify_step(sp, views_k: torch.Tensor, views_v: torch.Tensor,
                pos: torch.Tensor, tokens: torch.Tensor, cfg: ModelConfig):
    """Batched multi-token pass over gathered paged views.

    ``tokens`` (B, T) are row b's next T input tokens at absolute positions
    ``pos[b] .. pos[b]+T-1``; position t's logits equal, bit for bit, what
    T sequential :func:`decode_step_paged` calls produce. Speculative
    decoding verifies a draft run with it, and the prefix-cache suffix
    pass runs the unshared prompt span through it in one call.

    Returns (logits (B, T, V), k_new (L, B, T, KV, dh), v_new)."""
    return _paged_pass(sp, views_k, views_v, pos, tokens, cfg)


def decode_step_paged(sp, views_k: torch.Tensor, views_v: torch.Tensor,
                      pos: torch.Tensor, tokens: torch.Tensor,
                      cfg: ModelConfig):
    """One continuous-batching decode step over gathered paged-KV views.

    views_k/views_v: (L, B, Sv, KV, dh); pos: (B,) per-slot positions;
    tokens: (B, 1). Returns (logits (B, V), k_new (L, B, KV, dh), v_new)
    for the caller to write back into the block pool."""
    logits, ks, vs = _paged_pass(sp, views_k, views_v, pos, tokens, cfg)
    return logits[:, 0], ks[:, :, 0], vs[:, :, 0]


def decode_step_masked(sp, views_k: torch.Tensor, views_v: torch.Tensor,
                       pos: torch.Tensor, tokens: torch.Tensor,
                       cfg: ModelConfig, attn_on, mlp_on):
    """One decode step over a SUBLAYER SUBSET of the same weights: the
    layer-skip speculative draft's forward. ``attn_on``/``mlp_on`` are
    host 0/1 sequences of length L; a masked-off sublayer launches nothing
    (no projection, no fake-quant, no norm), which stands in for the
    reference's ``lax.cond``. Skipped attentions return zero KV rows;
    nothing reads them, and draft KV is never committed. With every mask on
    it is :func:`decode_step_paged`, bit for bit.

    Same signature and returns as :func:`decode_step_paged` plus the
    masks."""
    logits, ks, vs = _paged_pass(sp, views_k, views_v, pos, tokens, cfg,
                                 attn_on=attn_on, mlp_on=mlp_on)
    return logits[:, 0], ks[:, :, 0], vs[:, :, 0]


def model_fns(cfg: ModelConfig) -> registry.ModelFns:
    """ModelFns whose prefill/decode take a :class:`ServingParams` (or a
    ``serve.stacked.StackedParams``) in place of model params:
    ``serve.Engine(cfg, sp, fns=model_fns(cfg))`` serves compressed (or
    unstacked dense) weights."""
    _check_family(cfg)

    def _no_init(*a, **k):
        raise NotImplementedError(
            "serving params are built from model params (from_params, "
            "compress, stacked.stack), not initialized or trained")

    return registry.ModelFns(init_params=_no_init, train_loss=_no_init,
                             prefill=prefill, decode_step=decode_step,
                             init_cache=transformer.init_cache)
