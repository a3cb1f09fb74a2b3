"""Self-speculative decoding over two-tier CIM compression.

MARS's CIM-aware sparsity is a knob: the same macro fabric can host the
same weights at different compression points. This module turns that knob
into decode throughput:

  * the DRAFT tier is a second, higher-sparsity BSR packing of the same
    ServingParams - every deployed projection is re-pruned with
    ``core.sparsity.prune_mask_2d`` at ``draft_sparsity``, packed with the
    SAME uniform tile, and stacked (:func:`draft_serving`);
  * the TARGET tier is the existing compressed (or dense) model;
  * :class:`SpecParams` holds both tiers as ``StackedParams`` sharing one
    :class:`~repro_torch.serve.batching.PagedKVCache` layout (tier 0 =
    target KV, tier 1 = draft KV: same block tables, same positions, one
    refcount ledger);
  * :func:`draft_propose` is the draft loop: k greedy proposals over the
    stacked runtime, plus one trailing KV-fill step so the draft cache
    covers every position the target may commit;
  * ``serve.stacked.verify_step`` is the single batched multi-token target
    pass that scores the whole draft run at once.

Exactness contract: greedy acceptance takes the longest prefix of the
draft run that matches the target's own greedy argmaxes, plus the target's
correction token, so the emitted stream equals target-only greedy decode
token for token. The verify pass gives each position the logits a
one-token step gives it, bit for bit (``deployed._paged_pass`` takes its
sums row by row), so within the port the equality is exact. The draft
tier changes only HOW FAST tokens appear, never WHICH.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import deploy as D
from ..core import sparsity as S
from ..core.mapping import BsrWeight, bsr_to_dense
from ..kernels import ops
from ..models.config import ModelConfig
from . import deployed as DP
from . import stacked as ST

DRAFT_FAMILIES = ("reprune", "layerskip")


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative-decode knobs.

    ``k`` draft tokens are proposed per verify. The ``draft`` family picks
    HOW the draft tier is built from the same weights:

      * ``"reprune"`` - a second, higher-sparsity BSR packing
        (:func:`draft_serving`); ``draft_sparsity`` is its pruning target;
      * ``"layerskip"`` - a sublayer subset of the TARGET's own stacked
        envelope (no second packing, no extra weight memory, no draft KV
        tier); ``keep`` is the fraction of sublayer units (attention/MLP,
        2 per layer) the draft executes - :func:`layerskip_masks` drops the
        least important units first, ranked by the packed envelope's own
        per-layer nnz.

    ``adaptive_k`` turns on the per-slot EWMA acceptance tracker
    (:class:`AdaptiveK`): a slot whose smoothed acceptance falls below
    ``collapse_below`` collapses its k to 1 and re-expands through a
    doubling ladder once it recovers past ``expand_above``."""

    k: int = 4
    draft_sparsity: float = 0.9
    draft: str = "reprune"
    keep: float = 0.5
    adaptive_k: bool = True
    ewma: float = 0.35
    collapse_below: float = 0.2
    expand_above: float = 0.6

    def __post_init__(self):
        if self.k < 1:
            raise ValueError("spec: k must be >= 1")
        if not 0.0 <= self.draft_sparsity < 1.0:
            raise ValueError("spec: draft_sparsity must be in [0, 1)")
        if self.draft not in DRAFT_FAMILIES:
            raise ValueError(
                f"spec: draft must be one of {DRAFT_FAMILIES}, "
                f"got {self.draft!r}")
        if not 0.0 < self.keep <= 1.0:
            raise ValueError("spec: keep must be in (0, 1]")
        if not 0.0 < self.ewma <= 1.0:
            raise ValueError("spec: ewma must be in (0, 1]")
        if not (0.0 <= self.collapse_below <= self.expand_above <= 1.0):
            raise ValueError(
                "spec: need 0 <= collapse_below <= expand_above <= 1 "
                "(the hysteresis band)")

    @property
    def knob(self) -> float:
        """The family's draft knob: re-prune sparsity or layer-skip keep."""
        return self.draft_sparsity if self.draft == "reprune" else self.keep


@dataclasses.dataclass
class SpecParams:
    """Two-tier stacked serving weights: the compressed/dense ``target``
    and the higher-sparsity ``draft`` (None for the layerskip family, whose
    draft IS a sublayer subset of the target envelope). Both tiers describe
    the same architecture, so one PagedKVCache block layout serves both
    caches."""

    target: ST.StackedParams
    draft: Optional[ST.StackedParams] = None

    def __post_init__(self):
        if self.draft is None:
            return
        if self.target.n_layers != self.draft.n_layers:
            raise ValueError(
                f"spec: target has {self.target.n_layers} layers, draft "
                f"{self.draft.n_layers} - tiers must share the architecture")
        for k, sw in self.draft.packed.items():
            tw = self.target.packed.get(k)
            if tw is not None and tw.tile != sw.tile:
                raise ValueError(
                    f"spec: projection {k!r} packed with tile {sw.tile} in "
                    f"the draft but {tw.tile} in the target - the tiers "
                    "must share one uniform tile")

    @classmethod
    def build(cls, target_sp: DP.ServingParams,
              draft_sp: Optional[DP.ServingParams] = None) -> "SpecParams":
        """Stack both tiers' ServingParams into envelopes (``draft_sp=None``
        for the layer-skip family: one envelope serves both roles)."""
        return cls(target=ST.stack(target_sp),
                   draft=ST.stack(draft_sp) if draft_sp is not None else None)


# ---------------------------------------------------------------------------
# Draft tier construction: re-prune the SAME weights at a higher sparsity
# ---------------------------------------------------------------------------


def _dense_from_packed(p: dict, d_in: int, d_out: int,
                       bits: int) -> np.ndarray:
    """Dequantized dense f32 view of one packed projection dict (host
    side; ``core.mapping.bsr_to_dense`` handles the truncated-packing
    guard). ``pack_for_kernel`` packings carry ONE uniform scale, so
    dequant is a scalar multiply."""
    blocks = p["blocks"].cpu().numpy()
    bk, bn = blocks.shape[2], blocks.shape[3]
    bw = BsrWeight(blocks, p["row_idx"].cpu().numpy(),
                   p["nnz"].cpu().numpy(), bk, bn, d_in, d_out)
    scales = p["scales"].cpu().numpy()
    scale = (float(scales.max()) if scales.size and scales.max() > 0
             else 1.0 / 2.0 ** (bits - 1))
    return bsr_to_dense(bw).astype(np.float32) * scale


def _redeploy_sparser(dw: D.DeployedWeight, draft_sparsity: float
                      ) -> D.DeployedWeight:
    """Re-prune an already-packed projection at a higher sparsity.

    The packed blocks are dequantized to their dense (already quantized)
    values, ``prune_mask_2d`` drops the lowest-norm tiles down to
    ``draft_sparsity``, and the survivors are re-packed with the SAME tile
    on the packing's device. Masking quantized levels with 0/1 keeps the
    surviving blocks' int8 levels identical to the target tier's: the draft
    differs from the target ONLY in which blocks exist. A macro-sharded
    packing is refused: build the draft from the placement-free one and
    shard both tiers afterwards."""
    if dw.mesh is not None:
        raise ValueError(
            "build the draft tier from the placement-free packing and "
            "shard both tiers afterwards (deployed.shard)")
    bk, bn = dw.tile
    packed = []
    for p in dw.packed:
        w = _dense_from_packed(p, dw.d_in, dw.d_out, dw.bits)
        mask = S.prune_mask_2d(torch.from_numpy(w), bk, bn,
                               draft_sparsity).numpy()
        packed.append(ops.pack_for_kernel(torch.from_numpy(w * mask),
                                          bits=dw.bits, bk=bk, bn=bn,
                                          device=p["blocks"].device))
    return D.DeployedWeight(packed, dw.d_in, dw.d_out, dw.bits)


def draft_serving(cfg: ModelConfig, sp: DP.ServingParams,
                  draft_sparsity: float,
                  tile: Optional[Tuple[int, int]] = None
                  ) -> DP.ServingParams:
    """Second, higher-sparsity BSR packing of the same ServingParams.

    Compressed projections are re-pruned (:func:`_redeploy_sparser`) with
    their existing tile; raw (dense-serving) projections run the full
    ``deploy_weight`` pipeline at ``draft_sparsity`` with one uniform tile
    (``tile`` or the model's ``cim_alpha``, fitted network-wide so the
    draft stacks). Dense leaves (embed, norms, the tied-head cache) are
    SHARED BY REFERENCE with the target - two-tier artifacts store them
    once."""
    g, a = tile if tile is not None else (cfg.cim_alpha, cfg.cim_alpha)
    net_tile = D.uniform_fit_tile(DP._projection_shapes(sp), g, a)

    def pack(v):
        if isinstance(v, D.DeployedWeight):
            return _redeploy_sparser(v, draft_sparsity)
        return D.deploy_weight(v, cfg.cim, bk=net_tile[0], bn=net_tile[1],
                               target_sparsity=draft_sparsity)

    layers = []
    for p in sp.layers:
        q = dict(p)
        for proj in DP.PROJECTIONS:
            w = q.get(proj)
            if w is None:
                continue
            if isinstance(w, D.DeployedWeight) or getattr(w, "ndim", 0) == 2:
                q[proj] = pack(w)
        layers.append(q)
    head = pack(sp.head) if sp.head is not None else None
    return DP.ServingParams(embed=sp.embed, final_ln=sp.final_ln,
                            layers=layers, head=head, head_t=sp.head_t,
                            mm_proj=sp.mm_proj)


# ---------------------------------------------------------------------------
# Layer-skip draft family: a sublayer subset of the TARGET's own envelope
# ---------------------------------------------------------------------------


def _block_set(sw: D.StackedWeight, li: int) -> set:
    """The set of live (block-row, block-col) coordinates of layer ``li``
    in a stacked envelope (host side), columns in their logical order: a
    macro-sharded envelope's are in macro order, each projection's by its
    own placement, so they are put back through ``col_inv``."""
    nnz = sw.nnz[li].cpu().numpy()
    ri = sw.row_idx[li].cpu().numpy()
    col = (np.argsort(sw.col_inv[li].cpu().numpy())
           if sw.col_inv is not None else np.arange(nnz.shape[0]))
    return {(int(ri[g, s]), int(col[g]))
            for g in range(nnz.shape[0]) for s in range(int(nnz[g]))}


def _proj_nnz(sxp: ST.StackedParams, name: str, li: int) -> Optional[int]:
    sw = sxp.packed.get(name)
    if sw is None:
        return None  # dense-serving projection: never counts as prunable
    return int(sw.nnz[li].sum().item())


def sublayer_importance(sxp: ST.StackedParams
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-sublayer liveness score from the packed envelope's own nnz.

    Attention is dead when any serial member (q/k/v/o) lost every block,
    and a gated MLP is dead when the gate and up projections keep DISJOINT
    block supports or the down projection is empty. The score is the min
    live-block count along each sublayer's serial chain; dense (un-packed)
    members count as fully live.

    Returns (attn (L,), mlp (L,)) float arrays."""
    L = sxp.n_layers
    attn = np.full(L, np.inf)
    mlp = np.full(L, np.inf)
    for li in range(L):
        serial = [_proj_nnz(sxp, n, li) for n in ("wq", "wk", "wv", "wo")]
        live = [s for s in serial if s is not None]
        if live:
            attn[li] = float(min(live))
        gate, up = sxp.packed.get("w_gate"), sxp.packed.get("w_up")
        parts = []
        if gate is not None and up is not None:
            parts.append(len(_block_set(gate, li) & _block_set(up, li)))
        elif up is not None:
            parts.append(int(up.nnz[li].sum().item()))
        down = _proj_nnz(sxp, "w_down", li)
        if down is not None:
            parts.append(down)
        if parts:
            mlp[li] = float(min(parts))
    return attn, mlp


def layerskip_masks(n_layers: int, keep: float,
                    importance: Optional[Tuple[np.ndarray, np.ndarray]] = None
                    ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Pick which sublayers the layer-skip draft executes.

    ``keep`` is the fraction of the 2L sublayer units (one attention + one
    MLP per layer) kept; at least one unit survives, and the LAST layer's
    attention is never dropped. Units are dropped least-important-first by
    ``importance`` (:func:`sublayer_importance`'s (attn, mlp) pair);
    without a score, the positional prior drops MLPs front-first, then
    attentions front-first.

    Returns (attn_on, mlp_on) 0/1 tuples of length ``n_layers``."""
    L = n_layers
    n_keep = min(2 * L, max(1, int(round(keep * 2 * L))))
    if importance is None:
        attn_imp = np.asarray([2.0 + li / L for li in range(L)])
        mlp_imp = np.asarray([1.0 + li / L for li in range(L)])
    else:
        attn_imp, mlp_imp = (np.asarray(importance[0], np.float64),
                             np.asarray(importance[1], np.float64))
    # (importance, position): least important first, earlier layers first
    units = [(mlp_imp[li], li, "mlp", li) for li in range(L)]
    units += [(attn_imp[li], li, "attn", li) for li in range(L - 1)]
    units.sort(key=lambda u: (u[0], u[1]))
    attn_on = [1] * L
    mlp_on = [1] * L
    for _, _, kind, li in units[: max(0, 2 * L - n_keep)]:
        (attn_on if kind == "attn" else mlp_on)[li] = 0
    return tuple(attn_on), tuple(mlp_on)


def kept_fraction(attn_on: Tuple[int, ...], mlp_on: Tuple[int, ...]) -> float:
    """Fraction of sublayer units the masks execute: the layer-skip
    draft's per-step cost relative to a full target step."""
    total = len(attn_on) + len(mlp_on)
    return (sum(attn_on) + sum(mlp_on)) / max(total, 1)


def _carry(views_k, views_v, pos, t, ks, vs) -> None:
    """Write one step's K/V (L, B, KV, dh) into the gathered views at each
    row's position ``pos + t``, in place (the views are the caller's
    throwaway gather)."""
    rows = torch.arange(views_k.shape[1], device=views_k.device)
    at = (pos + t).long()
    views_k[:, rows, at] = ks.to(views_k.dtype)
    views_v[:, rows, at] = vs.to(views_v.dtype)


def draft_propose_layerskip(target: ST.StackedParams, views_k: torch.Tensor,
                            views_v: torch.Tensor, pos: torch.Tensor,
                            tokens: torch.Tensor, cfg: ModelConfig, k: int,
                            attn_on, mlp_on) -> torch.Tensor:
    """Greedy-propose ``k`` tokens by skipping sublayers of the target.

    Runs ``k`` masked decode steps (``stacked.decode_step_masked``) over
    the TARGET envelope and the TARGET's own committed KV views. In-flight
    KV is carried through the gathered views and thrown away with them:
    the verify pass recomputes exact target KV for every emitted position,
    so nothing here is committed (and no trailing KV-fill step runs).

    Returns proposals (B, k) int32."""
    props = []
    tok = tokens  # (B, 1): each row's pending input token
    for t in range(k):
        logits, ks, vs = ST.decode_step_masked(target, views_k, views_v,
                                               pos + t, tok, cfg,
                                               attn_on, mlp_on)
        _carry(views_k, views_v, pos, t, ks, vs)
        tok = logits.argmax(dim=-1).to(torch.int32)[:, None]
        props.append(tok[:, 0])
    return torch.stack(props, dim=1)


def draft_propose(draft: ST.StackedParams, views_k: torch.Tensor,
                  views_v: torch.Tensor, pos: torch.Tensor,
                  tokens: torch.Tensor, cfg: ModelConfig, k: int):
    """Greedy-propose ``k`` draft tokens per row over the draft-tier views.

    Runs ``k+1`` ``decode_step_paged`` steps over the draft envelope,
    carrying the in-flight KV writes through the gathered views. The extra
    trailing step consumes the last proposal so the returned draft KV
    covers positions ``pos .. pos+k`` - every position the target may
    commit when the whole run is accepted - keeping the draft cache in
    lockstep with the target cache at all acceptance outcomes.

    Returns (proposals (B, k) int32, k_new (L, B, k+1, KV, dh), v_new)."""
    props, ks_all, vs_all = [], [], []
    tok = tokens  # (B, 1): each row's pending input token
    for t in range(k + 1):
        logits, ks, vs = ST.decode_step_paged(draft, views_k, views_v,
                                              pos + t, tok, cfg)
        _carry(views_k, views_v, pos, t, ks, vs)
        ks_all.append(ks)
        vs_all.append(vs)
        tok = logits.argmax(dim=-1).to(torch.int32)[:, None]
        if t < k:
            props.append(tok[:, 0])
    return (torch.stack(props, dim=1), torch.stack(ks_all, dim=2),
            torch.stack(vs_all, dim=2))


def accept_greedy(proposals: np.ndarray, targets: np.ndarray) -> int:
    """Longest greedy-matching prefix: the number of draft tokens (row
    vectors ``proposals`` (k,) vs the target's argmaxes ``targets`` (k,))
    accepted before the first disagreement."""
    a = 0
    while a < len(proposals) and int(proposals[a]) == int(targets[a]):
        a += 1
    return a


@dataclasses.dataclass
class AdaptiveK:
    """Per-slot EWMA acceptance tracker with collapse/recovery hysteresis.

    Every round :meth:`observe` folds the slot's measured acceptance into
    an EWMA (``ewma`` is the newest round's weight). When the smoothed rate
    falls below ``collapse_below`` the slot's k collapses to 1; when it
    recovers past ``expand_above`` k re-expands through a doubling ladder
    (1 -> 2 -> 4 -> ... -> k_max). Between the thresholds k holds. The
    tracker only changes HOW MANY tokens are drafted; acceptance stays the
    greedy-exact rule."""

    k_max: int
    ewma: float = 0.35
    collapse_below: float = 0.2
    expand_above: float = 0.6
    acc: float = dataclasses.field(init=False)
    k: int = dataclasses.field(init=False)
    collapses: int = 0
    expands: int = 0

    def __post_init__(self):
        # optimistic start: at the expand threshold with k wide open
        self.acc = self.expand_above
        self.k = self.k_max

    def observe(self, n_proposed: int, n_accepted: int) -> int:
        """Fold one round's (proposed, accepted) in; returns the slot's
        NEXT round k."""
        if n_proposed > 0:
            rate = n_accepted / n_proposed
            self.acc += self.ewma * (rate - self.acc)
        if self.k > 1 and self.acc < self.collapse_below:
            self.k = 1
            self.collapses += 1
        elif self.k < self.k_max and self.acc >= self.expand_above:
            self.k = min(self.k_max, self.k * 2)
            self.expands += 1
        return self.k


@dataclasses.dataclass
class SpecStats:
    """Host-side acceptance and round-latency telemetry over a serve run.

    ``record`` is called once per ACTIVE SLOT of a round: ``slot_rounds``
    / ``proposed`` / ``accepted`` count slot-rounds, while ``round_k``
    holds each batched round's draft length (``len(round_k)`` counts the
    rounds). ``accept_hist`` buckets the accepted-prefix length per
    slot-round. ``draft_s`` covers the draft gather and propose (fenced on
    the proposals), ``verify_s`` the target gather, the verify pass and the
    argmax transfer; ``round_s`` adds the host-side accept/commit tail."""

    k: int
    draft_sparsity: float
    family: str = "reprune"
    keep: float = 1.0
    slot_rounds: int = 0
    proposed: int = 0
    accepted: int = 0
    emitted: int = 0
    k_collapses: int = 0
    k_expands: int = 0
    accept_hist: dict = dataclasses.field(default_factory=dict)
    round_k: list = dataclasses.field(default_factory=list)
    round_s: list = dataclasses.field(default_factory=list)
    draft_s: list = dataclasses.field(default_factory=list)
    verify_s: list = dataclasses.field(default_factory=list)

    def record(self, n_proposed: int, n_accepted: int,
               n_emitted: int) -> None:
        self.slot_rounds += 1
        self.proposed += n_proposed
        self.accepted += n_accepted
        self.emitted += n_emitted
        self.accept_hist[n_accepted] = self.accept_hist.get(n_accepted, 0) + 1

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0

    @property
    def tokens_per_verify(self) -> float:
        """Emitted tokens per slot-round (= per verify lane)."""
        return self.emitted / self.slot_rounds if self.slot_rounds else 0.0

    @property
    def round_p50_s(self) -> float:
        return float(np.percentile(self.round_s, 50)) if self.round_s else 0.0

    def to_json(self) -> dict:
        per_tok = (self.round_p50_s / max(self.tokens_per_verify, 1e-9)
                   if self.round_s else 0.0)
        out = {
            "k": self.k,
            "family": self.family,
            "draft_sparsity": self.draft_sparsity,
            "keep": self.keep,
            "n_rounds": len(self.round_s),  # batched draft+verify rounds
            "slot_rounds": self.slot_rounds,  # per-active-slot lanes
            "proposed": self.proposed,
            "accepted": self.accepted,
            "acceptance_rate": round(self.acceptance_rate, 4),
            "tokens_per_verify": round(self.tokens_per_verify, 3),
            "spec_accepted_tokens": self.accepted,
            "spec_rejected_tokens": self.proposed - self.accepted,
            "spec_k_collapses": self.k_collapses,
            "spec_k_expands": self.k_expands,
            "accepted_len_hist": [
                self.accept_hist.get(a, 0)
                for a in range(max(self.accept_hist, default=0) + 1)],
            "round_k": list(self.round_k),
            "round_p50_ms": round(self.round_p50_s * 1e3, 3),
            "ms_per_token_p50": round(per_tok * 1e3, 3),
        }
        if self.draft_s:
            d50 = float(np.percentile(self.draft_s, 50))
            v50 = float(np.percentile(self.verify_s, 50))
            out.update({
                "draft_p50_ms": round(d50 * 1e3, 3),
                "verify_p50_ms": round(v50 * 1e3, 3),
                "draft_share": round(d50 / max(d50 + v50, 1e-12), 4),
            })
        return out
