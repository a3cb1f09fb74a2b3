"""Continuous-batching serve loop over (optionally compressed) weights.

One :class:`BatchServer` drives a decode step over a fixed number of
slots: every step decodes all slots in one batched call; a finished request
frees its KV blocks and the freed slot admits the next queued request at
once (continuous batching). ``continuous=False`` is the static baseline:
admission waits until EVERY slot has drained.

Admission reserves worst-case blocks (prompt + max_new, plus the
speculative lookahead) so a mid-stream request can never deadlock the
pool; a request that cannot fit even in an empty pool is rejected at
``run`` time. With the prefix cache on, an admission whose prompt shares
full blocks with an earlier prompt adopts them and runs only its suffix,
through one multi-token ``verify_step``.

``tracer``/``metrics`` (``repro_torch.obs``) opt a server into phase spans,
request lifecycle tracks, occupancy gauges and fenced dispatch timing; the
default no-op singletons leave the step untouched.

``mesh=`` (a ``launch.shardings.MacroMesh``) serves over the macro
cluster: pass ``deployed.shard(sp, mesh)`` so the projections run one
launch a macro; the KV views are split by head over the macros where the
macro count divides the KV heads, and then the block pool holds
``n_blocks`` per macro. The loop is the same for 1 and N macros, and so are
the tokens.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..kernels.timing import DispatchTimer
from ..launch.shardings import MacroMesh
from ..models.config import ModelConfig
from ..obs import NULL_METRICS, NULL_TRACER, phase_scope
from . import deployed, stacked
from . import spec as spec_mod
from .batching import PagedKVCache, Request, RequestQueue, Slot, kv_view_spec
from .engine import ServeConfig, sample_tokens
from .prefix import PrefixTrie


@dataclasses.dataclass
class BatchConfig:
    n_slots: int = 4
    block_size: int = 8
    n_blocks: int = 64
    # round the gathered view up to a multiple of this many blocks, so the
    # attention shapes change O(log) times instead of once per block
    view_bucket: int = 2
    idle_wait_s: float = 0.002
    # radix-tree prefix KV reuse (greedy tokens are identical either way)
    prefix_cache: bool = True


def _percentiles(xs: List[float]) -> dict:
    """Latency percentiles; an empty or non-finite trace reports zeros."""
    a = np.asarray([x for x in xs if np.isfinite(x)], np.float64)
    if a.size == 0:
        return {"p50": 0.0, "p99": 0.0, "mean": 0.0}
    return {"p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99)),
            "mean": float(a.mean())}


@dataclasses.dataclass
class ServeReport:
    """Throughput / latency summary of one trace (host clock, each step
    ends in a device sync when its tokens reach the host)."""

    n_requests: int
    total_tokens: int
    wall_s: float
    n_decode_steps: int
    ttft_s: List[float]  # per request
    tpot_s: List[float]  # per decode token, pooled across requests
    outputs: Dict[str, np.ndarray]
    kv_stats: dict
    spec: Optional[dict] = None  # speculative-decode acceptance telemetry
    queue_wait_s: List[float] = dataclasses.field(default_factory=list)
    metrics: Optional[dict] = None  # obs snapshot (instrumented runs only)
    prefix: Optional[dict] = None
    n_slots: int = 1
    # the gateway tenant this report covers ("" = a single-tenant run)
    tenant: str = ""

    @property
    def tokens_per_s(self) -> float:
        if self.total_tokens == 0 or self.wall_s <= 0.0:
            return 0.0
        return self.total_tokens / self.wall_s

    @property
    def slot_efficiency(self) -> float:
        """Fraction of decoded lanes that produced a kept token (prefill
        emits each request's first token, so those don't count)."""
        if self.n_decode_steps == 0 or self.n_slots < 1:
            return 1.0
        return min(1.0, max(0.0, self.total_tokens - self.n_requests)
                   / (self.n_decode_steps * self.n_slots))

    def to_json(self) -> dict:
        service = [max(t - w, 0.0)
                   for t, w in zip(self.ttft_s, self.queue_wait_s)]
        pct = lambda xs: {k: round(v, 5) for k, v in _percentiles(xs).items()}
        out = {
            **({"tenant": self.tenant} if self.tenant else {}),
            "n_requests": self.n_requests,
            "total_tokens": self.total_tokens,
            "wall_s": round(self.wall_s, 4),
            "tokens_per_s": round(self.tokens_per_s, 2),
            "n_decode_steps": self.n_decode_steps,
            "slot_efficiency": round(self.slot_efficiency, 4),
            "ttft": pct(self.ttft_s),
            "tpot": pct(self.tpot_s),
            "kv": self.kv_stats,
            "queue_wait": pct(self.queue_wait_s),
            "ttft_service": pct(service),
        }
        if self.spec is not None:
            out["spec"] = self.spec
        if self.metrics is not None:
            out["metrics"] = self.metrics
        if self.prefix is not None:
            out["prefix"] = self.prefix
        return out


class BatchServer:
    """Slot-based serving engine (continuous or static batching).

    ``engine`` picks the runtime over the SAME weights: ``"loop"`` (per-layer
    packings, the single-layer kernel entry), ``"scan"`` (the stacked
    envelope, the layer-indexed entry with the layer id on the card) or
    ``"spec"`` (self-speculative: a draft proposes up to ``spec.k`` tokens
    over the stacked runtime - the reprune family over a higher-sparsity
    ``draft`` packing, the layerskip family by an nnz-ranked sublayer
    subset of the target's own envelope - and ONE multi-token target
    verify accepts the longest greedy-matching prefix plus a correction
    token). All three give identical greedy tokens; spec is greedy-only.
    ``device=None`` means ``cuda``; the serving params must already live on
    that device. ``mesh`` (a ``MacroMesh`` whose first macro is the params'
    device) turns on macro serving, as the module docstring says."""

    def __init__(self, cfg: ModelConfig, sp: deployed.ServingParams,
                 scfg: Optional[ServeConfig] = None,
                 bcfg: Optional[BatchConfig] = None,
                 continuous: bool = True, engine: str = "loop",
                 device: DeviceLike = None, mesh=None,
                 draft: Optional[deployed.ServingParams] = None,
                 spec: Optional[spec_mod.SpecConfig] = None,
                 tracer=None, metrics=None):
        if engine not in ("loop", "scan", "spec"):
            raise ValueError(
                f"engine must be 'loop', 'scan' or 'spec', got {engine!r}")
        if mesh is not None and not isinstance(mesh, MacroMesh):
            raise NotImplementedError(
                "mesh= takes a launch.shardings.MacroMesh (macro_mesh(n)); "
                f"a {type(mesh).__name__} is not ported")
        if engine != "spec" and (draft is not None or spec is not None):
            raise ValueError(
                f"draft/spec are speculative-decode arguments but engine="
                f"{engine!r} - pass engine='spec' to use them")
        if cfg.family == "vlm":
            raise NotImplementedError(
                "BatchServer serves token-only requests; vlm prefill needs "
                "per-request patch embeddings (use serve.Engine)")
        deployed._check_family(cfg)
        self.device = resolve_device(device)
        if sp.embed.device.type != self.device.type:
            raise ValueError(f"serving params live on {sp.embed.device}, "
                             f"the server on {self.device}")
        if mesh is not None and sp.embed.device != mesh.device:
            raise ValueError(f"serving params live on {sp.embed.device}, "
                             f"the mesh's first macro on {mesh.device}")
        if any(dw.mesh not in (None, mesh)
               for dw in sp.deployed().values()):
            raise ValueError("sp is sharded over another mesh than mesh=")
        self.mesh = mesh
        self.n_devices = mesh.size if mesh is not None else 1
        # the pool scales by the macros only where the KV heads shard
        self._kv_scale = (self.n_devices
                          if kv_view_spec(cfg, mesh) is not None else 1)
        self.cfg = cfg
        self.sp = sp
        self.engine = engine
        self.scfg = scfg if scfg is not None else ServeConfig()
        self.bcfg = bcfg if bcfg is not None else BatchConfig()
        self.continuous = continuous
        self.spec = None
        self.spec_masks = None
        if engine == "spec":
            self.spec = spec if spec is not None else spec_mod.SpecConfig()
            if self.spec.draft == "reprune" and draft is None:
                raise ValueError(
                    "engine='spec' with the reprune family needs a draft "
                    "tier: pass draft=spec.draft_serving(cfg, sp, "
                    "draft_sparsity)")
            if self.spec.draft == "layerskip" and draft is not None:
                raise ValueError(
                    "the layerskip family drafts with a sublayer subset of "
                    "the TARGET envelope - there is no draft packing; drop "
                    "the draft= argument (or pick draft='reprune')")
            if self.scfg.temperature > 0.0:
                raise ValueError(
                    "engine='spec' is greedy-only (temperature=0): the "
                    "accept rule matches draft tokens against the target's "
                    "argmaxes, which is exact only for greedy decode")
            self._params = spec_mod.SpecParams.build(sp, draft)
            self._target = self._params.target
            if self.spec.draft == "layerskip":
                # sublayer masks ranked by the packed envelope's own nnz:
                # sublayers the compression already killed go first
                imp = spec_mod.sublayer_importance(self._target)
                self.spec_masks = spec_mod.layerskip_masks(
                    cfg.n_layers, self.spec.keep, importance=imp)
        else:
            self._params = stacked.stack(sp) if engine == "scan" else sp
            self._target = self._params
        # speculative lookahead: a verify writes KV up to pos+k, so the
        # worst-case reservation covers k extra positions per slot
        self._lookahead = self.spec.k if self.spec is not None else 0
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics if metrics is not None else NULL_METRICS
        self._obs = bool(self.tracer.recording or self.metrics.recording)
        # fenced per-(shape, tile, backend) step wall times, disabled with
        # observability so an un-instrumented run never synchronizes extra
        self.timer = DispatchTimer(enabled=self._obs, metrics=self.metrics)
        dep = sp.deployed()
        self._tile = next(iter(dep.values())).tile if dep else None

    def _phase(self, name: str, **args):
        return phase_scope(self.tracer, self.metrics, name, **args)

    # -- admission ----------------------------------------------------------

    def _worst_blocks(self, req: Request) -> int:
        """Worst-case block demand: prompt + every decode token, plus the
        speculative lookahead (a verify writes candidate KV up to k
        positions past the committed stream)."""
        worst = len(req.prompt) + req.max_new_tokens + self._lookahead
        return -(-worst // self.bcfg.block_size)

    def _reserved(self, slots: List[Optional[Slot]], kv: PagedKVCache) -> int:
        """Blocks active slots may still demand beyond what they hold."""
        return sum(max(0, kv.blocks_for(s.worst_positions + self._lookahead)
                       - len(kv.tables[i]))
                   for i, s in enumerate(slots) if s is not None)

    def _admit(self, q: RequestQueue, slots: List[Optional[Slot]],
               kv: PagedKVCache, now: float) -> None:
        if not self.continuous and any(s is not None for s in slots):
            return  # static policy: only whole-batch admission
        for i in range(self.bcfg.n_slots):
            if slots[i] is not None:
                continue
            req = q.pop_ready(now)
            if req is None:
                return
            wb = self._worst_blocks(req)
            if wb > kv.n_blocks - 1:
                raise ValueError(
                    f"{req.rid}: needs {wb} blocks, pool "
                    f"has {kv.n_blocks - 1} - raise n_blocks/block_size")
            # adopt the matched chain FIRST so eviction below cannot free it
            shared: List[int] = []
            if self._trie is not None:
                shared = self._trie.match(req.prompt)
                if shared:
                    kv.adopt(i, shared)
                if self._obs:
                    self.metrics.counter("prefix_lookups").inc()
                    if shared:
                        self.metrics.counter("prefix_hits").inc()
                        self.metrics.counter("prefix_tokens_reused").inc(
                            len(shared) * self.bcfg.block_size)
            need = wb - len(shared)
            avail = kv.free_blocks - self._reserved(slots, kv)
            if need > avail and self._trie is not None:
                self._trie.evict(need - avail)
                avail = kv.free_blocks - self._reserved(slots, kv)
            if need > avail:
                kv.free_slot(i)  # roll back the adoption
                q.requeue(req)  # backpressure: wait for a drain, keep FIFO
                return
            if self._obs and self._trie is not None:
                self.metrics.gauge("prefix_trie_blocks").set(
                    self._trie.held_blocks())
            slots[i] = self._prefill_slot(
                i, req, kv, n_shared=len(shared),
                queue_wait=max(0.0, self._now() - max(req.arrival, 0.0)))

    def _prefill_slot(self, i: int, req: Request, kv: PagedKVCache,
                      queue_wait: float, n_shared: int) -> Slot:
        with self._phase("prefill", rid=req.rid, slot=i,
                         shared_blocks=n_shared):
            return self._prefill_impl(i, req, kv, queue_wait, n_shared)

    def _draft_tier(self):
        """The reprune family's draft envelope (KV tier 1), else None."""
        return self._params.draft if self.spec is not None else None

    def _prefill_impl(self, i: int, req: Request, kv: PagedKVCache,
                      queue_wait: float, n_shared: int) -> Slot:
        bs = self.bcfg.block_size
        tlen = len(req.prompt)
        if n_shared:
            logits = self._suffix_prefill(i, req, kv, n_shared)
        else:
            toks = torch.from_numpy(
                np.pad(req.prompt, (0, (-tlen) % bs))[None]).to(self.device)
            logits, k, v = deployed.prefill_last(self._target, toks, tlen,
                                                 self.cfg)
            kv.write_prefill(i, k[:, 0], v[:, 0], tlen)
            draft = self._draft_tier()
            if draft is not None:
                # the reprune draft cache starts in lockstep with the
                # target's (its logits are unused: the first token is the
                # target's); the layerskip draft reads the target's own KV
                _, kd, vd = deployed.prefill_last(draft, toks, tlen,
                                                  self.cfg)
                kv.write_prefill(i, kd[:, 0], vd[:, 0], tlen, tier=1)
        if self._trie is not None:
            # register the prompt's full blocks AFTER the KV writes land
            nf = tlen // bs
            if nf:
                self._trie.insert(req.prompt[: nf * bs], kv.tables[i][:nf])
        if self.spec is not None and self.spec.adaptive_k:
            self._adaptive[i] = spec_mod.AdaptiveK(
                k_max=self.spec.k, ewma=self.spec.ewma,
                collapse_below=self.spec.collapse_below,
                expand_above=self.spec.expand_above)
        tok = int(self._sample(logits)[0])
        now = self._now()
        return Slot(req=req, pos=tlen, next_token=tok, out=[tok],
                    t_admit=now, token_times=[now], queue_wait_s=queue_wait,
                    prefix_tokens=n_shared * bs)

    def _suffix_prefill(self, i: int, req: Request, kv: PagedKVCache,
                        n_shared: int) -> torch.Tensor:
        """Prefix-cache hit: positions [0, n_shared*bs) were adopted, so
        only the unshared suffix runs, as ONE multi-token ``verify_step``
        over the slot's gathered view (both tiers for the reprune draft)."""
        bs = self.bcfg.block_size
        tlen = len(req.prompt)
        m = n_shared * bs
        t = tlen - m  # >= 1 by the trie's match cap
        t_pad = -(-t // bs) * bs
        kv.ensure(i, tlen)
        toks = torch.from_numpy(
            np.pad(req.prompt[m:], (0, t_pad - t))[None]).to(self.device)
        pos = torch.tensor([m], dtype=torch.int32).to(self.device)
        nv = -(-kv.blocks_for(m + t_pad) // self.bcfg.view_bucket) \
            * self.bcfg.view_bucket
        vk, vv = kv.gather(nv, slots=[i])
        logits, ks, vs = deployed.verify_step(self._target, vk, vv, pos,
                                              toks, self.cfg)
        kv.write_run(i, m, ks[:, 0, :t], vs[:, 0, :t])
        draft = self._draft_tier()
        if draft is not None:
            dk, dv = kv.gather(nv, tier=1, slots=[i])
            _, kd, vd = deployed.verify_step(draft, dk, dv, pos, toks,
                                             self.cfg)
            kv.write_run(i, m, kd[:, 0, :t], vd[:, 0, :t], tier=1)
        return logits[:, t - 1]

    # -- main loop -----------------------------------------------------------

    def _now(self) -> float:
        return time.monotonic() - self._t0

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        return sample_tokens(logits, self._gen, self.scfg).cpu().numpy()

    def _gather_views(self, slots: List[Optional[Slot]], kv: PagedKVCache,
                      active: List[int], lookahead: int, tier: int = 0):
        """Grow tables to cover this step's writes, then gather a bucketed
        contiguous view of one KV tier."""
        for i in active:
            kv.ensure(i, slots[i].pos + 1 + lookahead)
        nv = max(len(kv.tables[i]) for i in active)
        nv = -(-nv // self.bcfg.view_bucket) * self.bcfg.view_bucket
        return kv.gather(nv, tier=tier)

    def _inputs(self, slots: List[Optional[Slot]]):
        pos = torch.tensor([s.pos if s else 0 for s in slots],
                           dtype=torch.int32)
        toks = torch.tensor([[s.next_token if s else 0] for s in slots],
                            dtype=torch.int32)
        return pos.to(self.device), toks.to(self.device)

    def _decode_step(self, slots: List[Optional[Slot]], kv: PagedKVCache,
                     active: List[int]) -> List[tuple]:
        """One single-token decode over all slots; commits the KV and
        returns [(slot index, [token]), ...] for the active slots."""
        with self._phase("step.gather", n_active=len(active)):
            views_k, views_v = self._gather_views(slots, kv, active, 0)
            # an instrumented gather ends on the device's completion, so
            # the spans partition the step; without observability nothing
            # waits
            if self._obs and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        pos, toks = self._inputs(slots)
        with self._phase("step.dispatch", engine=self.engine):
            logits, k_new, v_new = self.timer.timed(
                f"decode.{self.engine}",
                (int(views_k.shape[1]), int(views_k.shape[2])), self._tile,
                deployed.decode_step_paged, self._params, views_k, views_v,
                pos, toks, self.cfg)
        with self._phase("step.writeback"):
            pb, off = kv.write_coords([s.pos if s else None for s in slots])
            kv.write_token(pb, off, k_new, v_new)
        with self._phase("step.sample"):
            sampled = self._sample(logits)
        return [(i, [int(sampled[i])]) for i in active]

    def _round_k(self, active: List[int]) -> int:
        """This round's draft length: the MAX of the active slots' adaptive
        k (one mispredicting slot never drags the batch down to its
        collapsed k), or the static spec.k with adaptation off."""
        if not self.spec.adaptive_k:
            return self.spec.k
        return max(self._adaptive[i].k for i in active)

    def _spec_step(self, slots: List[Optional[Slot]], kv: PagedKVCache,
                   active: List[int]) -> List[tuple]:
        """One draft-k-verify speculative round over all slots.

        The draft proposes ``k`` tokens per row - the reprune family over
        its own higher-sparsity tier-1 views, the layerskip family by
        skipping sublayers of the TARGET over the tier-0 views; ONE batched
        multi-token ``verify_step`` scores the pending token plus the whole
        draft run on the target. Per slot, the longest prefix of the draft
        run matching the target's own greedy argmaxes is accepted, plus the
        target's correction token. Only the committed entries of the
        candidate KV reach the pool (``write_run``; both tiers for reprune,
        target-only for layerskip) - rejected draft KV never does, which is
        the rollback. Returns [(slot index, tokens), ...] with 1..k+1
        tokens per slot."""
        t_round = time.monotonic()
        k = self._round_k(active)
        draft = self._params.draft
        pos, toks = self._inputs(slots)
        with self._phase("spec.draft", k=k, n_active=len(active)):
            if draft is None:
                dk, dv = self._gather_views(slots, kv, active, k, tier=0)
                props = spec_mod.draft_propose_layerskip(
                    self._target, dk, dv, pos, toks, self.cfg, k,
                    *self.spec_masks)
                d_ks = d_vs = None
            else:
                dk, dv = self._gather_views(slots, kv, active, k, tier=1)
                props, d_ks, d_vs = spec_mod.draft_propose(
                    draft, dk, dv, pos, toks, self.cfg, k)
            del dk, dv
            # the verify consumes the proposals at once: fencing them is
            # nearly free and makes the draft/verify split honest
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        t_draft = time.monotonic()
        with self._phase("spec.verify", k=k, n_active=len(active)):
            tk, tv = self._gather_views(slots, kv, active, k, tier=0)
            logits, t_ks, t_vs = deployed.verify_step(
                self._target, tk, tv, pos, torch.cat([toks, props], dim=1),
                self.cfg)
            del tk, tv
            # greedy targets for every position of the run (B, k+1)
            y = logits.argmax(dim=-1).to(torch.int32).cpu().numpy()
        t_verify = time.monotonic()
        with self._phase("spec.commit"):
            props_np = props.cpu().numpy()
            runs = []
            for i in active:
                s = slots[i]
                a = spec_mod.accept_greedy(props_np[i], y[i, :k])
                emitted = [int(t) for t in y[i, : a + 1]]
                # cap at the request budget and cut at EOS - exactly where
                # sequential decode would have stopped emitting
                emitted = emitted[: s.req.max_new_tokens - len(s.out)]
                if self.scfg.eos_id >= 0 and self.scfg.eos_id in emitted:
                    emitted = emitted[: emitted.index(self.scfg.eos_id) + 1]
                e = len(emitted)
                kv.write_run(i, s.pos, t_ks[:, i, :e], t_vs[:, i, :e])
                if draft is not None:
                    kv.write_run(i, s.pos, d_ks[:, i, :e], d_vs[:, i, :e],
                                 tier=1)
                self._spec_stats.record(n_proposed=k,
                                        n_accepted=min(a, e - 1),
                                        n_emitted=e)
                if self.spec.adaptive_k:
                    # the tracker sees the RAW agreement a/k, not the
                    # budget/EOS-capped commit count
                    ad = self._adaptive[i]
                    k_was = ad.k
                    ad.observe(n_proposed=k, n_accepted=a)
                    if ad.k < k_was:
                        self._spec_stats.k_collapses += 1
                        if self._obs:
                            self.metrics.counter("spec_k_collapses").inc()
                    elif ad.k > k_was:
                        self._spec_stats.k_expands += 1
                runs.append((i, emitted))
                if self._obs:
                    self.metrics.counter("spec_accepted_tokens").inc(
                        min(a, e - 1))
                    self.metrics.counter("spec_rejected_tokens").inc(
                        k - min(a, e - 1))
        self._spec_stats.round_k.append(k)
        self._spec_stats.draft_s.append(t_draft - t_round)
        self._spec_stats.verify_s.append(t_verify - t_draft)
        self._spec_stats.round_s.append(time.monotonic() - t_round)
        return runs

    def run(self, requests: List[Request]) -> ServeReport:
        cfg, bcfg, scfg = self.cfg, self.bcfg, self.scfg
        q = RequestQueue(requests)
        # only the reprune family keeps a second KV tier; the layerskip
        # draft reads the target's own cache
        kv = PagedKVCache(cfg, bcfg.n_slots, bcfg.n_blocks * self._kv_scale,
                          bcfg.block_size, device=self.device,
                          tiers=2 if self._draft_tier() is not None else 1,
                          mesh=self.mesh)
        slots: List[Optional[Slot]] = [None] * bcfg.n_slots
        # the trie lives per run() so traces are independent
        self._trie = PrefixTrie(kv) if bcfg.prefix_cache else None
        self._gen = torch.Generator(device=self.device).manual_seed(scfg.seed)
        outputs: Dict[str, np.ndarray] = {}
        ttft: List[float] = []
        tpot: List[float] = []
        queue_wait: List[float] = []
        ttft_hit: List[float] = []  # service TTFT, split hit vs miss
        ttft_miss: List[float] = []
        n_steps = 0
        self._spec_stats = (spec_mod.SpecStats(self.spec.k,
                                               self.spec.draft_sparsity,
                                               family=self.spec.draft,
                                               keep=self.spec.keep)
                            if self.spec is not None else None)
        # per-slot adaptive-k trackers, created at admission and dropped
        # with the slot (a new request starts from the optimistic prior)
        self._adaptive: Dict[int, spec_mod.AdaptiveK] = {}
        self._t0 = time.monotonic()

        def finish(i: int) -> None:
            s = slots[i]
            outputs[s.req.rid] = np.asarray(s.out, np.int32)
            ttft.append(s.token_times[0] - max(s.req.arrival, 0.0))
            queue_wait.append(s.queue_wait_s)
            service = max(ttft[-1] - s.queue_wait_s, 0.0)
            (ttft_hit if s.prefix_tokens else ttft_miss).append(service)
            tpot.extend(np.diff(s.token_times).tolist())
            if self.tracer.recording:
                # retroactive lifecycle spans: queued -> served, on a queue
                # track plus the slot's own track. Slot clocks are
                # t0-relative; the tracer wants epoch-relative seconds.
                off = self._t0 - self.tracer.epoch
                arr = max(s.req.arrival, 0.0)
                self.tracer.complete(
                    f"queued:{s.req.rid}", off + arr,
                    off + arr + s.queue_wait_s, track="queue", rid=s.req.rid)
                self.tracer.complete(
                    f"req:{s.req.rid}", off + s.t_admit,
                    off + s.token_times[-1], track=f"slot{i}",
                    rid=s.req.rid, tokens=len(s.out))
            self.metrics.counter("requests_finished").inc()
            kv.free_slot(i)
            slots[i] = None
            self._adaptive.pop(i, None)

        while len(q) or any(s is not None for s in slots):
            with self._phase("step.admit"):
                self._admit(q, slots, kv, self._now())
            # a request may be done straight out of prefill (max_new=1/EOS)
            for i, s in enumerate(slots):
                if s is not None and (s.done or s.next_token == scfg.eos_id):
                    finish(i)
            active = [i for i, s in enumerate(slots) if s is not None]
            if not active:
                if len(q):
                    nxt = q.next_arrival()
                    wait = 0.0 if nxt is None else nxt - self._now()
                    if wait > 0:
                        time.sleep(min(wait, bcfg.idle_wait_s))
                continue
            with self._phase("decode_step", step=n_steps,
                             engine=self.engine, n_active=len(active)):
                if self.spec is not None:
                    runs = self._spec_step(slots, kv, active)
                else:
                    runs = self._decode_step(slots, kv, active)
            n_steps += 1
            if self._obs:
                in_use = kv.blocks_in_use
                self.metrics.gauge("slots_active").set(len(active))
                self.metrics.gauge("kv_blocks_in_use").set(in_use)
                self.metrics.gauge("kv_utilization").set(
                    in_use / kv.n_blocks)
                self.metrics.counter("decode_steps").inc()
                self.tracer.counter("serve", slots_active=len(active),
                                    kv_blocks_in_use=in_use)
            now = self._now()
            for i, toks in runs:
                s = slots[i]
                for tok in toks:
                    s.pos += 1
                    s.out.append(tok)
                    s.token_times.append(now)
                    s.next_token = tok
                if s.done or s.next_token == scfg.eos_id:
                    finish(i)

        wall = self._now()
        kv_stats = kv.stats()
        kv_stats["n_devices"] = self.n_devices
        snap = None
        if self._obs:
            snap = self.metrics.snapshot() or None
            disp = self.timer.summary()
            if disp and snap is not None:
                snap["kernel_dispatch"] = disp
        prefix = None
        if self._trie is not None:
            prefix = {k: (round(v, 4) if isinstance(v, float) else v)
                      for k, v in self._trie.stats().items()}
            prefix["cow_copies"] = kv.n_cow
            prefix["ttft_service_hit"] = {
                k: round(v, 5) for k, v in _percentiles(ttft_hit).items()}
            prefix["ttft_service_miss"] = {
                k: round(v, 5) for k, v in _percentiles(ttft_miss).items()}
        return ServeReport(
            n_requests=len(outputs),
            total_tokens=sum(len(o) for o in outputs.values()),
            wall_s=wall, n_decode_steps=n_steps, ttft_s=ttft,
            tpot_s=tpot, outputs=outputs, kv_stats=kv_stats,
            spec=(self._spec_stats.to_json()
                  if self._spec_stats is not None else None),
            queue_wait_s=queue_wait, metrics=snap, prefix=prefix,
            n_slots=bcfg.n_slots)
