"""Continuous-batching serve loop over (optionally compressed) weights.

One :class:`BatchServer` drives a decode step over a fixed number of
slots: every step decodes all slots in one batched call; a finished request
frees its KV blocks and the freed slot admits the next queued request at
once (continuous batching). ``continuous=False`` is the static baseline:
admission waits until EVERY slot has drained.

Admission reserves worst-case blocks (prompt + max_new) so a mid-stream
request can never deadlock the pool; a request that cannot fit even in an
empty pool is rejected at ``run`` time. With the prefix cache on, an
admission whose prompt shares full blocks with an earlier prompt adopts
them and runs only its suffix, through one multi-token ``verify_step``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.config import ModelConfig
from . import deployed, stacked
from .batching import PagedKVCache, Request, RequestQueue, Slot
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
    queue_wait_s: List[float] = dataclasses.field(default_factory=list)
    prefix: Optional[dict] = None
    n_slots: int = 1

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
        if self.prefix is not None:
            out["prefix"] = self.prefix
        return out


class BatchServer:
    """Slot-based serving engine (continuous or static batching).

    ``engine`` picks the runtime over the SAME weights: ``"loop"`` (per-layer
    packings, the single-layer kernel entry) or ``"scan"`` (the stacked
    envelope, the layer-indexed entry with the layer id on the card). Both
    give bit-identical greedy tokens. ``device=None`` means ``cuda``; the
    serving params must already live on that device."""

    def __init__(self, cfg: ModelConfig, sp: deployed.ServingParams,
                 scfg: Optional[ServeConfig] = None,
                 bcfg: Optional[BatchConfig] = None,
                 continuous: bool = True, engine: str = "loop",
                 device: DeviceLike = None, mesh=None, draft=None,
                 spec=None, tracer=None, metrics=None):
        if engine not in ("loop", "scan"):
            raise NotImplementedError(
                f"engine {engine!r} is not ported yet (loop and scan are)")
        for name, val in (("mesh", mesh), ("draft", draft), ("spec", spec),
                          ("tracer", tracer), ("metrics", metrics)):
            if val is not None:
                raise NotImplementedError(f"{name}= is not ported yet")
        deployed._check_family(cfg)
        self.device = resolve_device(device)
        if sp.embed.device.type != self.device.type:
            raise ValueError(f"serving params live on {sp.embed.device}, "
                             f"the server on {self.device}")
        self.cfg = cfg
        self.sp = sp
        self.engine = engine
        self.scfg = scfg if scfg is not None else ServeConfig()
        self.bcfg = bcfg if bcfg is not None else BatchConfig()
        self.continuous = continuous
        self._params = stacked.stack(sp) if engine == "scan" else sp

    # -- admission ----------------------------------------------------------

    def _worst_blocks(self, req: Request) -> int:
        worst = len(req.prompt) + req.max_new_tokens
        return -(-worst // self.bcfg.block_size)

    def _reserved(self, slots: List[Optional[Slot]], kv: PagedKVCache) -> int:
        """Blocks active slots may still demand beyond what they hold."""
        return sum(max(0, kv.blocks_for(s.worst_positions)
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
            need = wb - len(shared)
            avail = kv.free_blocks - self._reserved(slots, kv)
            if need > avail and self._trie is not None:
                self._trie.evict(need - avail)
                avail = kv.free_blocks - self._reserved(slots, kv)
            if need > avail:
                kv.free_slot(i)  # roll back the adoption
                q.requeue(req)  # backpressure: wait for a drain, keep FIFO
                return
            slots[i] = self._prefill_slot(
                i, req, kv, n_shared=len(shared),
                queue_wait=max(0.0, self._now() - max(req.arrival, 0.0)))

    def _prefill_slot(self, i: int, req: Request, kv: PagedKVCache,
                      queue_wait: float, n_shared: int) -> Slot:
        bs = self.bcfg.block_size
        tlen = len(req.prompt)
        if n_shared:
            logits = self._suffix_prefill(i, req, kv, n_shared)
        else:
            toks = np.pad(req.prompt, (0, (-tlen) % bs))[None]  # (1, S_pad)
            logits, k, v = deployed.prefill_last(
                self._params, torch.from_numpy(toks).to(self.device), tlen,
                self.cfg)
            kv.write_prefill(i, k[:, 0], v[:, 0], tlen)
        if self._trie is not None:
            # register the prompt's full blocks AFTER the KV writes land
            nf = tlen // bs
            if nf:
                self._trie.insert(req.prompt[: nf * bs], kv.tables[i][:nf])
        tok = int(self._sample(logits)[0])
        now = self._now()
        return Slot(req=req, pos=tlen, next_token=tok, out=[tok],
                    t_admit=now, token_times=[now], queue_wait_s=queue_wait,
                    prefix_tokens=n_shared * bs)

    def _suffix_prefill(self, i: int, req: Request, kv: PagedKVCache,
                        n_shared: int) -> torch.Tensor:
        """Prefix-cache hit: positions [0, n_shared*bs) were adopted, so
        only the unshared suffix runs, as ONE multi-token ``verify_step``
        over the slot's gathered view."""
        bs = self.bcfg.block_size
        tlen = len(req.prompt)
        m = n_shared * bs
        t = tlen - m  # >= 1 by the trie's match cap
        t_pad = -(-t // bs) * bs
        kv.ensure(i, tlen)
        toks = torch.from_numpy(np.pad(req.prompt[m:], (0, t_pad - t))[None])
        pos = torch.tensor([m], dtype=torch.int32)
        nv = -(-kv.blocks_for(m + t_pad) // self.bcfg.view_bucket) \
            * self.bcfg.view_bucket
        vk, vv = kv.gather(nv, slots=[i])
        logits, ks, vs = deployed.verify_step(
            self._params, vk, vv, pos.to(self.device), toks.to(self.device),
            self.cfg)
        kv.write_run(i, m, ks[:, 0, :t], vs[:, 0, :t])
        return logits[:, t - 1]

    # -- main loop -----------------------------------------------------------

    def _now(self) -> float:
        return time.monotonic() - self._t0

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        return sample_tokens(logits, self._gen, self.scfg).cpu().numpy()

    def _decode_step(self, slots: List[Optional[Slot]], kv: PagedKVCache,
                     active: List[int]) -> List[tuple]:
        """One single-token decode over all slots; commits the KV and
        returns [(slot index, token), ...] for the active slots."""
        for i in active:
            kv.ensure(i, slots[i].pos + 1)
        nv = max(len(kv.tables[i]) for i in active)
        nv = -(-nv // self.bcfg.view_bucket) * self.bcfg.view_bucket
        views_k, views_v = kv.gather(nv)
        pos = torch.tensor([s.pos if s else 0 for s in slots],
                           dtype=torch.int32)
        toks = torch.tensor([[s.next_token if s else 0] for s in slots],
                            dtype=torch.int32)
        logits, k_new, v_new = deployed.decode_step_paged(
            self._params, views_k, views_v, pos.to(self.device),
            toks.to(self.device), self.cfg)
        pb, off = kv.write_coords([s.pos if s else None for s in slots])
        kv.write_token(pb, off, k_new, v_new)
        sampled = self._sample(logits)
        return [(i, int(sampled[i])) for i in active]

    def run(self, requests: List[Request]) -> ServeReport:
        cfg, bcfg, scfg = self.cfg, self.bcfg, self.scfg
        q = RequestQueue(requests)
        kv = PagedKVCache(cfg, bcfg.n_slots, bcfg.n_blocks, bcfg.block_size,
                          device=self.device)
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
        self._t0 = time.monotonic()

        def finish(i: int) -> None:
            s = slots[i]
            outputs[s.req.rid] = np.asarray(s.out, np.int32)
            ttft.append(s.token_times[0] - max(s.req.arrival, 0.0))
            queue_wait.append(s.queue_wait_s)
            service = max(ttft[-1] - s.queue_wait_s, 0.0)
            (ttft_hit if s.prefix_tokens else ttft_miss).append(service)
            tpot.extend(np.diff(s.token_times).tolist())
            kv.free_slot(i)
            slots[i] = None

        while len(q) or any(s is not None for s in slots):
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
            runs = self._decode_step(slots, kv, active)
            n_steps += 1
            now = self._now()
            for i, tok in runs:
                s = slots[i]
                s.pos += 1
                s.out.append(tok)
                s.token_times.append(now)
                s.next_token = tok
                if s.done or s.next_token == scfg.eos_id:
                    finish(i)

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
            wall_s=self._now(), n_decode_steps=n_steps, ttft_s=ttft,
            tpot_s=tpot, outputs=outputs, kv_stats=kv.stats(),
            queue_wait_s=queue_wait, prefix=prefix, n_slots=bcfg.n_slots)
