"""The multi-tenant serving gateway: one pool, many tenants.

One :class:`Gateway` fronts several :class:`~repro_torch.gateway.tenant.
TenantRuntime` s behind ONE shared :class:`~repro_torch.serve.batching.
PagedKVCache` block pool on the device - the serving analogue of MARS
fitting many kernel groups onto a fixed macro fabric. The loop composes:

  * **simulator-priced admission** - every request is priced by the
    event-driven simulator (``sched.pricing``) before any kernel runs; the
    :class:`~repro_torch.gateway.admission.AdmissionController` applies the
    deadline/quota/overload contract and sheds strictly lowest priority
    first.
  * **hot-swap** - between steps a tenant's weights can be replaced; a
    matching uniform envelope swaps in place with ZERO runtime builds
    (witnessed by the tenant's build counter, and the kernels' launch plans
    stay cached), anything else rebuilds on a staged path with a report
    line.
  * **disaggregated prefill/decode** - with ``prefill_chunk > 0`` long
    prompts are prefilled in fixed-size chunks (the first through
    ``prefill_last``, continuations through the multi-token
    ``verify_step`` over the gathered view, as the prefix cache's suffix
    prefill), interleaved with decode rounds, so an admission never stalls
    in-flight decodes for more than one chunk. ``prefill_device`` names the
    device index the prefill dispatches run on; a result computed on
    another device than the pool's is moved to the pool's device.

Decode rounds are grouped per tenant and padded to the full slot width, so
every kernel sees the row counts a dedicated server gives it. The unchunked
prefill pads a prompt to a multiple of the block size, and a prefix-hit
suffix pass pads its suffix so, as ``BatchServer`` does. K/V stay on the
device; only the greedy tokens reach the host, once a round.

Greedy only: a temperature > 0 is refused at construction. Greedy decode
is row-independent, which is what makes every tenant's tokens equal to a
dedicated single-tenant ``BatchServer`` (scan runtime) over the same
requests.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import deploy as D
from ..device import DeviceLike, resolve_device
from ..models.config import ModelConfig
from ..obs import NULL_METRICS, NULL_TRACER, ScopedMetrics, phase_scope
from ..serve import deployed, stacked
from ..serve.batching import PagedKVCache, Request, RequestQueue, Slot
from ..serve.engine import ServeConfig, sample_tokens
from ..serve.prefix import PrefixTrie
from ..serve.server import ServeReport, _percentiles
from .admission import DEFER, SHED, AdmissionController
from .tenant import TenantRegistry, TenantRuntime


@dataclasses.dataclass
class GatewayConfig:
    """Pool and step-loop knobs (the multi-tenant BatchConfig)."""

    n_slots: int = 4
    block_size: int = 8
    n_blocks: int = 96
    view_bucket: int = 2
    idle_wait_s: float = 0.002
    # per-tenant radix-tree prefix KV reuse over the SHARED pool; tries
    # are strictly per tenant - one tenant's prompts never match another's
    prefix_cache: bool = True
    # tokens of pending prefill advanced per gateway step (0 = the whole
    # prompt at admission, as BatchServer). With a budget, a long prompt
    # costs each step at most one chunk while decode rounds keep running.
    prefill_chunk: int = 0
    # device index the prefill dispatches run on (None = the pool's)
    prefill_device: Optional[int] = None
    # admission: predicted-backlog ceiling (seconds) and queue bound
    max_backlog_s: float = float("inf")
    max_pending: Optional[int] = None


@dataclasses.dataclass
class SwapEvent:
    """A scheduled mid-run hot-swap: at the top of step ``at_step``,
    tenant ``tenant`` swaps to ``sp`` (and ``cfg`` when given)."""

    at_step: int
    tenant: str
    sp: deployed.ServingParams
    cfg: Optional[ModelConfig] = None


@dataclasses.dataclass
class GatewayReport:
    """Per-tenant ServeReports and the gateway's admission/swap evidence."""

    wall_s: float
    n_steps: int
    per_tenant: Dict[str, ServeReport]
    tenant_meta: Dict[str, dict]  # priority/slo/attainment/goodput/builds
    shed: List[dict]
    swaps: List[dict]
    admission: dict
    kv_stats: dict
    metrics: Optional[dict] = None

    def to_json(self) -> dict:
        """Grouped BY TENANT: each tenant's ServeReport json merged with
        its SLO/attainment/goodput/build evidence."""
        tenants = {}
        for name, rep in self.per_tenant.items():
            tenants[name] = {**rep.to_json(), **self.tenant_meta[name]}
        out = {
            "wall_s": round(self.wall_s, 4),
            "n_steps": self.n_steps,
            "tenants": tenants,
            "shed_events": self.shed,
            "n_shed": len(self.shed),
            "swaps": self.swaps,
            "admission": self.admission,
            "kv": self.kv_stats,
        }
        if self.metrics is not None:
            out["metrics"] = self.metrics
        return out


class _TenantAcc:
    """Per-tenant completion accumulators for the final ServeReport."""

    __slots__ = ("outputs", "ttft", "tpot", "queue_wait", "rounds")

    def __init__(self):
        self.outputs: Dict[str, np.ndarray] = {}
        self.ttft: List[float] = []
        self.tpot: List[float] = []
        self.queue_wait: List[float] = []
        self.rounds = 0


def _to_device(v, dev: torch.device):
    """A copy of serving params (tensors, packed projections, dicts) on
    ``dev``; placement-free params only (the gateway takes no mesh)."""
    if v is None:
        return None
    if isinstance(v, torch.Tensor):
        return v.to(dev)
    if isinstance(v, dict):
        return {k: _to_device(x, dev) for k, x in v.items()}
    if isinstance(v, D.StackedWeight):
        return dataclasses.replace(v, **{
            k: _to_device(getattr(v, k), dev)
            for k in ("blocks", "scales", "row_idx", "nnz", "col_inv")})
    if isinstance(v, D.DeployedWeight):
        return dataclasses.replace(v, packed=[_to_device(p, dev)
                                              for p in v.packed])
    if isinstance(v, stacked.StackedParams):
        return dataclasses.replace(v, **{
            f.name: _to_device(getattr(v, f.name), dev)
            for f in dataclasses.fields(v)})
    return v


class Gateway:
    """Multi-tenant continuous-batching loop over one shared block pool.
    ``device=None`` means ``cuda``; every tenant's params must live on that
    device."""

    def __init__(self, tenants, gcfg: Optional[GatewayConfig] = None,
                 scfg: Optional[ServeConfig] = None,
                 controller: Optional[AdmissionController] = None,
                 pricer=None, tracer=None, metrics=None,
                 device: DeviceLike = None):
        self.tenants = (tenants if isinstance(tenants, TenantRegistry)
                        else TenantRegistry(list(tenants)))
        self.gcfg = gcfg if gcfg is not None else GatewayConfig()
        self.scfg = scfg if scfg is not None else ServeConfig()
        if self.scfg.temperature > 0.0:
            raise ValueError(
                "the gateway is greedy-only (temperature=0): per-tenant "
                "bit-parity with dedicated servers rests on greedy decode "
                "being row-independent")
        if controller is not None and pricer is not None:
            raise ValueError("pass controller OR pricer, not both")
        self.device = resolve_device(device)
        for t in self.tenants:
            if t.device.type != self.device.type:
                raise ValueError(f"tenant {t.name!r}: serving params live "
                                 f"on {t.device}, the gateway on "
                                 f"{self.device}")
        self.controller = controller if controller is not None else \
            AdmissionController(pricer=pricer,
                                max_backlog_s=self.gcfg.max_backlog_s)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics if metrics is not None else NULL_METRICS
        self._obs = bool(self.tracer.recording or self.metrics.recording)
        self._tm = {t.name: ScopedMetrics(self.metrics, tenant=t.name)
                    for t in self.tenants}
        # pool geometry: validated equal across tenants by the registry
        self._pool_cfg = next(iter(self.tenants)).cfg
        self._pool_dev = next(iter(self.tenants)).device
        self._prefill_dev = self._resolve_prefill_device(
            self.gcfg.prefill_device)
        # tenant -> (the params it was copied from, the copy on the
        # prefill device); refreshed when a swap rebinds the params
        self._pf_params: Dict[str, tuple] = {}

    def _resolve_prefill_device(self, index: Optional[int]
                                ) -> Optional[torch.device]:
        """The prefill device, or None for the pool's own."""
        if index is None:
            return None
        if self.device.type != "cuda":
            if index != 0:
                raise ValueError(
                    f"prefill_device={index} but only 1 device(s) visible "
                    f"on {self.device.type}")
            return None
        n = torch.cuda.device_count()
        if index >= n:
            raise ValueError(f"prefill_device={index} but only {n} "
                             "device(s) visible")
        dev = torch.device("cuda", index)
        return None if dev == self._pool_dev else dev

    # -- helpers -------------------------------------------------------------

    def _phase(self, name: str, **args):
        return phase_scope(self.tracer, self.metrics, name, **args)

    def _now(self) -> float:
        return time.monotonic() - self._t0

    def _greedy(self, logits: torch.Tensor) -> np.ndarray:
        return sample_tokens(logits, None, self.scfg).cpu().numpy()

    def _bucket_blocks(self, n_blocks: int) -> int:
        vb = self.gcfg.view_bucket
        return -(-max(1, n_blocks) // vb) * vb

    def _prefill_params(self, rt: TenantRuntime):
        """The tenant's params on the prefill device."""
        if self._prefill_dev is None:
            return rt.params
        src, copy = self._pf_params.get(rt.name, (None, None))
        if src is not rt.params:
            copy = _to_device(rt.params, self._prefill_dev)
            self._pf_params[rt.name] = (rt.params, copy)
        return copy

    def _put_prefill(self, *tensors: torch.Tensor):
        dev = self._prefill_dev or self._pool_dev
        return tuple(t.to(dev) for t in tensors)

    def _to_pool(self, *tensors: torch.Tensor):
        """Prefill results back on the pool's device (a no-op there)."""
        return tuple(t.to(self._pool_dev) for t in tensors)

    # -- admission -----------------------------------------------------------

    def _worst_blocks(self, req: Request, kv: PagedKVCache) -> int:
        return kv.blocks_for(len(req.prompt) + req.max_new_tokens)

    def _reserved(self, slots: List[Optional[Slot]], kv: PagedKVCache) -> int:
        r = 0
        for i, s in enumerate(slots):
            if s is not None:
                r += max(0, kv.blocks_for(s.worst_positions)
                         - len(kv.tables[i]))
        return r

    def _record_shed(self, req: Request, reason: str, now: float) -> None:
        ev = self.controller.record_shed(req, reason, now)
        self.metrics.counter("gateway_shed_total", tenant=req.tenant,
                             reason=reason).inc()
        self._shed.append(ev.to_json())

    def _evict_tries(self, need: int, first: str) -> None:
        """Free cold cached prefixes: the admitting tenant's trie first,
        then the others (pool capacity is shared, so any tenant's cold
        prefixes may go - trie ISOLATION is about matching, not
        residency)."""
        order = [first] + [n for n in self._tries if n != first]
        for name in order:
            if need <= 0:
                return
            need -= self._tries[name].evict(need)

    def _admit(self, q: RequestQueue, slots: List[Optional[Slot]],
               kv: PagedKVCache, now: float) -> bool:
        progressed = False
        for i in range(self.gcfg.n_slots):
            if slots[i] is not None:
                continue
            while True:
                req = q.pop_ready(now)
                if req is None:
                    return progressed
                rt = self.tenants[req.tenant]
                price = self.controller.price(rt, req)
                verdict, reason = self.controller.decide(rt, req, now, price)
                if verdict == SHED:
                    self._record_shed(req, reason, now)
                    progressed = True
                    continue  # this slot tries the next queued request
                if verdict == DEFER:
                    self.controller.record_defer()
                    q.requeue(req)
                    return progressed  # retry next step (head-of-line)
                wb = self._worst_blocks(req, kv)
                if wb > kv.n_blocks - 1:
                    raise ValueError(
                        f"{req.rid} (tenant {req.tenant}): needs {wb} "
                        f"blocks, pool has {kv.n_blocks - 1} - raise "
                        "n_blocks/block_size")
                trie = self._tries.get(req.tenant)
                shared: List[int] = []
                if trie is not None:
                    shared = trie.match(req.prompt)
                    if shared:
                        kv.adopt(i, shared)
                    if self._obs:
                        tm = self._tm[req.tenant]
                        tm.counter("prefix_lookups").inc()
                        if shared:
                            tm.counter("prefix_hits").inc()
                need = wb - len(shared)
                avail = kv.free_blocks - self._reserved(slots, kv)
                if need > avail and self._tries:
                    self._evict_tries(need - avail, req.tenant)
                    avail = kv.free_blocks - self._reserved(slots, kv)
                if need > avail:
                    kv.free_slot(i)  # roll back the adoption
                    q.requeue(req)  # backpressure: wait for a drain
                    return progressed
                self._start_slot(i, rt, req, kv, slots, len(shared),
                                 queue_wait=max(0.0,
                                                now - max(req.arrival, 0.0)))
                self.controller.commit(rt, req, price)
                self._price[i] = price
                progressed = True
                break
        return progressed

    # -- prefill -------------------------------------------------------------

    def _start_slot(self, i: int, rt: TenantRuntime, req: Request,
                    kv: PagedKVCache, slots: List[Optional[Slot]],
                    n_shared: int, queue_wait: float) -> None:
        now = self._now()
        slots[i] = Slot(req=req, pos=len(req.prompt), next_token=-1, out=[],
                        t_admit=now, token_times=[], queue_wait_s=queue_wait,
                        prefix_tokens=n_shared * self.gcfg.block_size)
        self._pf[i] = n_shared * self.gcfg.block_size  # prefilled positions
        self._params_at[i] = rt.params  # the weights its prefill started on
        if self.gcfg.prefill_chunk <= 0:
            # unchunked: the whole prompt lands now (BatchServer behavior)
            with self._phase("prefill", rid=req.rid, tenant=rt.name,
                             slot=i, shared_blocks=n_shared):
                while i in self._pf:
                    self._advance_one(i, rt, kv, slots,
                                      len(req.prompt) - self._pf[i])

    def _advance_prefills(self, slots: List[Optional[Slot]],
                          kv: PagedKVCache) -> bool:
        """Spend this step's chunk budget on pending prefills, oldest
        first. Decode rounds run regardless - the interleaved form of the
        prefill/decode split."""
        budget = self.gcfg.prefill_chunk
        progressed = False
        for i in sorted(self._pf, key=lambda j: slots[j].t_admit):
            if budget <= 0:
                break
            rt = self.tenants[slots[i].req.tenant]
            with self._phase("prefill_chunk", rid=slots[i].req.rid,
                             tenant=rt.name, slot=i):
                budget -= self._advance_one(i, rt, kv, slots, budget)
            progressed = True
        return progressed

    def _advance_one(self, i: int, rt: TenantRuntime, kv: PagedKVCache,
                     slots: List[Optional[Slot]], budget: int) -> int:
        """Advance slot ``i``'s prefill by one chunk (<= budget tokens);
        returns the tokens consumed. Completion emits the first token."""
        s = slots[i]
        prompt = s.req.prompt
        tlen = len(prompt)
        m = self._pf[i]
        chunked = self.gcfg.prefill_chunk > 0
        chunk = self.gcfg.prefill_chunk if chunked else tlen
        take = min(budget, chunk, tlen - m)
        bs = self.gcfg.block_size
        cfg = rt.cfg
        params = self._prefill_params(rt)
        if m == 0:
            # first chunk: the full-prefill path, padded to whole blocks
            s_pad = -(-chunk // bs) * bs
            toks = torch.from_numpy(np.pad(prompt[:take], (0, s_pad - take)))
            (toks,) = self._put_prefill(toks[None])
            logits, k, v = deployed.prefill_last(params, toks, take, cfg)
            last, k, v = self._to_pool(logits, k, v)  # (1, V) at take - 1
            kv.write_prefill(i, k[:, 0], v[:, 0], take)
        else:
            # continuation: ONE multi-token verify pass over the gathered
            # view (a chunk pads to the chunk; a prefix-hit suffix pads to
            # whole blocks, as BatchServer's suffix prefill)
            t_pad = chunk if chunked else -(-take // bs) * bs
            kv.ensure(i, m + take)
            nv = self._bucket_blocks(kv.blocks_for(m + t_pad))
            toks = torch.from_numpy(
                np.pad(prompt[m:m + take], (0, t_pad - take)))[None]
            pos = torch.tensor([m], dtype=torch.int32)
            vk, vv = kv.gather(nv, tier=0, slots=[i])
            args = self._put_prefill(vk, vv, pos, toks)
            logits, ks, vs = deployed.verify_step(params, *args, cfg)
            logits, ks, vs = self._to_pool(logits, ks, vs)
            kv.write_run(i, m, ks[:, 0, :take], vs[:, 0, :take])
            last = logits[:, take - 1]  # (1, V)
        m += take
        self._pf[i] = m
        if m >= tlen:
            del self._pf[i]
            # a prefill that a swap cut across holds K/V of two packings:
            # it is served, but never offered to later prompts
            if self._tries.get(rt.name) is not None \
                    and self._params_at.pop(i) is rt.params:
                nf = tlen // bs
                if nf:
                    self._tries[rt.name].insert(prompt[: nf * bs],
                                                kv.tables[i][:nf])
            tok = int(self._greedy(last)[0])
            now = self._now()
            s.next_token = tok
            s.out.append(tok)
            s.token_times.append(now)
        return take

    # -- decode --------------------------------------------------------------

    def _decode_round(self, rt: TenantRuntime, grp: List[int],
                      slots: List[Optional[Slot]], kv: PagedKVCache) -> None:
        """One greedy decode step for ONE tenant's active slots, padded to
        the full slot width so the kernels' row counts do not depend on
        occupancy. The new K/V go to the pool in one device write."""
        for i in grp:
            kv.ensure(i, slots[i].pos + 1)
        nv = self._bucket_blocks(max(len(kv.tables[i]) for i in grp))
        rows = grp + [grp[-1]] * (self.gcfg.n_slots - len(grp))
        vk, vv = kv.gather(nv, tier=0, slots=rows)
        dev = self._pool_dev
        pos = torch.tensor([slots[i].pos for i in rows], dtype=torch.int32)
        toks = torch.tensor([[slots[i].next_token] for i in rows],
                            dtype=torch.int32)
        with self._phase("decode_round", tenant=rt.name, n_active=len(grp)):
            logits, k_new, v_new = deployed.decode_step_paged(
                rt.params, vk, vv, pos.to(dev), toks.to(dev), rt.cfg)
            pb, off = kv.write_coords(
                [slots[i].pos for i in grp]
                + [None] * (len(rows) - len(grp)), slots=rows)
            kv.write_token(pb, off, k_new, v_new)
            sampled = self._greedy(logits)
        now = self._now()
        for j, i in enumerate(grp):
            s = slots[i]
            tok = int(sampled[j])
            s.pos += 1
            s.out.append(tok)
            s.token_times.append(now)
            s.next_token = tok
        self._acc[rt.name].rounds += 1
        if self._obs:
            self._tm[rt.name].counter("decode_steps").inc()
            self._tm[rt.name].gauge("slots_active").set(len(grp))

    # -- the loop ------------------------------------------------------------

    def run(self, requests: List[Request],
            swaps: Optional[List[SwapEvent]] = None) -> GatewayReport:
        gcfg = self.gcfg
        for r in requests:
            if r.tenant not in self.tenants:
                raise ValueError(
                    f"request {r.rid}: unknown tenant {r.tenant!r} - "
                    f"gateway serves {self.tenants.names}")
        q = RequestQueue(max_pending=gcfg.max_pending)
        self._t0 = time.monotonic()
        self._shed: List[dict] = []
        for r in sorted(requests, key=lambda r: (r.arrival, r.rid)):
            dropped = q.push(r)
            if dropped is not None:
                self._record_shed(dropped, "queue_overflow", 0.0)
        kv = PagedKVCache(self._pool_cfg, gcfg.n_slots, gcfg.n_blocks,
                          gcfg.block_size, device=self._pool_dev)
        self._tries: Dict[str, PrefixTrie] = (
            {t.name: PrefixTrie(kv) for t in self.tenants}
            if gcfg.prefix_cache else {})
        slots: List[Optional[Slot]] = [None] * gcfg.n_slots
        self._pf: Dict[int, int] = {}  # slot -> prefilled positions
        self._params_at: Dict[int, object] = {}
        self._price: Dict[int, object] = {}
        self._acc: Dict[str, _TenantAcc] = {t.name: _TenantAcc()
                                            for t in self.tenants}
        pending_swaps = sorted(swaps or [], key=lambda e: e.at_step)
        swap_reports: List[dict] = []
        step = 0

        def finish(i: int) -> None:
            s = slots[i]
            acc = self._acc[s.req.tenant]
            acc.outputs[s.req.rid] = np.asarray(s.out, np.int32)
            acc.ttft.append(s.token_times[0] - max(s.req.arrival, 0.0))
            acc.queue_wait.append(s.queue_wait_s)
            acc.tpot.extend(np.diff(s.token_times).tolist())
            self._tm[s.req.tenant].counter("requests_finished").inc()
            price = self._price.pop(i, None)
            if price is not None:
                self.controller.release(price)
            kv.free_slot(i)
            slots[i] = None

        while len(q) or any(s is not None for s in slots):
            while pending_swaps and pending_swaps[0].at_step <= step:
                ev = pending_swaps.pop(0)
                rep = self.tenants.hot_swap(ev.tenant, ev.sp, ev.cfg)
                if ev.tenant in self._tries:
                    # its cached prefixes hold K/V of the weights it no
                    # longer serves: no later prompt may adopt them
                    rep["prefix_blocks_dropped"] = \
                        self._tries[ev.tenant].clear()
                rep = {**rep, "at_step": step}
                swap_reports.append(rep)
                print(f"gateway: hot-swap tenant={rep['tenant']} "
                      f"mode={rep['mode']} tile={rep['tile']} "
                      f"at_step={step}")
            progressed = self._admit(q, slots, kv, self._now())
            # finished straight out of prefill (max_new=1 / instant EOS)
            for i, s in enumerate(slots):
                if s is not None and i not in self._pf and (
                        s.done or s.next_token == self.scfg.eos_id):
                    finish(i)
                    progressed = True
            if self._pf:
                progressed |= self._advance_prefills(slots, kv)
            groups: Dict[str, List[int]] = {}
            for i, s in enumerate(slots):
                # a chunked prefill that just completed may already be done
                # (max_new=1 / EOS): it finishes below without decoding
                if s is not None and i not in self._pf and s.token_times \
                        and not (s.done or s.next_token == self.scfg.eos_id):
                    groups.setdefault(s.req.tenant, []).append(i)
            for name in sorted(groups):
                self._decode_round(self.tenants[name], groups[name],
                                   slots, kv)
                progressed = True
            if groups:
                step += 1
            if self._obs:
                self.metrics.gauge("kv_blocks_in_use").set(kv.blocks_in_use)
                self.metrics.gauge("gateway_backlog_s").set(
                    self.controller.backlog_s)
            for i, s in enumerate(slots):
                if s is not None and i not in self._pf and s.token_times \
                        and (s.done or s.next_token == self.scfg.eos_id):
                    finish(i)
            if not progressed and not groups:
                # nothing runnable: wait for the next arrival (or for
                # wall time to refill a quota window)
                nxt = q.next_arrival()
                wait = gcfg.idle_wait_s if nxt is None \
                    else max(nxt - self._now(), 0.0)
                time.sleep(min(max(wait, 1e-4), gcfg.idle_wait_s))

        wall = self._now()
        return self._report(wall, step, kv, swap_reports)

    # -- reporting -----------------------------------------------------------

    def _report(self, wall: float, n_steps: int, kv: PagedKVCache,
                swap_reports: List[dict]) -> GatewayReport:
        per_tenant: Dict[str, ServeReport] = {}
        meta: Dict[str, dict] = {}
        for t in self.tenants:
            acc = self._acc[t.name]
            total = sum(len(o) for o in acc.outputs.values())
            prefix = None
            if t.name in self._tries:
                prefix = {k: (round(v, 4) if isinstance(v, float) else v)
                          for k, v in self._tries[t.name].stats().items()}
            rep = ServeReport(
                n_requests=len(acc.outputs), total_tokens=total,
                wall_s=wall, n_decode_steps=acc.rounds, ttft_s=acc.ttft,
                tpot_s=acc.tpot, outputs=acc.outputs, kv_stats=kv.stats(),
                queue_wait_s=acc.queue_wait, prefix=prefix,
                n_slots=self.gcfg.n_slots, tenant=t.name)
            per_tenant[t.name] = rep
            meta[t.name] = self._tenant_meta(t, rep, wall)
        for srep in swap_reports:
            t = self.tenants[srep["tenant"]]
            srep["recompiles_after_swap"] = (int(t.compiles.n)
                                             - srep["compiles_at_swap"])
        snap = self.metrics.snapshot() or None if self._obs else None
        return GatewayReport(
            wall_s=wall, n_steps=n_steps, per_tenant=per_tenant,
            tenant_meta=meta, shed=self._shed, swaps=swap_reports,
            admission=self.controller.stats(), kv_stats=kv.stats(),
            metrics=snap)

    def _tenant_meta(self, t: TenantRuntime, rep: ServeReport,
                     wall: float) -> dict:
        """SLO attainment and goodput: the per-tenant evidence the overload
        checks read."""
        att: Dict[str, float] = {}
        good_tokens = rep.total_tokens
        if t.slo.ttft_ms is not None and rep.ttft_s:
            target = t.slo.ttft_ms / 1e3
            met = [x <= target for x in rep.ttft_s]
            att["ttft"] = round(sum(met) / len(met), 4)
            att["ttft_p50_ms"] = round(
                _percentiles(rep.ttft_s)["p50"] * 1e3, 3)
            # goodput counts only tokens of requests that met their TTFT
            good_tokens = sum(
                len(o) for ok, o in zip(met, rep.outputs.values()) if ok)
        if t.slo.tpot_ms is not None and rep.tpot_s:
            target = t.slo.tpot_ms / 1e3
            att["tpot"] = round(
                sum(x <= target for x in rep.tpot_s) / len(rep.tpot_s), 4)
        goodput = good_tokens / wall if wall > 0 else 0.0
        return {
            "priority": t.priority,
            "slo": t.slo.to_json() or None,
            "slo_attainment": att or None,
            "goodput_tokens_per_s": round(goodput, 2),
            "compiles": int(t.compiles.n),
        }
