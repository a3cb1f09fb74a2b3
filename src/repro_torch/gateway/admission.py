"""Admission control: the event-driven simulator as the gateway's gate.

Every request is priced BEFORE any kernel runs - predicted prefill seconds
plus per-decode-token seconds at the tenant's (arch, sparsity), from the
port's ``sched.pricing.Pricer`` (the event-driven simulator, calibrated by
the measured refit constants when given). The controller then applies the

**Overload contract** (checked in this order, nothing silently dropped):

  1. **deadline** - a request whose PREDICTED completion
     (now + prefill + max_new decode steps) misses its deadline is shed
     immediately (``reason="deadline"``): serving it would burn pool and
     steps on an answer nobody is waiting for.
  2. **quota** - a tenant over its ``token_rate`` quota (admitted tokens
     per elapsed second) has its requests DEFERRED: requeued at the front
     of their priority class and retried once the window refills. Quota
     never sheds - it smooths.
  3. **overload** - when the predicted backlog (sum of admitted-but-
     unfinished request prices) would exceed ``max_backlog_s``, the
     request is shed (``reason="overload"``). The request queue pops
     highest-priority-first, so under overload the surviving admissions
     are exactly the highest-priority prefix that fits the backlog
     budget - lower-priority work is shed STRICTLY before higher-priority
     work within every admission wave.
  4. otherwise - **admit**. Pool backpressure (not enough free KV blocks)
     is handled by the gateway after this verdict: the request is
     requeued, never shed, because blocks drain on their own.

Every shed increments ``gateway_shed_total{tenant=,reason=}`` and appends
a :class:`ShedEvent` to the report.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..sched.pricing import Pricer, RequestPrice
from ..serve.batching import Request
from .tenant import TenantRuntime

ADMIT = "admit"
DEFER = "defer"
SHED = "shed"


@dataclasses.dataclass(frozen=True)
class ShedEvent:
    """One shed request: who, why, when."""

    rid: str
    tenant: str
    priority: int
    reason: str  # "deadline" | "overload" | "queue_overflow"
    t: float

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["t"] = round(d["t"], 4)
        return d


class AdmissionController:
    """Simulator-priced admit/defer/shed decisions over a shared backlog."""

    def __init__(self, pricer: Optional[Pricer] = None,
                 max_backlog_s: float = float("inf")):
        self.pricer = pricer if pricer is not None else Pricer()
        self.max_backlog_s = float(max_backlog_s)
        self.backlog_s = 0.0  # predicted seconds of admitted, unfinished work
        self._admitted_tokens: Dict[str, float] = {}
        self.n_admitted = 0
        self.n_deferred = 0
        self.n_shed = 0
        self.shed_events: List[ShedEvent] = []

    def price(self, tenant: TenantRuntime, req: Request) -> RequestPrice:
        return self.pricer.price_request(
            tenant.cfg, len(req.prompt), req.max_new_tokens,
            sparsity_gs=tenant.sparsity)

    def decide(self, tenant: TenantRuntime, req: Request, now: float,
               price: RequestPrice) -> Tuple[str, str]:
        """(verdict, reason) per the overload contract. Pure decision -
        call :meth:`commit` once the gateway actually starts the request
        (pool backpressure may still requeue an ADMIT verdict)."""
        if req.deadline is not None and now + price.total_s > req.deadline:
            return SHED, "deadline"
        quota = tenant.slo.token_rate
        if quota is not None:
            # rate judged over max(elapsed, 1s): a tenant may burst one
            # second's quota up front instead of trickling in from t=0
            rate = ((self._admitted_tokens.get(tenant.name, 0.0)
                     + req.max_new_tokens) / max(now, 1.0))
            if rate > quota:
                return DEFER, "quota"
        if self.backlog_s + price.total_s > self.max_backlog_s:
            return SHED, "overload"
        return ADMIT, "ok"

    def commit(self, tenant: TenantRuntime, req: Request,
               price: RequestPrice) -> None:
        """Account an actually-started request into the backlog/quota."""
        self.backlog_s += price.total_s
        self._admitted_tokens[tenant.name] = (
            self._admitted_tokens.get(tenant.name, 0.0) + req.max_new_tokens)
        self.n_admitted += 1

    def release(self, price: RequestPrice) -> None:
        """A committed request finished: its predicted cost leaves the
        backlog (quota accounting is a rate and never unwinds)."""
        self.backlog_s = max(0.0, self.backlog_s - price.total_s)

    def record_defer(self) -> None:
        self.n_deferred += 1

    def record_shed(self, req: Request, reason: str, now: float) -> ShedEvent:
        ev = ShedEvent(rid=req.rid, tenant=req.tenant,
                       priority=req.priority, reason=reason, t=now)
        self.shed_events.append(ev)
        self.n_shed += 1
        return ev

    def stats(self) -> dict:
        return {
            "calibrated": self.pricer.calibrated,
            "max_backlog_s": (None if self.max_backlog_s == float("inf")
                              else self.max_backlog_s),
            "backlog_s": round(self.backlog_s, 6),
            "n_admitted": self.n_admitted,
            "n_deferred": self.n_deferred,
            "n_shed": self.n_shed,
        }
