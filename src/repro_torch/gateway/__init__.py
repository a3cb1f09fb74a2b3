"""repro_torch.gateway - multi-tenant serving over one shared KV block pool.

A :class:`Gateway` fronts several tenants - each a serving artifact bound
into a :class:`TenantRuntime` - behind ONE shared
:class:`~repro_torch.serve.batching.PagedKVCache` on the device:

  * :mod:`tenant` - artifact binding, the hot-swap contract (in place on a
    matching envelope / staged rebuild otherwise / rejected on a KV
    geometry mismatch), the runtime-build counter that witnesses "zero
    rebuilds";
  * :mod:`admission` - the simulator-priced admission controller and the
    deadline / quota / overload shed contract;
  * :mod:`gateway` - the step loop: priority admission, per-tenant decode
    rounds (greedy tokens equal to dedicated single-tenant servers'),
    per-tenant prefix tries over the shared pool, chunked prefill so long
    prompts never stall in-flight decode.

See the README's "Multi-tenant gateway" section for the tenants.json
schema and ``python -m repro_torch.launch.serve --gateway tenants.json``.
"""
from __future__ import annotations

from .admission import (ADMIT, DEFER, SHED,  # noqa: F401
                        AdmissionController, ShedEvent)
from .gateway import (Gateway, GatewayConfig,  # noqa: F401
                      GatewayReport, SwapEvent)
from .tenant import (CompileCounter, TenantRegistry,  # noqa: F401
                     TenantRuntime, TenantSLO, envelope_signature,
                     kv_geometry)

__all__ = [
    "ADMIT", "AdmissionController", "CompileCounter", "DEFER", "Gateway",
    "GatewayConfig", "GatewayReport", "SHED", "ShedEvent", "SwapEvent",
    "TenantRegistry", "TenantRuntime", "TenantSLO", "envelope_signature",
    "kv_geometry",
]
