"""Tenant bindings: a serving artifact bound to the stacked scan runtime.

A tenant is one model behind the gateway: a uniform BSR packing (or dense
serving weights) folded into the stacked runtime (``serve.stacked``), plus
the policy the gateway prices it by - priority, SLO targets, a token-rate
quota, and the sparsity the admission pricer assumes for its requests.

The runtime is eager: there is no jit cache. What a rebuild costs is the
tenant's runtime build, :meth:`TenantRuntime._bind`, which stacks the
packing into a fresh :class:`~repro_torch.serve.stacked.StackedParams`
and records its envelope. :class:`CompileCounter` counts those builds (a
later CUDA-graph runtime adds its captures to the same counter).

Hot-swap contract:

  * **in-place** - the incoming packing's stacked envelope has the SAME
    :func:`envelope_signature` (every tensor's name, shape, dtype and
    device; every packed projection's bits, tile and macro placement) and
    the ModelConfig is equal. ``params`` and ``sp`` are rebound to the new
    stack and nothing is built: the kernels see the shapes they saw, so
    their launch plans are the cached ones. Nothing is copied into the old
    tensors either - ``stack`` shares storage with the caller's
    ServingParams, so writing into it would change a packing the caller
    still holds.
  * **staged** - anything else with the same KV geometry (a different
    uniform tile, dense vs packed): the runtime is rebuilt through
    ``_bind``, and the swap report says so.
  * **rejected** - a packing whose KV geometry (n_layers, KV heads, head
    dim, dtype) differs from the serving one cannot share the gateway's
    block pool, and raises instead of swapping.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from ..core import deploy as D
from ..models.config import ModelConfig
from ..serve import deployed, stacked


@dataclasses.dataclass(frozen=True)
class TenantSLO:
    """Per-tenant service objectives the admission controller gates on.

    ``ttft_ms`` / ``tpot_ms`` are latency targets (p50, reported as
    attainment fractions); ``token_rate`` is an admission quota in
    tokens/s - a tenant over it has its requests DEFERRED (smoothed),
    never shed. Every field is optional: None means no target."""

    ttft_ms: Optional[float] = None
    tpot_ms: Optional[float] = None
    token_rate: Optional[float] = None

    def __post_init__(self):
        if self.token_rate is not None and self.token_rate <= 0:
            raise ValueError(f"token_rate must be > 0, got {self.token_rate}")

    def to_json(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}

    @classmethod
    def from_json(cls, obj: Optional[dict]) -> "TenantSLO":
        obj = obj or {}
        known = {f.name for f in dataclasses.fields(cls)}
        bad = set(obj) - known
        if bad:
            raise ValueError(f"unknown SLO field(s) {sorted(bad)} - "
                             f"expected {sorted(known)}")
        return cls(**obj)


class CompileCounter:
    """Counts BUILDS of a tenant's serving runtime: one per ``_bind`` (a
    fresh stack of a packing). An in-place hot-swap builds nothing, so the
    hot-swap contract is judged by ``n`` staying unchanged after it."""

    __slots__ = ("n",)

    def __init__(self):
        self.n = 0


def _placement(mesh) -> Optional[Tuple[str, ...]]:
    return None if mesh is None else tuple(str(d) for d in mesh.devices)


def _tensor_sig(name: str, t: Optional[torch.Tensor]) -> Tuple:
    if t is None:
        return (name, None)
    return (name, tuple(t.shape), str(t.dtype), str(t.device))


def _leaf_sig(name: str, v) -> Tuple:
    if isinstance(v, D.StackedWeight):
        return ((name, "stacked", v.bits, *v.tile, v.d_in, v.d_out,
                 _placement(v.mesh))
                + tuple(_tensor_sig(f"{name}.{k}", getattr(v, k))
                        for k in ("blocks", "scales", "row_idx", "nnz",
                                  "col_inv")))
    if isinstance(v, D.DeployedWeight):
        return ((name, "deployed", v.bits, *v.tile, v.d_in, v.d_out,
                 _placement(v.mesh), len(v.packed))
                + tuple(_tensor_sig(f"{name}[{i}].{k}", p.get(k))
                        for i, p in enumerate(v.packed)
                        for k in ("blocks", "scales", "row_idx", "nnz",
                                  "col_inv")))
    return _tensor_sig(name, v)


def envelope_signature(params: stacked.StackedParams) -> Tuple:
    """The stacked envelope's structure, in a fixed order: every tensor's
    (name, shape, dtype, device), and every packed projection's bits, tile,
    sizes and macro placement. Two equal signatures give every kernel the
    shapes (so the launch plans) it had: the in-place swap condition."""
    leaves = [("embed", params.embed), ("final_ln", params.final_ln),
              ("head", params.head), ("head_t", params.head_t),
              ("layer_ids", params.layer_ids)]
    leaves += [(f"dense.{k}", params.dense[k]) for k in sorted(params.dense)]
    leaves += [(f"packed.{k}", params.packed[k])
               for k in sorted(params.packed)]
    return tuple(_leaf_sig(n, v) for n, v in leaves)


def kv_geometry(cfg: ModelConfig) -> Tuple:
    """The block-pool shape a config demands: every tenant behind one
    shared :class:`~repro_torch.serve.batching.PagedKVCache` agrees on
    it."""
    return (cfg.n_layers, cfg.n_kv_heads_eff, cfg.dh,
            str(cfg.param_dtype).replace("torch.", ""))


class TenantRuntime:
    """One tenant's serving state and swap machinery."""

    def __init__(self, name: str, cfg: ModelConfig,
                 sp: deployed.ServingParams, priority: int = 0,
                 slo: Optional[TenantSLO] = None, sparsity: float = 0.0,
                 artifact: str = ""):
        if not name:
            raise ValueError("tenant needs a non-empty name")
        deployed._check_family(cfg)
        self.name = name
        self.priority = int(priority)
        self.slo = slo if slo is not None else TenantSLO()
        self.sparsity = float(sparsity)
        self.artifact = artifact
        self.compiles = CompileCounter()
        self.swaps: List[dict] = []
        self._bind(cfg, sp)

    def _bind(self, cfg: ModelConfig, sp: deployed.ServingParams,
              params: Optional[stacked.StackedParams] = None) -> None:
        """Build the runtime: stack ``sp`` (unless ``params`` is its stack
        already) and record the envelope. One build on the counter."""
        tiles = deployed.packed_tiles(sp)
        if len(tiles) > 1:
            raise ValueError(
                f"tenant {self.name!r}: packing is non-uniform ({tiles}) - "
                "the gateway serves the stacked scan runtime, which needs "
                "one (bk, bn) for the whole network (pack with "
                "uniform=True)")
        self.cfg = cfg
        self.sp = sp
        self.tile = tiles[0] if tiles else None
        self.params = params if params is not None else stacked.stack(sp)
        self._signature = envelope_signature(self.params)
        self.compiles.n += 1

    @property
    def device(self) -> torch.device:
        return self.sp.embed.device

    @property
    def kv_geometry(self) -> Tuple:
        return kv_geometry(self.cfg)

    def hot_swap(self, sp_new: deployed.ServingParams,
                 cfg_new: Optional[ModelConfig] = None) -> dict:
        """Swap this tenant's weights; returns the swap report
        (mode=inplace|staged, tile, build count at swap time).

        See the module docstring for the in-place / staged / rejected
        contract. The gateway applies swaps BETWEEN steps, so in-flight
        decode rounds always finish on the packing they started on."""
        cfg_new = cfg_new if cfg_new is not None else self.cfg
        if kv_geometry(cfg_new) != self.kv_geometry:
            raise ValueError(
                f"tenant {self.name!r}: hot-swap KV geometry mismatch - "
                f"serving {self.kv_geometry}, incoming "
                f"{kv_geometry(cfg_new)}; the shared block pool cannot be "
                "reshaped mid-run (boot a new gateway for this artifact)")
        params_new = stacked.stack(sp_new)
        inplace = (cfg_new == self.cfg
                   and envelope_signature(params_new) == self._signature)
        if inplace:
            # same envelope: rebind, build nothing, copy into nothing
            self.sp = sp_new
            self.params = params_new
        else:
            self._bind(cfg_new, sp_new, params_new)
        report = {
            "tenant": self.name,
            "mode": "inplace" if inplace else "staged",
            "tile": list(self.tile) if self.tile else None,
            "compiles_at_swap": int(self.compiles.n),
        }
        self.swaps.append(report)
        return report


class TenantRegistry:
    """Ordered name -> :class:`TenantRuntime` map behind one gateway."""

    def __init__(self, tenants: List[TenantRuntime]):
        if not tenants:
            raise ValueError("gateway needs at least one tenant")
        self._tenants: Dict[str, TenantRuntime] = {}
        for t in tenants:
            if t.name in self._tenants:
                raise ValueError(f"duplicate tenant name {t.name!r}")
            self._tenants[t.name] = t
        geo = {t.name: t.kv_geometry for t in tenants}
        if len(set(geo.values())) > 1:
            raise ValueError(
                "tenants cannot share one KV block pool: geometries "
                "(n_layers, kv_heads, dh, dtype) differ - " +
                "; ".join(f"{n}={g}" for n, g in geo.items()))

    def __getitem__(self, name: str) -> TenantRuntime:
        try:
            return self._tenants[name]
        except KeyError:
            raise KeyError(
                f"unknown tenant {name!r} - gateway serves "
                f"{sorted(self._tenants)}") from None

    def __contains__(self, name: str) -> bool:
        return name in self._tenants

    def __iter__(self) -> Iterator[TenantRuntime]:
        return iter(self._tenants.values())

    def __len__(self) -> int:
        return len(self._tenants)

    @property
    def names(self) -> List[str]:
        return list(self._tenants)

    def hot_swap(self, name: str, sp_new: deployed.ServingParams,
                 cfg_new: Optional[ModelConfig] = None) -> dict:
        return self[name].hot_swap(sp_new, cfg_new)
