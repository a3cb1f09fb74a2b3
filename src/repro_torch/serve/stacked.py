"""Stacked serving runtime: one uniform envelope per projection.

:func:`stack` folds a :class:`~repro_torch.serve.deployed.ServingParams`
into a :class:`StackedParams`: dense per-layer leaves are stacked along a
leading layer axis and every compressed projection becomes a
:class:`~repro_torch.core.deploy.StackedWeight`. The reference's
``lax.scan`` over the layer index becomes a Python loop over a DEVICE
layer-index tensor: each layer's projections are
:class:`~repro_torch.core.deploy.StackedLayerView` s holding a slice of that
tensor, and the kernel reads the layer id on the card, so a step never
syncs with the host per layer and stays capturable by a CUDA graph.

The forward code is the loop runtime's own (``serve.deployed``), run over
the layer views; for the same ServingParams both runtimes give
bit-identical tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch

from ..core import deploy as D
from . import deployed as DP
from .deployed import (decode_step, decode_step_paged, prefill,
                       prefill_hidden, prefill_last, verify_step)

__all__ = ["StackedParams", "stack", "prefill", "decode_step", "model_fns",
           "prefill_hidden", "prefill_last", "decode_step_paged",
           "verify_step"]


@dataclasses.dataclass
class StackedParams:
    """Layer-stacked serving weights. ``dense`` holds stacked (L, ...)
    leaves that stay on the float path (norm gains, any unpacked
    projection); ``packed`` maps projection name -> StackedWeight;
    ``layer_ids`` is ``arange(L)`` as int32 on the device."""

    embed: Any
    final_ln: Any
    dense: Dict[str, torch.Tensor]
    packed: Dict[str, D.StackedWeight]
    layer_ids: torch.Tensor
    head: Any = None
    head_t: Any = None

    @property
    def n_layers(self) -> int:
        return int(self.layer_ids.shape[0])

    def layer_params(self) -> List[dict]:
        out = []
        for i in range(self.n_layers):
            p = {k: v[i] for k, v in self.dense.items()}
            for k, sw in self.packed.items():
                p[k] = D.StackedLayerView(sw, self.layer_ids[i:i + 1])
            out.append(p)
        return out


def stack(sp: DP.ServingParams) -> StackedParams:
    """ServingParams (per-layer dicts) -> StackedParams. Every projection
    must be packed in all layers or in none, with one uniform tile."""
    if not sp.layers:
        raise ValueError("stack: ServingParams has no layers")
    keys = list(sp.layers[0].keys())
    for i, p in enumerate(sp.layers[1:], 1):
        if list(p.keys()) != keys:
            raise ValueError(
                f"stack: layer {i} keys {sorted(p)} != layer 0 {sorted(keys)}")
    dense: Dict[str, torch.Tensor] = {}
    packed: Dict[str, D.StackedWeight] = {}
    for k in keys:
        vs = [p[k] for p in sp.layers]
        n_packed = sum(isinstance(v, D.DeployedWeight) for v in vs)
        if n_packed == len(vs):
            packed[k] = D.stack_deployed(vs)
        elif n_packed == 0:
            dense[k] = torch.stack(vs)
        else:
            raise ValueError(
                f"stack: projection {k!r} is packed in {n_packed}/{len(vs)} "
                "layers - compress() packs all layers or none")
    layer_ids = torch.arange(len(sp.layers), dtype=torch.int32,
                             device=sp.embed.device)
    return StackedParams(embed=sp.embed, final_ln=sp.final_ln, dense=dense,
                         packed=packed, layer_ids=layer_ids, head=sp.head,
                         head_t=sp.head_t)


# ModelFns over a StackedParams (``serve.Engine(cfg, stack(sp),
# fns=model_fns(cfg))``): the loop runtime's own, run over the layer views
model_fns = DP.model_fns
