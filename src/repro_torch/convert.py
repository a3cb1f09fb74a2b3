"""Carry weights made elsewhere into the port, from numpy and plain Python.

* :func:`params_from_numpy` takes a model-params tree of numpy arrays
  (``embed``, ``final_ln``, ``head``, ``layers`` with stacked leaves), as
  the reference's ``init_params`` output looks after ``np.asarray`` on
  every leaf.
* :func:`serving_params_from_numpy` takes a packed serving tree: ``embed``,
  ``final_ln``, ``head``/``head_t`` and ``layers`` (a list of per-layer
  dicts), where every packed projection is a dict
  ``{"packed": [{"blocks", "scales", "row_idx", "nnz", "density"}, ...],
  "d_in", "d_out", "bits"}``. Serving the int8 packing carried across is
  exact: no level is recomputed.

bfloat16 arrays arrive as the ml_dtypes ``bfloat16`` numpy type, which
``torch.from_numpy`` rejects; they cross through a ``uint16`` view.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .core.deploy import DeployedWeight
from .device import DeviceLike, resolve_device
from .models.config import ModelConfig
from .serve.deployed import ServingParams


def tensor_from_numpy(a, device: torch.device) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _tree(x, device: torch.device) -> Any:
    if x is None:
        return None
    if isinstance(x, dict) and "packed" in x:
        packed = [{k: (float(v) if k == "density"
                       else tensor_from_numpy(v, device))
                   for k, v in p.items()} for p in x["packed"]]
        return DeployedWeight(packed, int(x["d_in"]), int(x["d_out"]),
                              int(x["bits"]))
    if isinstance(x, dict):
        return {k: _tree(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree(v, device) for v in x]
    return tensor_from_numpy(x, device)


def params_from_numpy(tree: dict, cfg: ModelConfig,
                      device: DeviceLike = None) -> dict:
    """Model params (numpy leaves) -> the port's params dict on ``device``."""
    dev = resolve_device(device)
    params = _tree(tree, dev)
    for k in params["layers"].values():
        if k.shape[0] != cfg.n_layers:
            raise ValueError(f"layer stack of {k.shape[0]} != n_layers "
                             f"{cfg.n_layers}")
    return params


def serving_params_from_numpy(tree: dict, cfg: ModelConfig,
                              device: DeviceLike = None) -> ServingParams:
    """Packed serving tree (see module docstring) -> ServingParams."""
    dev = resolve_device(device)
    if len(tree["layers"]) != cfg.n_layers:
        raise ValueError(f"{len(tree['layers'])} layers != n_layers "
                         f"{cfg.n_layers}")
    return ServingParams(
        embed=_tree(tree["embed"], dev), final_ln=_tree(tree["final_ln"], dev),
        layers=_tree(tree["layers"], dev), head=_tree(tree.get("head"), dev),
        head_t=_tree(tree.get("head_t"), dev))
