"""Carry weights made elsewhere into the port, from numpy and plain Python.

* :func:`params_from_numpy` takes a model-params tree of numpy arrays, as
  the reference's ``init_params`` output looks after ``np.asarray`` on
  every leaf: ``embed``, ``final_ln``, ``head`` and ``layers`` with stacked
  leaves (plus ``mm_proj`` for the vlm family); the hybrid family's
  ``layers_body`` (leaves (n_super, attn_every, ...)), ``layers_tail``,
  ``shared_attn`` and ``attn_gate``; the encdec family's ``enc_layers`` and
  ``dec_layers`` (``self``/``cross``/``attn``/``mlp`` subtrees, ``{"g",
  "b"}`` norms), ``pos_dec``, ``enc_ln`` and ``dec_ln``.
* :func:`serving_params_from_numpy` takes a packed serving tree: ``embed``,
  ``final_ln``, ``head``/``head_t`` and ``layers`` (a list of per-layer
  dicts), where every packed projection is a dict
  ``{"packed": [{"blocks", "scales", "row_idx", "nnz", "density"}, ...],
  "d_in", "d_out", "bits"}``, and the vlm family's float ``mm_proj``.
  Serving the int8 packing carried across is exact: no level is
  recomputed.
* :func:`train_state_from_numpy` takes a train state as the reference's
  ``init_train_state`` makes it (``{"params", "opt": {"m"[, "v"]},
  "step"}``) after ``np.asarray`` on every leaf, so both trainers can
  start from the same state.
* :func:`cnn_params_from_numpy` takes a CNN's params and BN state as the
  reference's ``vgg_init``/``resnet_init`` make them (HWIO weights, VGG's
  ``None`` at each pool, ResNet's block ``stride``), numpy leaves or not.

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


def _leaves(tree: dict):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _stack_depths(cfg: ModelConfig) -> dict:
    """Each stacked subtree of ``cfg``'s family and its leading shape."""
    if cfg.family == "encdec":
        return {"enc_layers": (cfg.enc_layers,),
                "dec_layers": (cfg.n_layers,)}
    if cfg.family == "hybrid":
        n_super = cfg.n_layers // cfg.attn_every
        n_tail = cfg.n_layers - n_super * cfg.attn_every
        return {"layers_body": (n_super, cfg.attn_every),
                "layers_tail": (n_tail,)}
    return {"layers": (cfg.n_layers,)}


def params_from_numpy(tree: dict, cfg: ModelConfig,
                      device: DeviceLike = None) -> dict:
    """Model params (numpy leaves) -> the port's params dict on ``device``,
    each layer stack checked against ``cfg``'s depth."""
    dev = resolve_device(device)
    params = _tree(tree, dev)
    for name, lead in _stack_depths(cfg).items():
        for leaf in _leaves(params.get(name, {})):
            if tuple(leaf.shape[:len(lead)]) != lead:
                raise ValueError(f"{name}: layer stack of "
                                 f"{tuple(leaf.shape[:len(lead)])} != {lead}"
                                 f" for n_layers {cfg.n_layers}")
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
        mm_proj=_tree(tree.get("mm_proj"), dev),
        head_t=_tree(tree.get("head_t"), dev))


def train_state_from_numpy(tree: dict, cfg: ModelConfig,
                           device: DeviceLike = None) -> dict:
    """A train state (numpy leaves) -> the port's on ``device``: params
    that require a gradient, the moments, ``step`` as a Python int."""
    from .train.trainer import TrainConfig, train_state
    dev = resolve_device(device)
    return train_state(TrainConfig(), params_from_numpy(tree["params"], cfg,
                                                        dev),
                       _tree(tree["opt"], dev), int(np.asarray(tree["step"])))


def _cnn_tree(x, device: torch.device) -> Any:
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: (int(np.asarray(v)) if k == "stride"
                    else _cnn_tree(v, device)) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_cnn_tree(v, device) for v in x]
    return tensor_from_numpy(x, device)


def cnn_params_from_numpy(params: dict, state: dict,
                          device: DeviceLike = None):
    """A CNN's (params, state) trees -> the port's on ``device``: the same
    structure, ``None`` kept, each ResNet block's ``stride`` a Python
    int."""
    dev = resolve_device(device)
    return _cnn_tree(params, dev), _cnn_tree(state, dev)
