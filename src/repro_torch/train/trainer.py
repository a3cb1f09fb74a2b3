"""Train-step construction: loss + MARS group-lasso regularization (eq. 2),
microbatch gradient accumulation, optimizer update, metrics - the port of
the reference's ``train/trainer.py``.

The regularizer is path-filtered: it applies to the weights that map onto
CIM macros (attention/MLP/SSM projections), not to norms, embeddings or
biases, mirroring the paper, which prunes conv layers only. A train state
is a dict ``{"params", "opt": {"m"[, "v"]}, "step"}`` (``step`` a Python
int); ``make_train_step``'s step updates it in place.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Callable, Tuple

import torch

from ..core.cim_layer import CIMConfig
from ..core.sparsity import group_lasso_2d
from ..device import DeviceLike, resolve_device
from ..models import registry
from ..models.config import ModelConfig
from . import checkpoint as ckpt
from . import optimizer as opt

WEIGHT_KEYS = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
               "in_proj", "out_proj", "mm_proj"}


def lm_regularization(params: dict, cim: CIMConfig) -> torch.Tensor:
    """Group lasso (eq. 4) over every CIM-mapped weight in the LM tree,
    ``lambda_g / 2`` times the sum of tile norms. Stacked leaves ((L,d,f),
    (L,E,d,f)) sum over their leading axes."""
    sc = cim.sparsity
    total = None
    for path, leaf in ckpt.flatten(params):
        if (path.rsplit("/", 1)[-1] not in WEIGHT_KEYS
                or not isinstance(leaf, torch.Tensor)):
            continue
        w = leaf.float()
        w = w.reshape((-1,) + tuple(w.shape[-2:]))
        norms = torch.stack([group_lasso_2d(m, sc.n, sc.alpha) for m in w])
        part = norms.sum()
        total = part if total is None else total + part
    if total is None:
        total = torch.zeros((), dtype=torch.float32)
    return sc.lambda_g / 2.0 * total


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: opt.OptConfig = dataclasses.field(default_factory=opt.OptConfig)
    grad_accum: int = 1
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ckpt_every: int = 100
    ckpt_keep: int = 3
    log_every: int = 10


def init_train_state(model_cfg: ModelConfig, tcfg: TrainConfig,
                     generator: torch.Generator,
                     device: DeviceLike = None) -> dict:
    """Random parameters from ``generator`` (on ``device``), zero moments,
    step 0. Every parameter requires a gradient."""
    dev = resolve_device(device)
    params = registry.model_fns(model_cfg).init_params(model_cfg, generator,
                                                       dev)
    return train_state(tcfg, params)


def train_state(tcfg: TrainConfig, params: dict, opt_state=None,
                step: int = 0) -> dict:
    """A train state around ``params`` (made leaves that require a
    gradient), with zero moments unless ``opt_state`` is given."""
    params = opt.tree_map(lambda p: p.detach().requires_grad_(), params)
    if opt_state is None:
        opt_state = opt.init_state(tcfg.opt, params)
    return {"params": params, "opt": opt_state, "step": int(step)}


def make_loss_fn(model_cfg: ModelConfig) -> Callable:
    """loss_fn(params, batch) -> (total, ce): CE plus the group lasso in
    QAT mode with ``lambda_g > 0``."""
    fns = registry.model_fns(model_cfg)

    def loss_fn(params, batch):
        ce = fns.train_loss(params, batch, model_cfg)
        total = ce
        if model_cfg.cim_mode == "qat" and model_cfg.lambda_g > 0:
            total = total + lm_regularization(params, model_cfg.cim).to(
                ce.device)
        return total, ce

    return loss_fn


def value_and_grad(loss_fn: Callable, params: dict, batch: dict
                   ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], dict]:
    """((total, ce), grads) with grads a dict shaped like ``params``."""
    flat = opt.leaves(params)
    total, ce = loss_fn(params, batch)
    gl = torch.autograd.grad(total, flat, allow_unused=True)
    # a leaf the loss does not reach gets zeros, as under jax.grad
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(flat, gl))
    grads = opt.tree_map(lambda _: next(it), params)
    return (total.detach(), ce.detach()), grads


def make_train_step(model_cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics): the state is
    updated in place (and returned); metrics hold ``loss`` (the CE, mean
    over microbatches), ``lr`` and ``grad_norm``. batch leaves are tensors
    on the parameters' device; ``grad_accum`` splits the batch axis into
    that many microbatches, summed in order and averaged."""
    loss_fn = make_loss_fn(model_cfg)

    def train_step(state, batch):
        params = state["params"]
        if tcfg.grad_accum > 1:
            n = tcfg.grad_accum
            mbs = {k: v.reshape((n, -1) + tuple(v.shape[1:]))
                   for k, v in batch.items()}
            gsum = opt.tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            ce_sum = torch.zeros((), dtype=torch.float32,
                                 device=opt.leaves(params)[0].device)
            for i in range(n):
                (_, ce), g = value_and_grad(
                    loss_fn, params, {k: v[i] for k, v in mbs.items()})
                gsum = opt.tree_map(lambda a, b: a + b, gsum, g)
                ce_sum = ce_sum + ce
            grads = opt.tree_map(lambda g: g / n, gsum)
            ce = ce_sum / n
        else:
            (_, ce), grads = value_and_grad(loss_fn, params, batch)
        metrics = opt.apply_updates(tcfg.opt, params, state["opt"], grads,
                                    state["step"])
        metrics["loss"] = ce
        state["step"] += 1
        return state, metrics

    return train_step
