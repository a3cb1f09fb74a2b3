"""VGG16 / ResNet18 (CIFAR variants) built from CIMConv2D: the paper's own
test networks (§V.B). The small variants train on a CPU budget; the full
nets' layer shapes are the paper's.

Trees follow the reference's: VGG's ``convs`` list holds ``None`` at each
"M" (max pool), and each ResNet block dict holds its stride as a Python
int. The head is a plain ``x @ w + b``, never quantized.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from ..core import cim_layer as CL
from ..core import quant as Q
from ..core import sparsity as S
from ..core.cim_layer import CIMConfig
from ..device import DeviceLike, resolve_device

VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
             "M", 512, 512, 512, "M"]
VGG_SMALL_CFG = [32, "M", 64, "M", 128, "M"]


def _head(generator: torch.Generator, c: int, n_classes: int,
          dtype: torch.dtype, dev: torch.device) -> dict:
    return {"w": torch.randn((c, n_classes), generator=generator,
                             dtype=dtype, device=dev) * (1.0 / c ** 0.5),
            "b": torch.zeros((n_classes,), dtype=dtype, device=dev)}


def _act(x: torch.Tensor, cfg: CIMConfig) -> torch.Tensor:
    """ReLU, then in qat mode the clip to [0, 1] that eq. 5 assumes (the
    paper's "clip function ... instead of normalization"), with
    ``jnp.clip``'s gradient."""
    x = torch.relu(x)
    return Q.clip(x, 0.0, 1.0) if cfg.mode == "qat" else x


def vgg_init(generator: torch.Generator, cfg: CIMConfig,
             plan: Sequence = VGG16_CFG, in_ch: int = 3, n_classes: int = 10,
             dtype: torch.dtype = torch.float32, device: DeviceLike = None):
    """(params, state) with random weights drawn from ``generator``, which
    must live on ``device``."""
    dev = resolve_device(device)
    params, states = [], []
    c = in_ch
    for v in plan:
        if v == "M":
            params.append(None)
            states.append(None)
            continue
        p, s = CL.conv_init(generator, 3, 3, c, v, cfg, dtype, device=dev)
        params.append(p)
        states.append(s)
        c = v
    return ({"convs": params, "head": _head(generator, c, n_classes, dtype,
                                            dev)},
            {"convs": states})


def vgg_apply(params, state, x: torch.Tensor, cfg: CIMConfig,
              plan: Sequence = VGG16_CFG, train: bool = False):
    """NHWC images -> (logits, new_state)."""
    new_states = []
    for v, p, s in zip(plan, params["convs"], state["convs"]):
        if v == "M":
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
            new_states.append(None)
            continue
        x, s2 = CL.conv_apply(p, s, x, cfg, train=train)
        x = _act(x, cfg)
        new_states.append(s2)
    x = x.mean(dim=(1, 2))  # global average pool
    logits = x @ params["head"]["w"] + params["head"]["b"]
    return logits, {"convs": new_states}


# ---------------------------------------------------------------------------
# ResNet18 (CIFAR stem)
# ---------------------------------------------------------------------------

RESNET18_STAGES = [(64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2)]
RESNET_SMALL_STAGES = [(32, 1, 1), (64, 1, 2)]


def resnet_init(generator: torch.Generator, cfg: CIMConfig,
                stages=RESNET18_STAGES, in_ch: int = 3, n_classes: int = 10,
                dtype: torch.dtype = torch.float32,
                device: DeviceLike = None):
    """(params, state) with random weights drawn from ``generator``; a
    block whose stride or width changes gets a 1x1 ``down`` conv."""
    dev = resolve_device(device)
    init = lambda k, ci, co: CL.conv_init(generator, k, k, ci, co, cfg,
                                          dtype, device=dev)
    stem_p, stem_s = init(3, in_ch, stages[0][0])
    blocks_p, blocks_s = [], []
    c = stages[0][0]
    for width, nblocks, stride in stages:
        for b in range(nblocks):
            s0 = stride if b == 0 else 1
            p1, s1 = init(3, c, width)
            p2, s2 = init(3, width, width)
            blk = {"conv1": p1, "conv2": p2, "stride": s0}
            st = {"conv1": s1, "conv2": s2}
            if s0 != 1 or c != width:
                blk["down"], st["down"] = init(1, c, width)
            blocks_p.append(blk)
            blocks_s.append(st)
            c = width
    return ({"stem": stem_p, "blocks": blocks_p,
             "head": _head(generator, c, n_classes, dtype, dev)},
            {"stem": stem_s, "blocks": blocks_s})


def resnet_apply(params, state, x: torch.Tensor, cfg: CIMConfig,
                 train: bool = False):
    """NHWC images -> (logits, new_state)."""
    x, stem_s = CL.conv_apply(params["stem"], state["stem"], x, cfg,
                              train=train)
    x = _act(x, cfg)
    new_blocks = []
    for blk, st in zip(params["blocks"], state["blocks"]):
        stride = blk["stride"]
        h, s1 = CL.conv_apply(blk["conv1"], st["conv1"], x, cfg,
                              stride=stride, train=train)
        h = _act(h, cfg)
        h, s2 = CL.conv_apply(blk["conv2"], st["conv2"], h, cfg, train=train)
        ns = {"conv1": s1, "conv2": s2}
        if "down" in blk:
            x, ns["down"] = CL.conv_apply(blk["down"], st["down"], x, cfg,
                                          stride=stride, train=train)
        x = _act(x + h, cfg)
        new_blocks.append(ns)
    x = x.mean(dim=(1, 2))
    logits = x @ params["head"]["w"] + params["head"]["b"]
    return logits, {"stem": stem_s, "blocks": new_blocks}


# ---------------------------------------------------------------------------
# The compression pipeline's helpers
# ---------------------------------------------------------------------------


def iter_conv_params(params):
    """Every conv's param dict in a CNN tree, in the forward's order."""
    if "convs" in params:
        for p in params["convs"]:
            if p is not None:
                yield p
    else:
        yield params["stem"]
        for blk in params["blocks"]:
            yield blk["conv1"]
            yield blk["conv2"]
            if "down" in blk:
                yield blk["down"]


def regularization(params, cfg: CIMConfig) -> torch.Tensor:
    """The sum of every conv's group lasso (and L2)."""
    total = None
    for p in iter_conv_params(params):
        r = CL.conv_regularizer(p, cfg)
        total = r if total is None else total + r
    return total


def prune_all(params, cfg: CIMConfig):
    """A new tree with every conv's mask recomputed (``conv_prune``); the
    input tree is left as it was."""
    out = map_tensors(lambda t: t.detach().clone(), params)
    if "convs" in out:
        out["convs"] = [CL.conv_prune(p, cfg) if p is not None else None
                        for p in out["convs"]]
    else:
        out["stem"] = CL.conv_prune(out["stem"], cfg)
        for blk in out["blocks"]:
            for name in ("conv1", "conv2", "down"):
                if name in blk:
                    blk[name] = CL.conv_prune(blk[name], cfg)
    return out


# ---------------------------------------------------------------------------
# Trees and the reference's SGD update
# ---------------------------------------------------------------------------


def map_tensors(fn, tree):
    """``tree`` with ``fn`` applied to each tensor, visited in
    ``sparsity.tensor_leaves``'s order (sorted dict keys); None and
    ResNet's int strides are kept."""
    if isinstance(tree, dict):
        out = {k: map_tensors(fn, tree[k]) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def grads(loss_fn, params, *args):
    """``loss_fn(params, *args)`` -> ``(loss, aux)``; returns the loss
    (detached), ``aux`` and the gradient of each floating tensor of
    ``params`` in ``tensor_leaves`` order, None where none reaches it (a
    mask)."""
    leaves = [t for t in S.tensor_leaves(params) if t.is_floating_point()]
    flags = [t.requires_grad for t in leaves]
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss, aux = loss_fn(params, *args)
        g = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for t, f in zip(leaves, flags):
            t.requires_grad_(f)
    return loss.detach(), aux, g


def sgd_step(loss_fn, params, *args, lr: float = 0.05):
    """The update the reference's CNN pipeline trains with, ``p - lr g``
    on every floating tensor that has a gradient; masks (which take none)
    and ints stay. Returns ``(new_params, aux)``."""
    _, aux, g = grads(loss_fn, params, *args)
    it = iter(g)

    def update(t):
        if not t.is_floating_point():
            return t
        gi = next(it)
        return t if gi is None else (t - lr * gi).detach()

    return map_tensors(update, params), aux
