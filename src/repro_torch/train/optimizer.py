"""Hand-rolled optimizers: SGD+momentum and AdamW over a dict of parameter
tensors, with global-norm clipping and LR schedules - a functional port of
the reference's ``train/optimizer.py``.

``torch.optim`` is not used: its AdamW decays the parameter before the
moment step and puts eps elsewhere, where the reference adds
``weight_decay * p`` to the Adam direction. ``apply_updates`` updates the
parameters and the moments in place under ``torch.no_grad()`` (the
reference returns new trees), with every step in the reference's order and
dtypes: moments in ``moment_dtype``, bias corrections from ``step + 1``,
decay on every leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"  # adamw | sgdm
    lr: float = 1e-3
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"  # cosine | step | const  (paper: step /10)
    step_decay_every: int = 0
    step_decay_rate: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    momentum: float = 0.9
    clip_norm: float = 1.0
    moment_dtype: str = "float32"


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def schedule_lr(cfg: OptConfig, step: int) -> torch.Tensor:
    """The learning rate at ``step`` as an f32 scalar (on the CPU), each
    operation rounded to f32 as the reference's jnp does."""
    s = _f32(step)
    warm = torch.clamp((s + 1.0) / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "cosine":
        t = torch.clamp((s - cfg.warmup_steps)
                        / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0,
                        1.0)
        base = 0.5 * (1.0 + torch.cos(_f32(math.pi) * t))
    elif cfg.schedule == "step":
        k = torch.floor(s / max(cfg.step_decay_every, 1))
        base = _f32(cfg.step_decay_rate) ** k
    else:
        base = _f32(1.0)
    return cfg.lr * warm * base


def _moment_dtype(cfg: OptConfig) -> torch.dtype:
    return getattr(torch, cfg.moment_dtype)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure, visited in
    the reference's (sorted-key) order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def leaves(tree) -> list:
    """The leaves of nested dicts, in the reference's (sorted-key) order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    return [tree]


def init_state(cfg: OptConfig, params: Dict[str, torch.Tensor]) -> dict:
    """Zero moments shaped like ``params`` (a possibly nested dict)."""
    dt = _moment_dtype(cfg)
    zeros = lambda t: tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                                     device=p.device), t)
    if cfg.kind == "adamw":
        return {"m": zeros(params), "v": zeros(params)}
    return {"m": zeros(params)}


def _clip_by_global_norm(grads, max_norm: float
                         ) -> Tuple[dict, torch.Tensor]:
    """Scale ``grads`` so their global L2 norm is at most ``max_norm``
    (``+1e-9`` in the divisor); returns (grads, norm before clipping)."""
    gl = leaves(grads)
    gn = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in gl))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn


@torch.no_grad()
def apply_updates(cfg: OptConfig, params: dict, opt_state: dict, grads: dict,
                  step: int) -> dict:
    """One optimizer step, in place on ``params`` and ``opt_state``.
    Returns the metrics ``lr`` and ``grad_norm`` (f32 scalars)."""
    dev = leaves(params)[0].device
    lr = schedule_lr(cfg, step).to(dev)
    if cfg.clip_norm > 0:
        grads, gnorm = _clip_by_global_norm(grads, cfg.clip_norm)
    else:
        gnorm = torch.zeros((), dtype=torch.float32, device=dev)
    ps, gs = leaves(params), leaves(grads)
    ms = leaves(opt_state["m"])
    if cfg.kind == "adamw":
        b1, b2 = cfg.b1, cfg.b2
        t = _f32(step + 1.0)
        corr1 = (1.0 - _f32(b1) ** t).to(dev)
        corr2 = (1.0 - _f32(b2) ** t).to(dev)
        for p, g, m, v in zip(ps, gs, ms, leaves(opt_state["v"])):
            g32 = g.to(m.dtype)
            m.copy_(b1 * m + (1 - b1) * g32)
            v.copy_(b2 * v + (1 - b2) * g32 * g32)
            delta = (m / corr1) / (torch.sqrt(v / corr2) + cfg.eps)
            if cfg.weight_decay > 0:
                delta = delta + cfg.weight_decay * p.to(m.dtype)
            p.copy_((p.to(m.dtype) - lr * delta).to(p.dtype))
    else:  # SGD + momentum
        for p, g, m in zip(ps, gs, ms):
            g32 = g.to(m.dtype)
            if cfg.weight_decay > 0:
                g32 = g32 + cfg.weight_decay * p.to(m.dtype)
            m.copy_(cfg.momentum * m + g32)
            p.copy_((p.to(m.dtype) - lr * m).to(p.dtype))
    return {"lr": lr, "grad_norm": gnorm}
