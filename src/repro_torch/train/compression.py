"""Int8 error-feedback compression of the data-parallel gradient, on a
single-controller mesh (the port of the reference's
``train/compression.py``).

MARS's own quantizer (eq. 8's symmetric integer grid) applied to the DP
gradient all-reduce: each replica's gradient crosses the wire as int8
levels and one f32 scale a tensor, with error feedback keeping SGD
unbiased in the long run. The reference runs one program a device under
``shard_map``, a ``pmax`` sharing the scale and a ``psum`` of the levels.
Here one controller (``launch.mesh.make_local_mesh``) runs every replica in
turn: replica r takes slice r of the batch's leading dim and computes its
gradient on ``mesh.devices[r]`` (several replicas may share a card); the
max of the replicas' maxima is the ``pmax``, the sum of their levels in
replica order the ``psum``, so a run repeats bit for bit. The error state
is each replica's own residual, as each device keeps its own under the
reference's replicated spec: ``err`` leaves carry a leading replica axis
and are updated in place, as the optimizer updates the parameters.
"""
from __future__ import annotations

from typing import Callable, List

import torch

from ..models.config import ModelConfig
from . import optimizer as opt
from .trainer import TrainConfig, make_loss_fn, value_and_grad


def init_error_state(params: dict, n_replicas: int = 1) -> dict:
    """Zero error state: f32 leaves (n_replicas, *p.shape) on p's device."""
    return opt.tree_map(lambda p: torch.zeros(
        (n_replicas, *p.shape), dtype=torch.float32, device=p.device), params)


def compress_mean(grads: List[torch.Tensor], errs: List[torch.Tensor]
                  ) -> torch.Tensor:
    """One leaf over the replicas: ``g32 = g + err`` per replica, the scale
    ``max(max_r max|g32_r|, 1e-12) / 127`` shared, levels ``q_r =
    clip(round(g32_r / scale), -127, 127)``, the new error ``g32_r - q_r
    scale`` written into ``errs[r]`` in place, and the mean ``(sum_r q_r)
    * (scale / n)`` returned in the gradient's type. ``grads[r]`` lies on
    replica r's device and is consumed (an f32 gradient holds ``g32`` in
    place: the replicas' gradients are the step's largest buffers); the
    mean and the scale lie on replica 0's device."""
    home = grads[0].device
    out_dtype = grads[0].dtype
    g32 = []
    for g, e in zip(grads, errs):
        t = g.float()
        g32.append(t.add_(e.to(t.device)))
    amax = g32[0].abs().max()
    for t in g32[1:]:
        amax = torch.maximum(amax, t.abs().max().to(home))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    total = None
    for t, e in zip(g32, errs):
        s = scale.to(t.device)
        q = torch.clamp(torch.round(t / s), -127, 127)
        e.copy_(t.sub_(q * s))
        total = q.to(home) if total is None else total.add_(q.to(home))
    n = torch.tensor(float(len(grads)), dtype=torch.float32, device=home)
    return total.mul_(scale / n).to(out_dtype)


def make_compressed_dp_train_step(model_cfg: ModelConfig, tcfg: TrainConfig,
                                  mesh, axis: str = "data") -> Callable:
    """Pure data parallelism with the compressed gradient mean over
    ``mesh``'s ``axis`` (a ``launch.mesh.LocalMesh``). Returns
    step(state, batch) -> (state, metrics), the state ``{"params", "opt",
    "err", "step"}`` (``err`` from :func:`init_error_state` with the
    replica count) updated in place, as ``trainer.make_train_step``'s;
    the batch's leading dim splits evenly over the replicas; metrics hold
    ``lr``, ``grad_norm`` and ``loss``, the replicas' mean CE."""
    loss_fn = make_loss_fn(model_cfg)
    n = mesh.shape[axis]
    devices = [mesh.devices[r % len(mesh.devices)] for r in range(n)]

    def step(state, batch):
        params = state["params"]
        home = opt.leaves(params)[0].device
        flat_g, ces = [], []
        for r, dev in enumerate(devices):
            part = {k: v.reshape(n, -1, *v.shape[1:])[r].to(dev)
                    for k, v in batch.items()}
            p_r = params if dev == home else opt.tree_map(
                lambda p: p.detach().to(dev).requires_grad_(), params)
            (_, ce), g = value_and_grad(loss_fn, p_r, part)
            flat_g.append(opt.leaves(g))
            ces.append(ce.to(home))
        means = []
        for i, e in enumerate(opt.leaves(state["err"])):
            means.append(compress_mean([g[i] for g in flat_g],
                                       list(e)).to(home))
            for g in flat_g:
                g[i] = None  # consumed
        it = iter(means)
        grads = opt.tree_map(lambda _: next(it), params)
        ce = ces[0]
        for c in ces[1:]:
            ce = ce + c
        metrics = opt.apply_updates(tcfg.opt, params, state["opt"], grads,
                                    state["step"])
        metrics["loss"] = ce / n
        state["step"] += 1
        return state, metrics

    return step
