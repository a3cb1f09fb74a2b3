"""GPipe pipeline parallelism on a single-controller mesh (the port of
the reference's ``train/pipeline.py``).

Stages lie along a mesh axis; microbatches stream through the reference's
``M + S - 1``-tick schedule: at tick t stage 0 takes microbatch ``min(t,
M - 1)``, every stage runs on what it received, and each passes its output
to the next stage, a copy to that stage's device (the reference's
``ppermute``; stage 0 receives nothing). The last stage's outputs for
microbatch j leave at tick ``j + S - 1``. One controller runs the stages
of a tick in order (``launch.mesh.make_local_mesh``; several stages may
share a card). Autograd records the whole schedule, copies included, so
the same construct trains.
"""
from __future__ import annotations

from typing import Callable

import torch

from . import optimizer as opt


def _tree_index(tree, i):
    if isinstance(tree, dict):
        return {k: _tree_index(v, i) for k, v in tree.items()}
    return tree[i]


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def pipeline_apply(stage_fn: Callable, n_stages: int, mesh=None,
                   axis: str = "pipe") -> Callable:
    """Build pipelined_fn(stage_params, x_microbatches) -> outputs.

    stage_params leaves: (n_stages, ...), stage s's slice moved to
    ``mesh.devices[s]`` (wrapping around; with no mesh, where they lie).
    x_microbatches: (M, mb, ...); outputs (M, mb, ...) on x's device."""
    if mesh is not None and mesh.shape[axis] != n_stages:
        raise ValueError(f"mesh axis {axis!r} has {mesh.shape[axis]} "
                         f"positions, the pipeline {n_stages} stages")

    def run(stage_params, x_all):
        home = x_all.device
        devs = ([mesh.devices[s % len(mesh.devices)] for s in range(n_stages)]
                if mesh is not None else [home] * n_stages)
        params = [_tree_to(_tree_index(stage_params, s), devs[s])
                  for s in range(n_stages)]
        m = x_all.shape[0]
        state = [torch.zeros(x_all.shape[1:], dtype=x_all.dtype, device=d)
                 for d in devs]
        emits = []
        for t in range(m + n_stages - 1):
            outs = []
            for s in range(n_stages):
                inp = x_all[min(t, m - 1)].to(devs[0]) if s == 0 else state[s]
                outs.append(stage_fn(params[s], inp))
            state = [state[0]] + [outs[s].to(devs[s + 1])
                                  for s in range(n_stages - 1)]
            emits.append(outs[-1])
        return torch.stack([e.to(home) for e in emits[n_stages - 1:]])

    return run


def stack_stages(layer_params, n_stages: int):
    """(L, ...) stacked layer params -> (n_stages, L / n_stages, ...)."""
    def r(a):
        n = a.shape[0]
        if n % n_stages:
            raise ValueError(f"{n} layers do not split into {n_stages} "
                             "stages")
        return a.reshape(n_stages, n // n_stages, *a.shape[1:])

    return opt.tree_map(r, layer_params)


def scan_stage(layer_fn: Callable) -> Callable:
    """stage_fn that runs layer_fn over the stage's layer slice in order."""

    def stage(params_stage, x):
        n = opt.leaves(params_stage)[0].shape[0]
        for i in range(n):
            x = layer_fn(_tree_index(params_stage, i), x)
        return x

    return stage
