"""Compressed data parallelism and the GPipe pipeline of the port
(``train/compression.py``, ``train/pipeline.py``) against the
reference's.

The reference runs in ONE subprocess with 8 fake host devices (XLA's
device count is fixed at JAX's first import), as
``tests/test_distributed.py`` runs it, and writes every array to an npz:
the yi-6b smoke train state in f32, a batch of 8 x 16 tokens, the
compressed step's parameters and loss, the compressed mean gradient that
its optimizer was given, and each device's own error state (one buffer a
device under the replicated spec). Its pipeline runs
inside ``jax.set_mesh``: jax 0.9 refuses the reference's own test without
a context mesh. The port runs the same steps on the CPU on a
single-controller mesh of 8 replicas and of 4 stages.

Bars: the reference test's own (loss within 1e-3 of the plain step,
parameters within 2e-3), and against the reference's compressed step the
loss within 1e-5, the parameters within 2 lr, and, element by element,
the mean gradient and each replica's error equal within f32 rounding
except where a level flipped, there one level (scale / n) and one scale
apart, with at most one flip in 1e4 elements (an AdamW step from a fresh
state moves a parameter by lr times the sign of its mean, so the
parameters alone cannot show the mean's size); the pipeline's output
within 1e-5 of the reference's pipeline and its gradients within 1e-4 /
1e-5 (rtol / atol) of the reference's sequential run, as the reference's
test holds its own.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.convert import train_state_from_numpy
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import registry as TR
from repro_torch.train import optimizer as TO
from repro_torch.train import trainer as TTR
from repro_torch.train import compression as TC
from repro_torch.train.compression import (
    compress_mean, init_error_state, make_compressed_dp_train_step)
from repro_torch.train.pipeline import pipeline_apply, scan_stage, stack_stages

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
N_DP = 8
# where no level flipped: f32 gradients of two programs, relative to a
# leaf's max |g32| (the flip that moves an error by a scale is 1 / 127)
RTOL = 1e-5
MAX_FLIPS = 1e-4  # of the error state's elements

REFERENCE = r'''
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.tree_util import tree_flatten_with_path
from repro.models import registry
from repro.train import TrainConfig, OptConfig, init_train_state
from repro.train.compression import (make_compressed_dp_train_step,
                                     init_error_state)
from repro.train.pipeline import pipeline_apply, stack_stages, scan_stage
from repro.train import optimizer as ropt
from repro.data import TokenPipeline

# the step's compressed mean gradient, as the optimizer is given it
real_apply = ropt.apply_updates
def apply_and_keep(cfg, params, opt_state, grads, step):
    new_p, new_o, metrics = real_apply(cfg, params, opt_state, grads, step)
    return new_p, new_o, dict(metrics, mean_grad=grads)
ropt.apply_updates = apply_and_keep

out = {}
def put(prefix, tree, replicas=False):
    for path, leaf in tree_flatten_with_path(tree)[0]:
        name = prefix + "/".join(str(getattr(p, "key", p)) for p in path)
        out[name] = (np.stack([np.asarray(s.data) for s in sorted(
            leaf.addressable_shards, key=lambda s: s.device.id)])
            if replicas else np.asarray(leaf))

cfg = registry.get_smoke_config("yi-6b", dtype="float32")
tcfg = TrainConfig(opt=OptConfig(lr=LR, warmup_steps=1, clip_norm=0.0))
state = init_train_state(cfg, tcfg, jax.random.PRNGKey(0))
pipe = TokenPipeline(vocab=cfg.vocab, batch=8, seq_len=16)
batch = {k: jnp.asarray(v) for k, v in pipe.next_batch().items()}
put("init:", state)
put("batch:", batch)
mesh = jax.make_mesh((8,), ("data",))
comp = jax.jit(make_compressed_dp_train_step(cfg, tcfg, mesh, "data"))
cstate = dict(state)
cstate["err"] = init_error_state(state["params"])
s_comp, m_comp = comp(cstate, batch)
put("comp:", s_comp["params"])
put("err:", s_comp["err"], replicas=True)
put("mean:", m_comp["mean_grad"])
out["comp_loss"] = np.asarray(m_comp["loss"])

D, L, NS, M = 16, 8, 4, 6
w = jax.random.normal(jax.random.PRNGKey(0), (L, D, D)) * (1.0 / D ** 0.5)
xs = jax.random.normal(jax.random.PRNGKey(1), (M, 4, D))
layer_fn = lambda p, x: jnp.tanh(x @ p)
def sequential(w, xs):
    one = lambda x: jax.lax.scan(lambda x, p: (layer_fn(p, x), None), x, w)[0]
    return jax.vmap(one)(xs)
out["pipe_w"], out["pipe_xs"] = np.asarray(w), np.asarray(xs)
out["seq_y"] = np.asarray(sequential(w, xs))
out["seq_g"] = np.asarray(jax.grad(
    lambda w: jnp.sum(sequential(w, xs) ** 2))(w))
pmesh = jax.make_mesh((4, 2), ("pipe", "data"))
pipe_fn = pipeline_apply(scan_stage(layer_fn), NS, pmesh, "pipe")
with jax.set_mesh(pmesh):  # jax 0.9 wants a context mesh here
    out["pipe_y"] = np.asarray(pipe_fn(stack_stages(w, NS), xs))
np.savez(sys.argv[1], **out)
'''.replace("LR", repr(LR))


def _nest(flat: dict, prefix: str) -> dict:
    tree = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        *path, leaf = k[len(prefix):].split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    pytest.importorskip("jax")
    path = str(tmp_path_factory.mktemp("dist") / "ref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", REFERENCE, path],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


def _setup(ref):
    cfg = TR.get_smoke_config("yi-6b", dtype="float32")
    tcfg = TTR.TrainConfig(opt=TO.OptConfig(lr=LR, warmup_steps=1,
                                            clip_norm=0.0))
    init = _nest(ref, "init:")
    batch = {k: torch.from_numpy(v) for k, v in _nest(ref, "batch:").items()}
    fresh = lambda: train_state_from_numpy(init, cfg, "cpu")
    return cfg, tcfg, fresh, batch


def _close(got: dict, want: dict, atol: float):
    gl, wl = TO.leaves(got), TO.leaves(want)
    assert len(gl) == len(wl)
    arr = lambda t: t.detach().numpy() if torch.is_tensor(t) else t
    worst = max(float(np.abs(arr(g) - arr(w)).max()) for g, w in zip(gl, wl))
    assert worst < atol, worst
    return worst


def test_compressed_dp_matches_plain_and_reference(ref, monkeypatch):
    cfg, tcfg, fresh, batch = _setup(ref)
    plain = fresh()
    _, m_plain = TTR.make_train_step(cfg, tcfg)(plain, batch)

    # the step's compressed mean as the optimizer is given it, and each
    # leaf's shared scale
    means, scales = [], []
    real_apply, real_mean = TO.apply_updates, TC.compress_mean

    def apply_and_keep(cfg_, params, opt_state, grads, step):
        means.extend(t.clone() for t in TO.leaves(grads))
        return real_apply(cfg_, params, opt_state, grads, step)

    def mean_and_scale(grads, errs):
        amax = max(float((g.float() + e).abs().max())
                   for g, e in zip(grads, errs))
        scales.append(max(amax, 1e-12) / 127.0)
        return real_mean(grads, errs)

    monkeypatch.setattr(TO, "apply_updates", apply_and_keep)
    monkeypatch.setattr(TC, "compress_mean", mean_and_scale)
    mesh = make_local_mesh(N_DP, "cpu")
    state = fresh()
    state["err"] = init_error_state(state["params"], N_DP)
    step = make_compressed_dp_train_step(cfg, tcfg, mesh, "data")
    _, m = step(state, batch)
    # the reference test's own bars, against the plain step
    assert abs(float(m["loss"]) - float(m_plain["loss"])) < 1e-3
    _close(state["params"], plain["params"], 2e-3)
    assert abs(float(m["loss"]) - float(ref["comp_loss"])) < 1e-5
    _close(state["params"], _nest(ref, "comp:"), 2 * LR)
    # the compressed mean, element by element, against the reference's:
    # equal up to f32 rounding, or one level (scale / n) apart where a
    # replica's level flipped (its g32 / scale within rounding of a
    # half-level); each replica's error state equal up to f32 rounding, or
    # one scale apart at those sites; the flips few
    want_mean = TO.leaves(_nest(ref, "mean:"))
    want_err = TO.leaves(_nest(ref, "err:"))
    errs = TO.leaves(state["err"])
    assert len(means) == len(want_mean) == len(scales) == len(errs)
    n_el = flips = 0
    for got, want, scale, e, we in zip(means, want_mean, scales, errs,
                                       want_err):
        tol = RTOL * 127.0 * scale  # of the leaf's max |g32|
        level = scale / N_DP
        d = np.abs(got.numpy().astype(np.float64) - want)
        moved = d > tol
        assert np.all(np.abs(d[moved] - level) <= tol), (d[moved], level)
        de = np.abs(e.numpy().astype(np.float64) - we)
        flipped = de > tol
        assert np.all(np.abs(de[flipped] - scale) <= tol), (de[flipped],
                                                              scale)
        # a level flips only where g32 / scale lies on a half-level
        assert np.all(np.abs(np.abs(we[flipped]) - scale / 2) <= tol), (
            we[flipped], scale)
        assert np.all(flipped.any(axis=0)[moved])  # a replica's flip
        n_el += e.numel()
        flips += int(flipped.sum())
    assert flips <= MAX_FLIPS * n_el, (flips, n_el)
    assert sum(float(e.abs().sum()) for e in errs) > 0


def test_compressed_dp_repeats_bit_for_bit(ref):
    cfg, tcfg, fresh, batch = _setup(ref)
    runs = []
    for _ in range(2):
        state = fresh()
        state["err"] = init_error_state(state["params"], 2)
        step = make_compressed_dp_train_step(cfg, tcfg,
                                             make_local_mesh(2, "cpu"))
        for _ in range(2):
            _, m = step(state, batch)
        runs.append((state, float(m["loss"])))
    (a, la), (b, lb) = runs
    assert la == lb
    for x, y in zip(TO.leaves(a["params"]) + TO.leaves(a["err"]),
                    TO.leaves(b["params"]) + TO.leaves(b["err"])):
        assert torch.equal(x, y)


def test_compress_mean_rule():
    """One leaf by hand: the shared scale, the clip at +-127, the residual,
    the mean of levels in replica order."""
    g = [torch.tensor([1.0, -2.0, 0.5]), torch.tensor([3.0, 0.0, -0.25])]
    e = [torch.zeros(3), torch.tensor([0.0, 1.0, 0.0])]
    g32 = [g[0] + e[0], g[1] + e[1]]
    mean = compress_mean([t.clone() for t in g], e)  # e updated in place
    scale = torch.tensor(3.0) / 127.0
    q = [torch.clamp(torch.round(t / scale), -127, 127) for t in g32]
    assert torch.equal(mean, (q[0] + q[1]) * (scale / 2.0))
    for t, qq, ee in zip(g32, q, e):
        assert torch.equal(ee, t - qq * scale)
    zero = compress_mean([torch.zeros(2) for _ in range(3)],
                         [torch.zeros(2) for _ in range(3)])
    assert torch.equal(zero, torch.zeros(2))  # the 1e-12 clamp: no NaN
    half = compress_mean([torch.tensor([1.0, 0.3], dtype=torch.bfloat16)],
                         [torch.zeros(2)])
    assert half.dtype == torch.bfloat16


def test_pipeline_matches_reference_and_sequential(ref):
    w = torch.from_numpy(ref["pipe_w"]).requires_grad_()
    xs = torch.from_numpy(ref["pipe_xs"])
    layer_fn = lambda p, x: torch.tanh(x @ p)
    fn = pipeline_apply(scan_stage(layer_fn), 4,
                        make_local_mesh(4, "cpu", names=("pipe", "data")),
                        "pipe")
    y = fn(stack_stages(w, 4), xs)
    np.testing.assert_allclose(y.detach().numpy(), ref["pipe_y"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ref["pipe_y"], ref["seq_y"], rtol=1e-5,
                               atol=1e-5)
    (g,) = torch.autograd.grad((y ** 2).sum(), w)
    np.testing.assert_allclose(g.numpy(), ref["seq_g"], rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("stages,micro", [(4, 6), (2, 3), (1, 2), (8, 1)])
def test_pipeline_equals_sequential_port(stages, micro):
    """The schedule alone: any stage and microbatch count gives the
    sequential stack's outputs and gradients."""
    g = torch.Generator().manual_seed(stages * 10 + micro)
    w = (torch.randn((8, 16, 16), generator=g) / 4).requires_grad_()
    xs = torch.randn((micro, 3, 16), generator=g)
    layer_fn = lambda p, x: torch.tanh(x @ p)
    fn = pipeline_apply(scan_stage(layer_fn), stages,
                        make_local_mesh(stages, "cpu", names=("pipe",)),
                        "pipe")
    y = fn(stack_stages(w, stages), xs)
    want = xs
    for i in range(8):
        want = layer_fn(w[i], want)
    torch.testing.assert_close(y, want, rtol=1e-6, atol=1e-6)
    (g1,) = torch.autograd.grad((y ** 2).sum(), w)
    (g2,) = torch.autograd.grad((want ** 2).sum(), w)
    torch.testing.assert_close(g1, g2, rtol=1e-5, atol=1e-6)


def test_pipeline_and_mesh_refusals():
    with pytest.raises(ValueError, match="stages"):
        stack_stages(torch.zeros(6, 2), 4)
    with pytest.raises(ValueError, match="positions"):
        pipeline_apply(lambda p, x: x, 4, make_local_mesh(2, "cpu",
                                                          names=("pipe",)),
                       "pipe")
    with pytest.raises(ValueError):
        make_local_mesh(0, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="GPU"):
            make_local_mesh()
