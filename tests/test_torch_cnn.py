"""The port's CNN slice (``core/cim_layer``, the conv and BN halves of
``core/quant`` and ``core/sparsity``, ``models/cnn``, the two CIFAR
configs, ``convert.cnn_params_from_numpy``) against the reference's, in one
process.

Inputs come from numpy seeds; both sides start from the reference's own
parameters, carried across by ``convert.cnn_params_from_numpy``.
Tolerances, each relative to the largest magnitude of the reference's
value (per leaf for gradients and parameters):

* one conv or linear (``conv_apply``, ``linear_apply``), dense or QAT, and
  the group lasso: 1e-5 in f32; only the order of f32 sums differs.
  Pruning masks, group-set statistics and the BN helpers on exact inputs
  are equal.
* the small VGG and ResNet (4 classes, 16x16, batch 16), logits, states,
  loss and gradients, and three SGD steps: 1e-4 in dense mode and in QAT
  (eq. 5 at 4 bits and eq. 8 read values that agree to a few ulps; a
  level would flip only where one straddles a half-level, which these
  seeds do not reach, and the check would catch it).
* the full-width nets at 32x32, batch 2: 1e-4 in dense mode; in QAT
  (w8a4, 13 and 20 convs of up to 2.4 M weights) each conv on the
  reference's input, since at these widths a weight whose eq. 8 value
  lies within an ulp of a half-level, where ``torch.tanh`` and XLA's
  differ, does flip a level (the test's docstring gives the bound).

JAX is imported only by the tests that compare against the reference; the
``cuda`` case runs on the card without it.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import resnet18_cifar as TRES
from repro_torch.configs import vgg16_cifar as TVGG
from repro_torch.core import cim_layer as TCL
from repro_torch.core import quant as TQ
from repro_torch.core import sparsity as TS
from repro_torch.data import ImagePipeline
from repro_torch.kernels import fake_quant as FQ
from repro_torch.kernels import ops
from repro_torch.models import cnn as TCNN

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

SMALL = dict(n_classes=4, batch=16, hw=16)


@pytest.fixture(autouse=True)
def _one_thread():
    """The port's side on one intra-op thread: at these sizes more threads
    only contend with the other test workers' (the setting is restored)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def R():
    """The reference's modules, imported on first use."""
    import jax
    import jax.numpy as jnp
    from repro.configs import resnet18_cifar as RRES
    from repro.configs import vgg16_cifar as RVGG
    from repro.core import cim_layer as CL
    from repro.core import quant as Q
    from repro.core import sparsity as S
    from repro.models import cnn as CNN
    return dict(jax=jax, jnp=jnp, CL=CL, Q=Q, S=S, CNN=CNN, RVGG=RVGG,
                RRES=RRES)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


def _close(got, want, tol, what=""):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    gap = float(np.abs(got - want).max(initial=0.0))
    assert gap <= tol * scale, f"{what}: {gap:.3e} > {tol} x {scale:.3e}"


def _ref_leaves(R, tree):
    """The reference tree's array leaves in the same order."""
    return [np.asarray(x) for x in R["jax"].tree.leaves(tree)
            if not isinstance(x, int)]


def _cim(w_bits=4, a_bits=4, lambda_g=1e-3, mode="qat", **sp):
    cim = TVGG.cim_config(w_bits=w_bits, a_bits=a_bits, lambda_g=lambda_g,
                          mode=mode)
    return dataclasses.replace(
        cim, sparsity=dataclasses.replace(cim.sparsity, **sp))


def _rcim(R, cim):
    """The reference's CIMConfig with the same fields."""
    RQ, RS, RCL = R["Q"], R["S"], R["CL"]
    return RCL.CIMConfig(quant=RQ.QuantConfig(**dataclasses.asdict(cim.quant)),
                         sparsity=RS.SparsityConfig(
                             **dataclasses.asdict(cim.sparsity)),
                         mode=cim.mode, bn_momentum=cim.bn_momentum)


# ---------------------------------------------------------------------------
# core/quant: the BN helpers
# ---------------------------------------------------------------------------


def test_batch_stats_and_ema_update_are_exact(R):
    """On small integers over 32 rows a channel every sum, the mean and the
    variance are exact in f32 on both sides, so the results are equal;
    the EMA is the same two f32 products and a sum."""
    rng = np.random.default_rng(0)
    y = rng.integers(-8, 9, (2, 4, 4, 6)).astype(np.float32)
    mean, var = TQ.batch_stats(_t(y))
    rmean, rvar = R["Q"].batch_stats(y)
    np.testing.assert_array_equal(_np(mean), np.asarray(rmean))
    np.testing.assert_array_equal(_np(var), np.asarray(rvar))
    # population variance (ddof 0), not torch.var's default
    assert not np.array_equal(_np(var), _np(_t(y).var(dim=(0, 1, 2))))
    old, new = (rng.standard_normal(6).astype(np.float32) for _ in range(2))
    for m in (0.9, 0.99, 0.5):
        np.testing.assert_array_equal(
            _np(TQ.ema_update(_t(old), _t(new), m)),
            np.asarray(R["Q"].ema_update(old, new, m)))


def test_clip_and_fold_input_scale_match_the_reference(R):
    """``Q.clip`` is ``jnp.clip`` in value and gradient: half the slope
    exactly on a bound, where ``torch.clamp`` passes the whole slope."""
    jax, jnp = R["jax"], R["jnp"]
    x = np.array([-0.5, 0.0, 0.25, 1.0, 1.5, -1.0, 0.999], np.float32)
    xt = _t(x).requires_grad_(True)
    TQ.clip(xt, 0.0, 1.0).sum().backward()
    want = jax.grad(lambda a: jnp.clip(a, 0.0, 1.0).sum())(x)
    np.testing.assert_array_equal(_np(xt.grad), np.asarray(want))
    assert _np(xt.grad)[3] == 0.5
    rng = np.random.default_rng(1)
    w_hat = rng.uniform(-1, 1, (3, 8, 5)).astype(np.float32)
    scale = rng.uniform(0.5, 2, (3, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        _np(TQ.fold_input_scale(_t(w_hat), _t(scale))),
        np.asarray(R["Q"].fold_input_scale(w_hat, scale)))


# ---------------------------------------------------------------------------
# core/sparsity: the conv half and the statistics
# ---------------------------------------------------------------------------

CONV_SHAPES = [(3, 3, 16, 32), (3, 3, 20, 24), (1, 1, 48, 16), (3, 3, 3, 64)]


@pytest.mark.parametrize("shape", CONV_SHAPES)
@pytest.mark.parametrize("n,alpha", [(16, 16), (4, 8), (1, 16)])
def test_group_lasso_conv(R, shape, n, alpha):
    w = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    _close(_np(TS.group_lasso_conv(_t(w), n, alpha)),
           R["S"].group_lasso_conv(w, n, alpha), 1e-6)


@pytest.mark.parametrize("lambda_l2", [0.0, 1e-3])
def test_regularization_over_2_3_and_4_dim_leaves(R, lambda_l2):
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((40, 24)).astype(np.float32),
            "b": {"c": rng.standard_normal((3, 32, 48)).astype(np.float32),
                  "d": rng.standard_normal((3, 3, 20, 24)).astype(np.float32),
                  "e": rng.standard_normal((24,)).astype(np.float32)},
            "f": np.arange(6, dtype=np.int32).reshape(2, 3)}
    cfg = dict(alpha=8, n=4, lambda_g=1e-3, lambda_l2=lambda_l2)
    got = TS.regularization({"a": _t(tree["a"]), "b": {
        k: _t(v) for k, v in tree["b"].items()}, "f": _t(tree["f"])},
        TS.SparsityConfig(**cfg))
    want = R["S"].regularization(
        R["jax"].tree.map(R["jnp"].asarray, tree),
        R["S"].SparsityConfig(**cfg))
    _close(_np(got), want, 1e-6)


@pytest.mark.parametrize("shape", CONV_SHAPES)
@pytest.mark.parametrize("target", [0.0, -1.0, 0.3, 0.6, 0.7, 0.95])
def test_prune_mask_conv_equals_the_reference(R, shape, target):
    w = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    got = _np(TS.prune_mask_conv(_t(w), 16, 16, target))
    want = np.asarray(R["S"].prune_mask_conv(w, 16, 16, target))
    np.testing.assert_array_equal(got, want)
    if target <= 0.0:
        assert got.all()  # no pruning reachable
    else:
        assert not got.all()


def test_groupset_statistics_equal_the_reference(R):
    rng = np.random.default_rng(5)
    RS = R["S"]
    for shape, group, alpha in (((64, 48), 16, 16), ((40, 24), 16, 16),
                                ((96, 64), 8, 16)):
        w = rng.standard_normal(shape).astype(np.float32)
        mask = np.asarray(RS.prune_mask_2d(w, group, alpha, 0.5))
        m = _t(mask)
        assert float(TS.sparsity_ratio(m)) == float(RS.sparsity_ratio(mask))
        assert float(TS.zero_groupset_proportion(m, group, alpha)) == float(
            RS.zero_groupset_proportion(mask, group, alpha))
        assert int(TS.index_storage_bits(m, group, alpha)) == int(
            RS.index_storage_bits(mask, group, alpha))
        for bits in (4, 8):
            assert int(TS.weight_storage_bits(m, group, alpha, bits)) == int(
                RS.weight_storage_bits(mask, group, alpha, bits))
    for sp, bits in ((0.0, 8), (0.7, 4), (1.0, 8)):
        assert TS.compression_rate(sp, bits) == RS.compression_rate(sp, bits)


def test_apply_mask_equals_the_reference(R):
    rng = np.random.default_rng(6)
    params = {"a": rng.standard_normal((4, 5)).astype(np.float32),
              "b": [rng.standard_normal((3,)).astype(np.float32),
                    rng.standard_normal((2, 2)).astype(np.float32)]}
    masks = {"a": (rng.random((4, 5)) > 0.5).astype(np.float32),
             "b": [None, (rng.random((2, 2)) > 0.5).astype(np.float32)]}
    got = TS.apply_mask(
        {"a": _t(params["a"]), "b": [_t(p) for p in params["b"]]},
        {"a": _t(masks["a"]), "b": [None, _t(masks["b"][1])]})
    want = R["S"].apply_mask(params, masks)
    for g, w in zip(TS.tensor_leaves(got), R["jax"].tree.leaves(want)):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


# ---------------------------------------------------------------------------
# core/cim_layer: the linear half
# ---------------------------------------------------------------------------

LINEAR_CASES = {
    "dense": dict(mode="dense"),
    "w8a8": dict(w_bits=8, a_bits=8),
    "w4a4-mask": dict(w_bits=4, a_bits=4, mask=True),
    "w8a8-norm-scale": dict(w_bits=8, a_bits=8, norm=True),
    "w32a32-norm-scale": dict(w_bits=32, a_bits=32, norm=True),
    "w4a4-signed-bias": dict(w_bits=4, a_bits=4, signed=True, bias=True),
}


@pytest.mark.parametrize("stacked", [False, True], ids=["2d", "stacked3d"])
@pytest.mark.parametrize("case", sorted(LINEAR_CASES))
def test_linear_half_matches_the_reference(R, case, stacked):
    """effective_weight, linear_apply (and its gradients), the regularizer
    and the pruned mask, for a 2-D weight and a 3-D layer stack."""
    jax, RCL = R["jax"], R["CL"]
    c = LINEAR_CASES[case]
    cim = _cim(w_bits=c.get("w_bits", 8), a_bits=c.get("a_bits", 8),
               mode=c.get("mode", "qat"), lambda_l2=1e-4, alpha=16, n=8,
               target_sparsity=0.5)
    cim = dataclasses.replace(cim, quant=dataclasses.replace(
        cim.quant, a_signed=c.get("signed", False)))
    rcim = _rcim(R, cim)
    rng = np.random.default_rng(7)
    lead = (3,) if stacked else ()
    d_in, d_out = 48, 32
    p = {"w": rng.standard_normal(lead + (d_in, d_out)).astype(np.float32)}
    if c.get("bias"):
        p["b"] = rng.standard_normal((d_out,)).astype(np.float32)
    if c.get("mask"):
        p["mask"] = (rng.random(lead + (d_in, d_out)) > 0.3).astype(
            np.float32)
    norm = (rng.uniform(0.5, 1.5, lead + (d_in,)).astype(np.float32)
            if c.get("norm") else None)
    x = rng.uniform(-0.3, 1.2, lead + (5, d_in)).astype(np.float32)
    tp = {k: _t(v) for k, v in p.items()}
    tnorm = None if norm is None else _t(norm)
    _close(_np(TCL.effective_weight(tp, cim, tnorm)),
           RCL.effective_weight(p, rcim, norm), 1e-6, "effective_weight")

    def ref(w, x):
        return (RCL.linear_apply(dict(p, w=w), x, rcim, norm) * r).sum()

    r = rng.standard_normal(lead + (5, d_out)).astype(np.float32)
    want_y = RCL.linear_apply(p, x, rcim, norm)
    gw, gx = jax.jit(jax.grad(ref, argnums=(0, 1)))(p["w"], x)
    tw, tx = _t(p["w"]).requires_grad_(True), _t(x).requires_grad_(True)
    y = TCL.linear_apply(dict(tp, w=tw), tx, cim, tnorm)
    (y * _t(r)).sum().backward()
    _close(_np(y), want_y, 1e-5, "y")
    _close(_np(tw.grad), gw, 1e-5, "dw")
    _close(_np(tx.grad), gx, 1e-5, "dx")
    _close(_np(TCL.linear_regularizer(tp, cim)),
           RCL.linear_regularizer(p, rcim), 1e-6, "regularizer")
    pruned = TCL.linear_prune(tp, cim)
    np.testing.assert_array_equal(_np(pruned["mask"]), np.asarray(
        RCL.linear_prune(p, rcim)["mask"]))
    assert ("mask" in tp) == bool(c.get("mask"))  # the input dict is kept


def test_linear_init_shapes_and_scale():
    gen = torch.Generator().manual_seed(0)
    p = TCL.linear_init(gen, 256, 64, TCL.DENSE.with_mode("qat"), bias=True,
                        device="cpu")
    assert p["w"].shape == (256, 64) and p["b"].shape == (64,)
    assert torch.equal(p["mask"], torch.ones(256, 64))
    assert abs(float(p["w"].std()) - 1 / 16) < 0.005
    assert "mask" not in TCL.linear_init(gen, 4, 4, TCL.DENSE, device="cpu")


def test_entry_points_take_the_gpu_by_default():
    """``device=None`` means CUDA: without a GPU the init raises rather
    than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="GPU"):
        TCNN.vgg_init(gen, _cim(), TVGG.SMALL_PLAN)
    with pytest.raises(RuntimeError, match="GPU"):
        convert.cnn_params_from_numpy({"convs": []}, {"convs": []})


# ---------------------------------------------------------------------------
# core/cim_layer: the conv half
# ---------------------------------------------------------------------------

# (kernel, stride, input size): 3x3 and 1x1, strides 1 and 2, odd and even
CONV_GEOMS = [(3, 1, 8), (3, 2, 8), (3, 2, 7), (1, 2, 8), (1, 1, 7)]


def _conv_case(rng, k, size, cin=16, cout=32, batch=4):
    w = (rng.standard_normal((k, k, cin, cout))
         * (2.0 / (k * k * cin)) ** 0.5).astype(np.float32)
    p = {"w": w, "gamma": rng.uniform(0.5, 1.5, cout).astype(np.float32),
         "beta": rng.uniform(-0.3, 0.3, cout).astype(np.float32),
         "mask": (rng.random(w.shape) > 0.2).astype(np.float32)}
    s = {"mean": rng.uniform(-0.2, 0.2, cout).astype(np.float32),
         "var": rng.uniform(0.3, 2.0, cout).astype(np.float32)}
    x = rng.uniform(-0.2, 1.2, (batch, size, size, cin)).astype(np.float32)
    return p, s, x


@pytest.mark.parametrize("geom", CONV_GEOMS,
                         ids=[f"k{k}s{s}n{n}" for k, s, n in CONV_GEOMS])
@pytest.mark.parametrize("bn", [True, False], ids=["bn", "nobn"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("mode", ["dense", "qat"])
def test_conv_apply_matches_the_reference(R, mode, train, bn, geom):
    """Outputs and new state within 1e-5, and the gradients of w, gamma,
    beta and x against ``jax.grad``, within 1e-5 of max |ref|."""
    jax, RCL = R["jax"], R["CL"]
    k, stride, size = geom
    rng = np.random.default_rng(8)
    p, s, x = _conv_case(rng, k, size)
    if not bn:
        p = {"w": p["w"], "mask": p["mask"]}
        s = {}
    if mode == "dense":
        p.pop("mask")
    cim = _cim(w_bits=8, a_bits=4, mode=mode)
    rcim = _rcim(R, cim)
    names = [n for n in ("w", "gamma", "beta") if n in p]
    shape = jax.eval_shape(lambda: RCL.conv_apply(
        p, s, x, rcim, stride=stride, train=train)[0]).shape
    r = rng.standard_normal(shape).astype(np.float32)

    def ref(*args):
        q = dict(p, **dict(zip(names, args[:-1])))
        y, st = RCL.conv_apply(q, s, args[-1], rcim, stride=stride,
                               train=train)
        return (y * r).sum(), (y, st)

    (_, (want_y, want_s)), want_g = jax.jit(jax.value_and_grad(
        ref, argnums=tuple(range(len(names) + 1)), has_aux=True))(
        *[p[n] for n in names], x)
    tp = {n: _t(v).requires_grad_(n in names) for n, v in p.items()}
    tx = _t(x).requires_grad_(True)
    y, st = TCL.conv_apply(tp, {n: _t(v) for n, v in s.items()}, tx, cim,
                           stride=stride, train=train)
    (y * _t(r)).sum().backward()
    _close(_np(y), want_y, 1e-5, "y")
    assert sorted(st) == sorted(want_s)
    for n in st:
        assert not st[n].requires_grad
        _close(_np(st[n]), want_s[n], 1e-5, n)
    for n, g in zip(names + ["x"], want_g):
        got = tx.grad if n == "x" else tp[n].grad
        _close(_np(got), g, 1e-5, f"d{n}")
    if "mask" in tp:
        assert tp["mask"].grad is None


def test_same_padding_with_stride_2_pads_after(R):
    """XLA's "SAME" at stride 2 on an even size pads (0, 1): a symmetric
    padding of 1 gives another output."""
    import torch.nn.functional as F
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 4)).astype(np.float32)
    got = TCL._conv(_t(x), _t(w), 2)
    want = R["CL"]._conv(x, w, 2)
    _close(_np(got), want, 1e-6)
    sym = F.conv2d(_t(x).permute(0, 3, 1, 2), _t(w).permute(3, 2, 0, 1),
                   stride=2, padding=1).permute(0, 2, 3, 1)
    assert float(np.abs(_np(sym) - np.asarray(want)).max()) > 1.0
    for size in (1, 2, 5, 6, 7, 8):
        for kk in (1, 2, 3, 5):
            for st in (1, 2, 3):
                xs = rng.standard_normal((1, size, size + 1, 2)).astype(
                    np.float32)
                ws = rng.standard_normal((kk, kk, 2, 3)).astype(np.float32)
                _close(_np(TCL._conv(_t(xs), _t(ws), st)),
                       R["CL"]._conv(xs, ws, st), 1e-5, (size, kk, st))


def test_eq7_clip_tie_takes_half_the_slope(R):
    """In eval mode with gamma 1 and var + eps exactly 1 in f32, eq. 7's
    scale is exactly 1, so each column group's largest |w_hat| (exactly 1
    after eq. 6) lands exactly on the clip's bound: there the reference's
    ``jnp.clip`` passes half the gradient, and so must the kernel's
    clamped straight-through rule. The tie shows in gamma's gradient (eq.
    7's scale multiplies w_hat); w's gradient does not see it, since a
    group's largest w_hat is its own denominator."""
    jax, RCL = R["jax"], R["CL"]
    rng = np.random.default_rng(10)
    p, s, x = _conv_case(rng, 3, 6)
    cim = _cim(w_bits=8, a_bits=4)
    rcim = _rcim(R, cim)
    eps = np.float32(cim.quant.eps)
    s["var"] = np.full_like(s["var"], np.float32(1.0) - eps)
    assert np.all(s["var"] + eps == np.float32(1.0))
    p["gamma"] = np.ones_like(p["gamma"])
    ties = np.abs(np.asarray(R["Q"].tanh_normalize(
        (p["w"] * p["mask"]).reshape(-1, 32), 16))) == 1.0
    assert ties.sum() >= 2
    r = rng.standard_normal((4, 6, 6, 32)).astype(np.float32)
    want = jax.grad(lambda w, g: (RCL.conv_apply(dict(p, w=w, gamma=g), s,
                                                 x, rcim)[0] * r).sum(),
                    argnums=(0, 1))(p["w"], p["gamma"])
    tw = _t(p["w"]).requires_grad_(True)
    tg = _t(p["gamma"]).requires_grad_(True)
    y, _ = TCL.conv_apply(dict({k: _t(v) for k, v in p.items()}, w=tw,
                               gamma=tg),
                          {k: _t(v) for k, v in s.items()}, _t(x), cim)
    (y * _t(r)).sum().backward()
    _close(_np(tw.grad), want[0], 1e-5, "dw")
    _close(_np(tg.grad), want[1], 1e-5, "dgamma")


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_post_relu_clip_tie_takes_half_the_slope(R, train):
    """The first conv's gamma is 0, so its output is its beta exactly:
    channels at 1.0 (the clip's tie), 0.5 (inside) and 1.5 (clipped). Its
    beta's gradient through VGG's post-ReLU clip is the reference's, half
    the slope on the tie (``torch.clamp`` would pass all of it)."""
    jax, RCNN = R["jax"], R["CNN"]
    cim = _cim()
    rcim = _rcim(R, cim)
    rp, rs = _ref_small(R, "vgg", rcim)
    beta = np.tile(np.array([1.0, 0.5, 1.5, 1.0], np.float32), 8)
    rp["convs"][0] = dict(rp["convs"][0], beta=beta,
                          gamma=np.zeros_like(beta))
    images, labels = _batch()
    plan = R["RVGG"].SMALL_PLAN

    def ref(b):
        q = dict(rp, convs=[dict(rp["convs"][0], beta=b)] + rp["convs"][1:])
        logits, _ = RCNN.vgg_apply(q, rs, images, rcim, plan, train=train)
        return _ce(R, logits, labels)

    want = jax.jit(jax.grad(ref))(beta)
    tp, ts = convert.cnn_params_from_numpy(rp, rs, "cpu")
    tb = tp["convs"][0]["beta"].requires_grad_(True)
    logits, _ = TCNN.vgg_apply(tp, ts, _t(images), cim, TVGG.SMALL_PLAN,
                               train=train)
    _tce(logits, _t(labels)).backward()
    _close(_np(tb.grad), want, 1e-5, "dbeta")
    assert np.all(_np(tb.grad)[2::4] == 0.0)  # clipped channels: no slope
    with torch.no_grad():  # a full-slope clamp would differ on the ties
        assert float(tb.grad[0::4].abs().max()) > 0.0


@pytest.mark.parametrize("k", [3, 1])
def test_conv_regularizer_and_prune_match_the_reference(R, k):
    rng = np.random.default_rng(11)
    p, _, _ = _conv_case(rng, k, 4, cin=48, cout=32)
    cim = _cim(lambda_l2=1e-4, target_sparsity=0.6)
    rcim = _rcim(R, cim)
    tp = {n: _t(v) for n, v in p.items()}
    _close(_np(TCL.conv_regularizer(tp, cim)),
           R["CL"].conv_regularizer(p, rcim), 1e-6)
    pruned = TCL.conv_prune(tp, cim)
    np.testing.assert_array_equal(_np(pruned["mask"]), np.asarray(
        R["CL"].conv_prune(p, rcim)["mask"]))
    np.testing.assert_array_equal(_np(tp["mask"]), p["mask"])


def test_conv_init_shapes_and_scales():
    gen = torch.Generator().manual_seed(0)
    p, s = TCL.conv_init(gen, 3, 3, 64, 128, _cim(), device="cpu")
    assert p["w"].shape == (3, 3, 64, 128)
    assert abs(float(p["w"].std()) - (2 / 576) ** 0.5) < 0.002
    assert torch.equal(p["gamma"], torch.ones(128))
    assert torch.equal(p["beta"], torch.zeros(128))
    assert torch.equal(s["var"], torch.ones(128))
    assert torch.equal(p["mask"], torch.ones(3, 3, 64, 128))
    p, s = TCL.conv_init(gen, 1, 1, 8, 16, TCL.DENSE, with_bn=False,
                         device="cpu")
    assert sorted(p) == ["w"] and s == {}


# ---------------------------------------------------------------------------
# models/cnn: the small nets against the reference
# ---------------------------------------------------------------------------


def _batch(seed=0):
    b = ImagePipeline(**SMALL, seed=seed).next_batch()
    return b["images"], b["labels"]


def _ce(R, logits, labels):
    jax, jnp = R["jax"], R["jnp"]
    return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits),
                                         labels[:, None], 1))


def _tce(logits, labels):
    return -torch.log_softmax(logits, -1).gather(
        1, labels.long()[:, None]).mean()


def _ref_small(R, net, rcim, perturb=True):
    """The reference's small net (numpy leaves), its BN parameters and
    state moved off their initial values so that eval mode fuses
    non-trivial statistics."""
    jax = R["jax"]
    if net == "vgg":
        p, s = R["CNN"].vgg_init(jax.random.PRNGKey(0), rcim,
                                 R["RVGG"].SMALL_PLAN, n_classes=4)
    else:
        p, s = R["CNN"].resnet_init(jax.random.PRNGKey(0), rcim,
                                    R["RRES"].SMALL_STAGES, n_classes=4)
    p, s = _np_tree(R, (p, s))
    if perturb:
        _perturb(R, p, s, np.random.default_rng(12))
    return p, s


def _perturb(R, p, s, rng):
    """BN's parameters and state (numpy trees, in place) moved off their
    initial values."""
    for conv, st in zip(R["CNN"].iter_conv_params(p), _iter_states(s)):
        c = conv["gamma"].shape[0]
        conv["gamma"] = rng.uniform(0.6, 1.4, c).astype(np.float32)
        conv["beta"] = rng.uniform(-0.2, 0.2, c).astype(np.float32)
        st["mean"] = rng.uniform(-0.3, 0.3, c).astype(np.float32)
        st["var"] = rng.uniform(0.5, 3.0, c).astype(np.float32)


def _np_tree(R, tree):
    """numpy leaves; ResNet's strides stay Python ints."""
    return R["jax"].tree.map(
        lambda a: a if isinstance(a, int) else np.asarray(a), tree)


def _iter_states(s):
    if "convs" in s:
        yield from (x for x in s["convs"] if x is not None)
    else:
        yield s["stem"]
        for b in s["blocks"]:
            yield b["conv1"]
            yield b["conv2"]
            if "down" in b:
                yield b["down"]


def _ref_loss(R, net, rcim, strides, train=True):
    """test_system's loss (ce + regularization) on the reference; ResNet's
    strides are held static by the closure, since ``jax.grad`` cannot
    take a tree with Python ints."""
    CNN = R["CNN"]

    def loss(p, s, images, labels):
        if net == "vgg":
            logits, s2 = CNN.vgg_apply(p, s, images, rcim,
                                       R["RVGG"].SMALL_PLAN, train=train)
        else:
            logits, s2 = CNN.resnet_apply(_with_strides(p, strides), s,
                                          images, rcim, train=train)
        ce = _ce(R, logits, labels)
        return ce + CNN.regularization(p, rcim), (ce, s2, logits)
    return loss


def _with_strides(p, strides):
    """A ResNet tree (stripped by ``_strip``) with its strides back."""
    if "blocks" not in p:
        return p
    return dict(p, blocks=[dict(b, stride=st) for b, st in
                           zip(p["blocks"], strides)])


def _strip(p):
    """A ResNet tree without its ints, for ``jax.grad``."""
    if "blocks" not in p:
        return p
    return dict(p, blocks=[{k: v for k, v in b.items() if k != "stride"}
                           for b in p["blocks"]])


def _apply(net, cim, train):
    if net == "vgg":
        return lambda p, s, x: TCNN.vgg_apply(p, s, x, cim, TVGG.SMALL_PLAN,
                                              train=train)
    return lambda p, s, x: TCNN.resnet_apply(p, s, x, cim, train=train)


def _port_loss(net, cim, train=True):
    apply = _apply(net, cim, train)

    def loss(p, s, images, labels):
        logits, s2 = apply(p, s, images)
        ce = _tce(logits, labels)
        return ce + TCNN.regularization(p, cim), (ce, s2, logits)
    return loss


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("mode", ["dense", "qat"])
@pytest.mark.parametrize("net", ["vgg", "resnet"])
def test_small_net_matches_the_reference(R, net, mode, train):
    """Logits, new states and test_system's loss (ce + regularization)
    within 1e-4 of max |ref|; in train mode its gradient for every
    parameter too (eval mode's are held conv by conv above)."""
    jax = R["jax"]
    cim = _cim(mode=mode)
    rcim = _rcim(R, cim)
    rp, rs = _ref_small(R, net, rcim)
    images, labels = _batch()
    rloss = _ref_loss(R, net, rcim,
                      [b["stride"] for b in rp.get("blocks", [])], train)
    tp, ts = convert.cnn_params_from_numpy(rp, rs, "cpu")
    if train:
        (want_loss, (_, want_s, want_logits)), want_g = jax.jit(
            jax.value_and_grad(rloss, has_aux=True))(_strip(rp), rs, images,
                                                     labels)
        out, (_, st, logits), g = TCNN.grads(_port_loss(net, cim, train), tp,
                                         ts, _t(images), _t(labels))
    else:
        want_loss, (_, want_s, want_logits) = jax.jit(rloss)(
            _strip(rp), rs, images, labels)
        with torch.no_grad():
            out, (_, st, logits) = _port_loss(net, cim, train)(
                tp, ts, _t(images), _t(labels))
    _close(_np(logits), want_logits, 1e-4, "logits")
    _close(_np(out), want_loss, 1e-5, "loss")
    for a, b in zip(TS.tensor_leaves(st), _ref_leaves(R, want_s), strict=True):
        _close(_np(a), b, 1e-4, "state")
    if not train:
        return
    names = [t for t in TS.tensor_leaves(tp) if t.is_floating_point()]
    rg = _ref_leaves(R, want_g)
    assert len(rg) == len(names) == len(g)
    for i, (a, b) in enumerate(zip(g, rg)):
        if a is None:  # a mask: the reference's gradient is 0
            assert not np.any(b), i
            continue
        _close(_np(a), b, 1e-4, f"grad leaf {i}")


def test_iter_conv_params_order_and_prune_all(R):
    """Both nets: the convs in the reference's order; prune_all's masks
    equal to the reference's and its input tree untouched."""
    for net in ("vgg", "resnet"):
        cim = _cim(target_sparsity=0.6)
        rcim = _rcim(R, cim)
        rp, rs = _ref_small(R, net, rcim)
        tp, _ = convert.cnn_params_from_numpy(rp, rs, "cpu")
        assert [tuple(p["w"].shape) for p in TCNN.iter_conv_params(tp)] == [
            tuple(p["w"].shape) for p in R["CNN"].iter_conv_params(rp)]
        before = [t.clone() for t in TS.tensor_leaves(tp)]
        pruned = TCNN.prune_all(tp, cim)
        assert all(torch.equal(a, b)
                   for a, b in zip(before, TS.tensor_leaves(tp)))
        want = R["CNN"].prune_all(rp, rcim)
        for a, b in zip(TCNN.iter_conv_params(pruned),
                        R["CNN"].iter_conv_params(want), strict=True):
            np.testing.assert_array_equal(_np(a["mask"]),
                                          np.asarray(b["mask"]))
            assert not a["mask"].all()
        if net == "resnet":
            assert [b["stride"] for b in pruned["blocks"]] == [1, 2]
            assert all(isinstance(b["stride"], int) for b in tp["blocks"])


def _sgd(loss, p, s, images, labels):
    """The reference's update through ``cnn.sgd_step``: (params, state,
    ce)."""
    p, (ce, s2, _) = TCNN.sgd_step(loss, p, s, images, labels)
    return p, s2, float(ce.detach())


@pytest.mark.parametrize("net", ["vgg", "resnet"])
def test_three_sgd_steps_match_the_reference(R, net):
    """Three steps of test_system's update (w4a4, lambda_g 1e-3) against
    the reference's jitted step: ce of each step, then every parameter
    and BN state leaf within 1e-4 of max |ref|."""
    jax = R["jax"]
    cim = _cim()
    rcim = _rcim(R, cim)
    rp, rs = _ref_small(R, net, rcim, perturb=False)
    strides = [b["stride"] for b in rp.get("blocks", [])]
    rloss = _ref_loss(R, net, rcim, strides)

    @jax.jit
    def step(p, s, images, labels):
        (_, (ce, s2, _)), g = jax.value_and_grad(rloss, has_aux=True)(
            p, s, images, labels)
        return jax.tree.map(lambda a, b: a - 0.05 * b, p, g), s2, ce

    tp, ts = convert.cnn_params_from_numpy(rp, rs, "cpu")
    loss = _port_loss(net, cim)
    p = _strip(rp)
    pipe = ImagePipeline(**SMALL)
    for _ in range(3):
        b = pipe.next_batch()
        p, rs, rce = step(p, rs, b["images"], b["labels"])
        tp, ts, tce = _sgd(loss, tp, ts, _t(b["images"]), _t(b["labels"]))
        assert abs(tce - float(rce)) <= 1e-5 * abs(float(rce))
    for a, b in zip(TS.tensor_leaves(tp), _ref_leaves(R, p), strict=True):
        _close(_np(a), b, 1e-4, "param")
    for a, b in zip(TS.tensor_leaves(ts), _ref_leaves(R, rs), strict=True):
        _close(_np(a), b, 1e-4, "state")


def _ref_full(R, net, rcim):
    jax = R["jax"]
    key = jax.random.PRNGKey(1)
    if net == "vgg":
        p, s = R["CNN"].vgg_init(key, rcim, R["RVGG"].FULL_PLAN)
    else:
        p, s = R["CNN"].resnet_init(key, rcim, R["RRES"].FULL_STAGES)
    return _np_tree(R, (p, s))


def _full_images():
    return ImagePipeline(n_classes=10, batch=2, hw=32).next_batch()["images"]


@pytest.mark.parametrize("net", ["vgg", "resnet"])
def test_full_width_dense_forward_matches_the_reference(R, net):
    """The paper's VGG16 and ResNet18 at 32x32, batch 2, dense mode, train
    mode (batch statistics): logits and new states within 1e-4."""
    cim = TVGG.cim_config(mode="dense")
    rp, rs = _ref_full(R, net, _rcim(R, cim))
    x = _full_images()
    strides = [b["stride"] for b in rp.get("blocks", [])]
    tp, ts = convert.cnn_params_from_numpy(rp, rs, "cpu")
    rapply = (R["CNN"].vgg_apply if net == "vgg" else R["CNN"].resnet_apply)
    tapply = (TCNN.vgg_apply if net == "vgg" else TCNN.resnet_apply)
    rcim = _rcim(R, cim)
    want, want_s = R["jax"].jit(lambda p, s, x: rapply(
        _with_strides(p, strides), s, x, rcim, train=True))(
        _strip(rp), rs, x)
    with torch.no_grad():
        got, st = tapply(tp, ts, _t(x), cim, train=True)
    _close(_np(got), want, 1e-4, "logits")
    for a, b in zip(TS.tensor_leaves(st), _ref_leaves(R, want_s), strict=True):
        _close(_np(a), b, 1e-4, "state")
    assert len(list(TCNN.iter_conv_params(tp))) == (13 if net == "vgg"
                                                    else 20)


HALF_LEVEL_BAND = 2.5e-4


@pytest.mark.parametrize("net", ["vgg", "resnet"])
def test_full_width_qat_convs_match_the_reference(R, net, monkeypatch):
    """The paper's nets at 32x32, batch 2, QAT w8a4 (eval mode, BN moved off
    its initial values so that eq. 7 clips): every conv fed the input the
    reference's forward gave it. ``torch.tanh`` and XLA's differ by an ulp
    in about half the weights, and at these widths a few of those lie
    within an ulp of an eq. 8 half-level: there the levels differ by 1 (in
    under 1e-5 of the weights, against the reference's formula in numpy).
    A level can differ only where eq. 8's argument (at most 127 here) lies
    within HALF_LEVEL_BAND of a half-level: about four times the
    frameworks' largest gap there (a few ulps of w_hat and of eq. 7's
    scale, whose rsqrt XLA may round otherwise, times 127). Each conv's
    output is within 1e-5 of max |ref|, plus 2^-7 (a level's weight; |eq. 5
    x| < 1) for each weight of its worst output column in that band. The
    whole forward then drifts (a flipped level moves eq. 5 levels
    downstream), so it is checked for shape and finiteness only."""
    RQ = R["Q"]
    cim = TVGG.cim_config()
    rcim = _rcim(R, cim)
    rp, rs = _ref_full(R, net, rcim)
    _perturb(R, rp, rs, np.random.default_rng(13))
    traced, strides = [], []
    conv_apply = R["CL"].conv_apply

    def recording(p, s, x, c, stride=1, padding="SAME", train=False):
        y, s2 = conv_apply(p, s, x, c, stride, padding, train)
        traced.append((x, y))
        strides.append(stride)
        return y, s2

    monkeypatch.setattr(R["CL"], "conv_apply", recording)
    rapply = (R["CNN"].vgg_apply if net == "vgg" else R["CNN"].resnet_apply)
    block_strides = [b["stride"] for b in rp.get("blocks", [])]

    def forward(p, s, x):
        logits, _ = rapply(_with_strides(p, block_strides), s, x, rcim)
        return logits, traced
    want, seen = R["jax"].jit(forward)(_strip(rp), rs, _full_images())
    monkeypatch.undo()
    calls = [(np.asarray(x), st, np.asarray(y))
             for (x, y), st in zip(seen, strides)]
    tp, ts = convert.cnn_params_from_numpy(rp, rs, "cpu")
    convs = list(zip(TCNN.iter_conv_params(tp), _iter_states(ts)))
    assert len(calls) == len(convs) == (13 if net == "vgg" else 20)
    flips = n_weights = 0
    eps, qmax = cim.quant.eps, 2.0 ** (cim.quant.w_bits - 1) - 1.0
    for (x, stride, y), (p, s) in zip(calls, convs):
        with torch.no_grad():
            got, _ = TCL.conv_apply(p, s, _t(x), cim, stride=stride)
        co = p["w"].shape[-1]
        w = _np(p["w"] * p["mask"]).reshape(-1, co)
        scale = _np(p["gamma"]) / np.sqrt(_np(s["var"]) + np.float32(eps))
        lev_r = np.round(np.clip(np.asarray(RQ.tanh_normalize(w, 16))
                                 * scale, -1, 1) * qmax)
        lev_t = _np(torch.round(TQ.clip(TQ.tanh_normalize(_t(w), 16)
                                        * _t(scale), -1, 1) * qmax))
        assert np.abs(lev_t - lev_r).max() <= 1
        flips += int((lev_t != lev_r).sum())
        n_weights += w.size
        arg = np.abs(np.clip(np.asarray(RQ.tanh_normalize(w, 16)) * scale,
                             -1, 1) * qmax)
        near = np.abs(arg - np.floor(arg) - 0.5) < HALF_LEVEL_BAND
        bound = 1e-5 * np.abs(y).max() + near.sum(axis=0).max() * 2.0 ** -(
            cim.quant.w_bits - 1)
        assert np.abs(_np(got) - y).max() <= bound
    assert flips <= 1e-5 * n_weights, (flips, n_weights)
    tapply = (TCNN.vgg_apply if net == "vgg" else TCNN.resnet_apply)
    with torch.no_grad():
        logits, _ = tapply(tp, ts, _t(_full_images()), cim)
    assert logits.shape == np.shape(want) and bool(logits.isfinite().all())


def test_cnn_params_from_numpy_keeps_the_tree(R):
    rcim = _rcim(R, _cim())
    rp, rs = _ref_small(R, "resnet", rcim, perturb=False)
    tp, ts = convert.cnn_params_from_numpy(rp, rs, "cpu")
    assert [b["stride"] for b in tp["blocks"]] == [1, 2]
    assert all(type(b["stride"]) is int for b in tp["blocks"])
    assert sorted(tp["blocks"][1]) == ["conv1", "conv2", "down", "stride"]
    vp, vs = convert.cnn_params_from_numpy(*_ref_small(R, "vgg", rcim, False),
                                           "cpu")
    assert [p is None for p in vp["convs"]] == [
        v == "M" for v in TVGG.SMALL_PLAN]
    assert [s is None for s in vs["convs"]] == [
        v == "M" for v in TVGG.SMALL_PLAN]
    for a, b in zip(TS.tensor_leaves((tp, ts)), _ref_leaves(R, (rp, rs)),
                    strict=True):
        np.testing.assert_array_equal(_np(a), b)
    # numpy 0-d strides (np.asarray on every leaf) come back as ints
    tp2, _ = convert.cnn_params_from_numpy(
        R["jax"].tree.map(np.asarray, rp), rs, "cpu")
    assert [type(b["stride"]) for b in tp2["blocks"]] == [int, int]


def test_configs_carry_the_papers_defaults():
    for mod, full in ((TVGG, TVGG.FULL_PLAN), (TRES, TRES.FULL_STAGES)):
        cim = mod.cim_config()
        assert (cim.mode, cim.quant.w_bits, cim.quant.a_bits,
                cim.quant.group_size) == ("qat", 8, 4, 16)
        assert (cim.sparsity.alpha, cim.sparsity.n,
                cim.sparsity.lambda_g) == (16, 16, 1e-4)
        assert full
    assert TVGG.FULL_PLAN == TCNN.VGG16_CFG
    assert TRES.FULL_STAGES == TCNN.RESNET18_STAGES


def test_configs_equal_the_references(R):
    for mod, rmod in ((TVGG, R["RVGG"]), (TRES, R["RRES"])):
        for kw in ({}, dict(w_bits=4, a_bits=4, lambda_g=1e-3),
                   dict(mode="dense", alpha=8, n=4)):
            a, b = mod.cim_config(**kw), rmod.cim_config(**kw)
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert R["RVGG"].FULL_PLAN == TVGG.FULL_PLAN
    assert R["RVGG"].SMALL_PLAN == TVGG.SMALL_PLAN
    assert [tuple(s) for s in R["RRES"].FULL_STAGES] == [
        tuple(s) for s in TRES.FULL_STAGES]
    assert [tuple(s) for s in R["RRES"].SMALL_STAGES] == [
        tuple(s) for s in TRES.SMALL_STAGES]


# ---------------------------------------------------------------------------
# The reference's CNN pipeline test, on the port
# ---------------------------------------------------------------------------


def test_cnn_qat_prune_deploy_pipeline():
    """test_system.test_cnn_qat_prune_deploy_pipeline on the port alone
    (its own weights from a torch seed): QAT + lasso learns, pruning
    leaves skippable group-sets, masked weights stay dead through
    retraining, and the deepest conv deployed through ops.bsr_matmul
    equals x @ w2d."""
    cim = _cim(lambda_g=1e-3)
    gen = torch.Generator().manual_seed(0)
    params, state = TCNN.vgg_init(gen, cim, TVGG.SMALL_PLAN, n_classes=4,
                                  device="cpu")
    pipe = ImagePipeline(**SMALL)
    loss = _port_loss("vgg", cim)

    def step(p, s):
        b = pipe.next_batch()
        return _sgd(loss, p, s, _t(b["images"]), _t(b["labels"]))

    ces = []
    for _ in range(60):
        params, state, ce = step(params, state)
        ces.append(ce)
    assert np.mean(ces[-5:]) < np.mean(ces[:5]) - 0.05, ces

    cim_p = dataclasses.replace(cim, sparsity=dataclasses.replace(
        cim.sparsity, target_sparsity=0.6))
    pruned = TCNN.prune_all(params, cim_p)
    deep = pruned["convs"][4]
    kh, kw, ci, co = deep["mask"].shape
    zg = float(torch.stack([TS.zero_groupset_proportion(m, 16, 16) for m in
                            deep["mask"].reshape(kh * kw, ci, co)]).mean())
    assert zg > 0.3, zg

    for _ in range(5):
        pruned, state, _ = step(pruned, state)
    w2 = pruned["convs"][4]["w"].reshape(-1, co)
    m2 = pruned["convs"][4]["mask"].reshape(-1, co)
    w_eff = TCL.effective_weight({"w": w2, "mask": m2}, cim_p)
    dead = m2 == 0
    assert bool(dead.any()) and bool((w_eff[dead] == 0).all())
    assert torch.equal(m2, deep["mask"].reshape(-1, co))  # masks untouched

    w2d = TQ.mars_weight_quant(w2 * m2, 4, 16)
    packed = ops.pack_for_kernel(w2d, bits=4, bk=16, bn=16)
    x = torch.randn((32, w2d.shape[0]), generator=gen)
    torch.testing.assert_close(ops.bsr_matmul(x, packed), x @ w2d,
                               rtol=1e-5, atol=1e-5)
    assert packed["density"] < 1.0


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_qat_train_step_on_the_card_equals_the_plain_path():
    """One QAT train step of the small VGG on the card: loss, gradients and
    new state with fake_quant (forward and backward) on its kernel equal
    bit for bit to the plain versions', with exact launch counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cudnn = torch.backends.cudnn
    saved_flags = cudnn.allow_tf32, cudnn.deterministic
    cudnn.allow_tf32, cudnn.deterministic = False, True
    try:
        cim = _cim()
        gen = torch.Generator(device="cuda").manual_seed(0)
        params, state = TCNN.vgg_init(gen, cim, TVGG.SMALL_PLAN, n_classes=4)
        b = ImagePipeline(**SMALL).next_batch()
        images = torch.as_tensor(b["images"], device="cuda")
        labels = torch.as_tensor(b["labels"], device="cuda")
        loss = _port_loss("vgg", cim)
        FQ.reset_launches()
        out, (_, st, _), g = TCNN.grads(loss, params, state, images, labels)
        torch.cuda.synchronize()
        assert (FQ.LAUNCHES, FQ.BWD_LAUNCHES) == (6, 5)
        saved = FQ.fake_quant
        FQ.fake_quant = FQ.fake_quant_plain
        try:
            out2, (_, st2, _), g2 = TCNN.grads(loss, params, state, images,
                                           labels)
        finally:
            FQ.fake_quant = saved
        assert torch.equal(out, out2)
        assert all(torch.equal(a, b) for a, b in zip(TS.tensor_leaves(st),
                                                     TS.tensor_leaves(st2)))
        assert all((a is None and b is None) or torch.equal(a, b)
                   for a, b in zip(g, g2))
    finally:
        cudnn.allow_tf32, cudnn.deterministic = saved_flags
