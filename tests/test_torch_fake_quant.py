"""The port's fake quant (eq. 5 / eq. 8) against the Pallas kernel and the
reference's quantizers.

The port's wrapper runs its plain version on these CPU tensors; the JAX
side runs ``repro.kernels.ops.fake_quant`` in interpret mode,
``ref.fake_quant_ref``, and ``core.quant.quantize_activation`` /
``quantize_weight_symmetric`` as ``models.layers`` calls them. The same
numpy inputs (salted with NaN, +-inf and exact half-levels) feed both.
Tolerance 0: every step is one f32 multiply, a half-to-even round and a
division by a power of two, which both frameworks do exactly alike. The
result type is decoupled from the input's (``out_dtype``): every pair of
f32 and bf16 equals the reference on ``x.astype(f32)`` cast to the output
type, and the callers that fuse the widening or narrowing into the kernel
(``deploy.deployed_matmul``/``stacked_matmul``, ``layers.maybe_quant_w``)
give the same bits as the composition they replaced. The CUDA kernel
itself is held against the plain version by the ``cuda``-marked tests,
which run only on a GPU.

The straight-through backward (``ste="clip"`` for eq. 5's activations,
``"noclip"`` for eq. 8's weights) equals ``jax.grad`` of the reference's
``quantize_activation`` / ``quantize_weight_symmetric`` bit for bit,
NaN for NaN: on the bounds (half the slope under the clamp), outside them,
for NaN and +-inf inputs and for infinite output gradients. Subnormal
inputs are left out: XLA's CPU backend flushes them to zero in the
clamp's compares, which torch and the CUDA kernel do not.
"""
import numpy as np
import pytest
import torch

from repro_torch.convert import tensor_from_numpy
from repro_torch.core import deploy as TD
from repro_torch.core import quant as TQ
from repro_torch.core.cim_layer import CIMConfig
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import fake_quant as TFQ
from repro_torch.kernels import ops as TOPS
from repro_torch.models import layers as TL

SHAPES = [(64, 64), (3, 100, 130), (513,)]
DTYPES = ["float32", "bfloat16"]


def _reference():
    """JAX and the reference, imported only by the tests that compare
    against them: the GPU machine that runs the ``cuda`` test has no JAX."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import quant as RQ
    from repro.kernels import ops as ROPS
    from repro.kernels import ref as RREF
    return jnp, RQ, ROPS, RREF


def _levels(bits, signed):
    return 2.0 ** (bits - 1) - 1.0 if signed else 2.0 ** bits - 1.0


def _inputs(shape, bits, signed, dtype, seed=0):
    """Normals * 1.5 (so the clamp bites), salted with NaN, +-inf and
    values whose product with the level count is exactly k + 0.5 in f32
    after rounding to ``dtype``."""
    rng = np.random.default_rng(seed + 7 * bits + signed)
    x = (rng.standard_normal(int(np.prod(shape))) * 1.5).astype(np.float32)
    q = np.float32(_levels(bits, signed))
    k = rng.integers(-int(q) if signed else 0, int(q), 4096)
    half = ((k + 0.5) / q).astype(np.float32)
    if dtype == "bfloat16":
        half = _round_bf16(half)
    half = half[half * q == (k + 0.5).astype(np.float32)]
    n = x.size
    x[:min(len(half), n // 4)] = half[:n // 4]
    x[n // 4::37] = np.nan
    x[n // 4 + 1::41] = np.inf
    x[n // 4 + 2::43] = -np.inf
    rng.shuffle(x)
    return x.reshape(shape)


def _round_bf16(x):
    import ml_dtypes
    return x.astype(ml_dtypes.bfloat16).astype(np.float32)


def _both(x, dtype):
    """The same values as a jnp array and a torch tensor of ``dtype``."""
    jnp = _reference()[0]
    xj = jnp.asarray(x, getattr(jnp, dtype))
    return xj, tensor_from_numpy(np.asarray(xj), torch.device("cpu"))


def _f32(a):
    return np.asarray(a.float() if torch.is_tensor(a) else a, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_fake_quant_matches_pallas_and_eq5(bits, signed, shape, dtype):
    jnp, RQ, ROPS, RREF = _reference()
    x = _inputs(shape, bits, signed, dtype)
    assert np.isnan(x).any() and np.isinf(x).any()
    xj, xt = _both(x, dtype)
    got = TFQ.fake_quant(xt, bits, signed)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    pallas = ROPS.fake_quant(xj if xj.ndim > 1 else xj[None], bits,
                             signed=signed, interpret=True).reshape(shape)
    eq5 = RQ.quantize_activation(xj.astype(jnp.float32), bits,
                                 signed).astype(xj.dtype)
    for want in (pallas, RREF.fake_quant_ref(xj, bits, signed), eq5):
        np.testing.assert_array_equal(_f32(got), _f32(want))
    np.testing.assert_array_equal(
        _f32(got), _f32(TQ.quantize_activation(xt.float(), bits,
                                               signed).to(xt.dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_signed_fake_quant_is_eq8_on_normalized_weights(bits, dtype):
    """On [-1, 1] (tanh_normalize's range) the signed form is eq. 8."""
    jnp, RQ, _, _ = _reference()
    w = np.clip(_inputs((96, 80), bits, True, dtype, seed=3), -1.0, 1.0)
    w = np.nan_to_num(w, nan=0.25)
    wj, wt = _both(w, dtype)
    want = RQ.quantize_weight_symmetric(wj.astype(jnp.float32),
                                        bits).astype(wj.dtype)
    np.testing.assert_array_equal(_f32(TFQ.fake_quant(wt, bits, True)),
                                  _f32(want))


@pytest.mark.parametrize("out_dtype", DTYPES)
@pytest.mark.parametrize("in_dtype", DTYPES)
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("bits", [2, 8])
def test_fake_quant_out_dtype_matches_reference_cast(bits, signed, in_dtype,
                                                     out_dtype):
    """Every (input, output) pair of f32 and bf16: the reference's
    ``fake_quant`` on ``x.astype(f32)``, cast to the output type."""
    jnp, _, ROPS, RREF = _reference()
    x = _inputs((3, 100, 130), bits, signed, in_dtype, seed=5)
    xj, xt = _both(x, in_dtype)
    out = getattr(torch, out_dtype)
    got = TFQ.fake_quant(xt, bits, signed, out_dtype=out)
    assert got.dtype == out and got.shape == xt.shape
    x32 = xj.astype(jnp.float32)
    for want in (ROPS.fake_quant(x32, bits, signed=signed, interpret=True),
                 RREF.fake_quant_ref(x32, bits, signed)):
        np.testing.assert_array_equal(
            _f32(got), _f32(want.astype(getattr(jnp, out_dtype))))
    np.testing.assert_array_equal(
        _f32(got), _f32(TFQ.fake_quant(xt.float(), bits, signed).to(out)))
    np.testing.assert_array_equal(
        _f32(TOPS.fake_quant(xt, bits, signed, out_dtype=out)), _f32(got))


def _cim(mode="qat"):
    q = dict(w_bits=8, a_bits=8, group_size=128, a_signed=True)
    return CIMConfig(quant=QuantConfig(**q), mode=mode)


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_callers_match_unfused_composition(dtype):
    """The callers that pass ``out_dtype`` give the bits of the composition
    they replaced: ``fake_quant(x.float())`` before the block-sparse matmul
    (``deployed_matmul``, ``stacked_matmul``), and ``fake_quant(wq).to(
    w.dtype)`` for a QAT weight (``maybe_quant_w``)."""
    rng = np.random.default_rng(21)
    dt = getattr(torch, dtype)
    w = torch.from_numpy((rng.standard_normal((2, 64, 96)) * 0.2
                          ).astype(np.float32))
    cim = _cim()
    dws = [TD.deploy_weight(w[i], cim, bk=16, bn=32) for i in range(2)]
    sw = TD.stack_deployed(dws)
    x = torch.from_numpy((rng.standard_normal((3, 5, 64)) * 0.7
                          ).astype(np.float32)).to(dt)
    for i in range(2):
        xq = TFQ.fake_quant(x.float(), 8, signed=True)
        want = TOPS.bsr_matmul(xq.reshape(-1, 64), dws[i].packed[0]
                               ).reshape(3, 5, 96)
        got = TD.deployed_matmul(x, dws[i], a_bits=8)
        got_st = TD.stacked_matmul(x, sw, i, a_bits=8)
        assert got.dtype == got_st.dtype == torch.float32
        assert torch.equal(got, want) and torch.equal(got_st, want)
    wt = w[0].to(dt)
    want = TFQ.fake_quant(TQ.tanh_normalize(wt.float(), 128), 8,
                          signed=True).to(wt.dtype)
    got = TL.maybe_quant_w(wt, cim)
    assert got.dtype == wt.dtype and torch.equal(got, want)
    assert TL.maybe_quant_w(wt, _cim("dense")) is wt


def test_layer_quantizers_match_reference():
    """``maybe_quant_a`` bit for bit; ``maybe_quant_w`` up to one level
    where eq. 8's pre-rounding value is a half-level and torch's and XLA's
    tanh differ by an ulp (ROADMAP Queue C)."""
    jnp, _, _, _ = _reference()
    from repro.core.cim_layer import CIMConfig as RCIMConfig
    from repro.core.quant import QuantConfig as RQuantConfig
    from repro.models import layers as RL
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((5, 7, 64)) * 0.8).astype(np.float32)
    w = (rng.standard_normal((64, 256)) * 0.2).astype(np.float32)
    q = dict(w_bits=8, a_bits=8, group_size=128, a_signed=True)
    rcim = RCIMConfig(quant=RQuantConfig(**q), mode="qat")
    tcim = CIMConfig(quant=QuantConfig(**q), mode="qat")
    for dtype in ("float32", "bfloat16"):
        xj, xt = _both(x, dtype)
        wj, wt = _both(w, dtype)
        np.testing.assert_array_equal(_f32(TL.maybe_quant_a(xt, tcim)),
                                      _f32(RL.maybe_quant_a(xj, rcim)))
        diff = np.abs(_f32(TL.maybe_quant_w(wt, tcim))
                      - _f32(RL.maybe_quant_w(wj, rcim))) * 128
        assert diff.max() <= 1.0 and (diff > 0).mean() <= 1e-3, diff.max()
    dense = CIMConfig(quant=QuantConfig(**q), mode="dense")
    xt = torch.from_numpy(x)
    assert TL.maybe_quant_a(xt, dense) is xt


def test_fake_quant_wrapper_checks():
    with pytest.raises(TypeError):
        TFQ.fake_quant(torch.zeros(4, dtype=torch.int32), 8)
    with pytest.raises(ValueError):
        TFQ.fake_quant(torch.zeros(4), 0)
    with pytest.raises(TypeError):
        TFQ.fake_quant(torch.zeros(4), 8, out_dtype=torch.int32)
    x = torch.randn(3, 5)
    assert TOPS.fake_quant(x, 32) is x  # eq. 5 at 32 bits: left in float
    assert torch.equal(TOPS.fake_quant(x, 32, out_dtype=torch.bfloat16),
                       x.to(torch.bfloat16))
    t = x.t()  # non-contiguous input, same values out
    assert torch.equal(TFQ.fake_quant(t, 4, True),
                       TFQ.fake_quant_plain(t.contiguous(), 4, True))


def _ste_inputs(bits, signed, dtype, weight=False):
    """x with the clamp's edge cases (both bounds, one ulp inside and
    outside them, NaN, +-inf) among normals, and an output gradient with
    a few infinities, as float32 numpy."""
    rng = np.random.default_rng(3 * bits + signed + 11 * weight)
    lo = -1.0 if signed else 0.0
    x = (rng.standard_normal(2048) * (0.6 if weight else 1.5)).astype(
        np.float32)
    if weight:
        x = np.clip(x, -1.0, 1.0)
    edges = np.array([lo, 1.0, -1.0, 0.0, 0.5, np.nan, np.inf, -np.inf],
                     np.float32)
    tiny = np.finfo(np.float32).tiny  # the nearest normals to 0
    near = np.array([np.nextafter(np.float32(v), np.float32(d)) if v
                     else d * tiny / 2 for v in (lo, 1.0)
                     for d in (-2.0, 2.0)], np.float32)
    if dtype == "bfloat16":
        near = _round_bf16(np.array([lo - 2 ** -7, lo + 2 ** -9,
                                     1 - 2 ** -9, 1 + 2 ** -7],
                                    np.float32))
    x[:len(edges)] = edges
    x[len(edges):len(edges) + len(near)] = near
    g = rng.standard_normal(x.size).astype(np.float32)
    g[100:104] = [np.inf, -np.inf, np.inf, np.nan]
    g[:len(edges)] = rng.standard_normal(len(edges)) + 2.0
    if dtype == "bfloat16":
        x, g = _round_bf16(x), _round_bf16(g)
    rng.shuffle(x)
    return x, g


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_activation_ste_equals_jax_grad(bits, signed, dtype, out):
    """The clip mode against ``jax.grad`` of eq. 5 as ``maybe_quant_a``
    calls it (widen to f32, quantize, cast to the output type)."""
    jax = pytest.importorskip("jax")
    jnp, RQ, _, _ = _reference()
    x, g = _ste_inputs(bits, signed, dtype)
    xj, xt = _both(x, dtype)
    gj, gt = _both(g, out)
    f = lambda v: RQ.quantize_activation(v.astype(jnp.float32), bits,
                                         signed).astype(gj.dtype)
    want = jax.vjp(f, xj)[1](gj)[0]
    xt.requires_grad_()
    y = TFQ.fake_quant(xt, bits, signed, out_dtype=gt.dtype)
    (got,) = torch.autograd.grad(y, xt, gt)
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(_f32(got), _f32(want))
    np.testing.assert_array_equal(
        _f32(got), _f32(TFQ.fake_quant_bwd_plain(gt, xt.detach(), bits,
                                                 signed)))


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_weight_ste_equals_jax_grad(bits, out):
    """The noclip mode against ``jax.grad`` of eq. 8 as ``maybe_quant_w``
    calls it (an f32 tanh-normalized weight in, the weight's type out):
    the whole slope on +-1 too, and for NaN."""
    jax = pytest.importorskip("jax")
    jnp, RQ, _, _ = _reference()
    x, g = _ste_inputs(bits, True, "float32", weight=True)
    xj, xt = _both(x, "float32")
    gj, gt = _both(g, out)
    f = lambda v: RQ.quantize_weight_symmetric(v, bits).astype(gj.dtype)
    want = jax.vjp(f, xj)[1](gj)[0]
    xt.requires_grad_()
    y = TOPS.fake_quant(xt, bits, True, out_dtype=gt.dtype, ste="noclip")
    (got,) = torch.autograd.grad(y, xt, gt)
    np.testing.assert_array_equal(_f32(got), _f32(want))
    slope = (2.0 ** (bits - 1) - 1) / 2.0 ** (bits - 1)
    one = torch.ones(3, requires_grad=True)
    (at_one,) = torch.autograd.grad(TOPS.fake_quant(
        one, bits, True, ste="noclip").sum(), one)
    (clipped,) = torch.autograd.grad(TOPS.fake_quant(
        one, bits, True).sum(), one)
    assert at_one.tolist() == [slope] * 3
    assert clipped.tolist() == [slope / 2] * 3


def test_ste_in_the_layer_quantizers_and_the_no_grad_path():
    """``maybe_quant_a`` takes the clip mode and ``maybe_quant_w`` the
    noclip mode; without a gradient to record, the wrapper saves nothing
    and gives the same bits."""
    q = dict(w_bits=4, a_bits=4, group_size=2, a_signed=True)
    cim = CIMConfig(quant=QuantConfig(**q), mode="qat")
    x = torch.tensor([[1.0, -1.0, 0.25, 3.0]], requires_grad=True)
    (gx,) = torch.autograd.grad(TL.maybe_quant_a(x, cim).sum(), x)
    assert gx.tolist() == [[0.4375, 0.4375, 0.875, 0.0]]
    w = torch.tensor([[2.0, -0.5, 0.1, 0.3], [0.2, 0.4, -3.0, 1.0]],
                     requires_grad=True)
    g = torch.tensor([[1.0, 2.0, -1.0, 0.5], [3.0, -2.0, 1.5, 1.0]])
    (gw,) = torch.autograd.grad(TL.maybe_quant_w(w, cim), w, g)
    # eq. 6 times the whole slope 7/8, the groups' +-1 included (no clamp)
    wn = TQ.tanh_normalize(w, 2)
    assert (wn.detach().abs() == 1.0).sum() == 2
    (want,) = torch.autograd.grad(wn, w, g * 0.875)
    assert torch.equal(gw, want)
    y = TFQ.fake_quant(x, 4, True)
    with torch.no_grad():
        y0 = TFQ.fake_quant(x, 4, True)
    assert y.grad_fn is not None and y0.grad_fn is None
    assert TFQ.fake_quant(x.detach(), 4, True).grad_fn is None
    assert torch.equal(y.detach(), y0)


def test_ste_backward_checks():
    g = torch.ones(4)
    with pytest.raises(ValueError, match="ste"):
        TFQ.fake_quant(torch.zeros(4), 8, ste="round")
    with pytest.raises(ValueError, match="x"):
        TFQ.fake_quant_bwd(g, None, 8)
    with pytest.raises(ValueError, match="dtype"):
        TFQ.fake_quant_bwd(g, None, 8, ste="noclip")
    with pytest.raises(ValueError, match="shape"):
        TFQ.fake_quant_bwd(g, torch.zeros(5), 8)
    assert TFQ.fake_quant_bwd(g, None, 8, True, "noclip",
                              torch.bfloat16).dtype == torch.bfloat16


def _gpu_input(shape, bits, dtype, extra=0):
    """1.5-scaled normals salted with NaN and +-inf, on the card, with
    ``extra`` leading elements for a misaligned view."""
    rng = np.random.default_rng(bits + extra)
    x = rng.standard_normal(int(np.prod(shape)) + extra).astype(np.float32)
    x *= 1.5
    x[::29] = np.nan
    x[1::31] = np.inf
    x[2::37] = -np.inf
    return torch.from_numpy(x).to("cuda", dtype)


def _assert_same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
def test_fake_quant_kernel_matches_plain_on_gpu():
    """The CUDA kernel against its plain version, bit for bit, on the
    card: every (input, output) pair of f32 and bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    n0 = TFQ.LAUNCHES
    count = 0
    for bits in (2, 4, 8):
        for signed in (False, True):
            for dt in (torch.float32, torch.bfloat16):
                for out in (torch.float32, torch.bfloat16):
                    for shape in SHAPES + [(4096, 1536), (1,)]:
                        xt = _gpu_input(shape, bits, dt).reshape(shape)
                        got = TFQ.fake_quant(xt, bits, signed, out_dtype=out)
                        torch.cuda.synchronize()
                        count += 1
                        _assert_same(got, TFQ.fake_quant_plain(
                            xt, bits, signed, out_dtype=out))
    assert TFQ.LAUNCHES == n0 + count


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 9, 1000, 4099, 65_537])
def test_fake_quant_kernel_misaligned_and_odd_lengths_on_gpu(n):
    """Views that start off a 16-byte boundary (``x[k:]``: the kernel's
    scalar head and element-wise loads) and lengths off the 16-byte vector
    (its scalar tail), every dtype pair, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for dt in (torch.float32, torch.bfloat16):
        for out in (torch.float32, torch.bfloat16):
            for k in (0, 1, 3):
                x = _gpu_input((n,), 8, dt, extra=k)[k:]
                assert x.numel() == n
                for signed in (False, True):
                    got = TFQ.fake_quant(x, 8, signed, out_dtype=out)
                    torch.cuda.synchronize()
                    _assert_same(got, TFQ.fake_quant_plain(
                        x, 8, signed, out_dtype=out))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 4099, 65_537])
def test_fake_quant_bwd_kernel_matches_plain_on_gpu(n):
    """The backward kernel against its plain version, bit for bit: both
    modes, bits 2/4/8, signed and unsigned, every (x, grad) pair of f32
    and bf16, aligned and misaligned views, edge values included."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    n0 = TFQ.BWD_LAUNCHES
    count = 0
    for bits in (2, 4, 8):
        for signed in (False, True):
            for dt in (torch.float32, torch.bfloat16):
                for gdt in (torch.float32, torch.bfloat16):
                    for k in (0, 1):
                        x = _gpu_input((n,), bits, dt, extra=k)[k:]
                        x[::5] = -1.0 if signed else 0.0
                        x[1::7] = 1.0
                        g = _gpu_input((n,), bits + 1, gdt, extra=k)[k:]
                        for ste in ("clip", "noclip"):
                            xs = x if ste == "clip" else None
                            got = TFQ.fake_quant_bwd(g, xs, bits, signed, ste,
                                                     dt)
                            torch.cuda.synchronize()
                            count += 1
                            _assert_same(got, TFQ.fake_quant_bwd_plain(
                                g, xs, bits, signed, ste, dt))
    assert TFQ.BWD_LAUNCHES == n0 + count
