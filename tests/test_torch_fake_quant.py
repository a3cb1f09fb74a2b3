"""The port's fake quant (eq. 5 / eq. 8) against the Pallas kernel and the
reference's quantizers.

The port's wrapper runs its plain version on these CPU tensors; the JAX
side runs ``repro.kernels.ops.fake_quant`` in interpret mode,
``ref.fake_quant_ref``, and ``core.quant.quantize_activation`` /
``quantize_weight_symmetric`` as ``models.layers`` calls them. The same
numpy inputs (salted with NaN, +-inf and exact half-levels) feed both.
Tolerance 0: every step is one f32 multiply, a half-to-even round and a
division by a power of two, which both frameworks do exactly alike. The
CUDA kernel itself is held against the plain version by the ``cuda``-marked
test, which runs only on a GPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.convert import tensor_from_numpy
from repro_torch.core import quant as TQ
from repro_torch.core.cim_layer import CIMConfig
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import fake_quant as TFQ
from repro_torch.kernels import ops as TOPS
from repro_torch.models import layers as TL

SHAPES = [(64, 64), (3, 100, 130), (513,)]


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
    x = torch.randn(3, 5)
    assert TOPS.fake_quant(x, 32) is x  # eq. 5 at 32 bits: left in float
    t = x.t()  # non-contiguous input, same values out
    assert torch.equal(TFQ.fake_quant(t, 4, True),
                       TFQ.fake_quant_plain(t.contiguous(), 4, True))


@pytest.mark.cuda
def test_fake_quant_kernel_matches_plain_on_gpu():
    """The CUDA kernel against its plain version, bit for bit, on the
    card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    n0 = TFQ.LAUNCHES
    count = 0
    for bits in (2, 4, 8):
        for signed in (False, True):
            for dt in (torch.float32, torch.bfloat16):
                for shape in SHAPES + [(4096, 1536), (1,)]:
                    rng = np.random.default_rng(bits)
                    x = rng.standard_normal(shape).astype(np.float32) * 1.5
                    x.reshape(-1)[::29] = np.nan
                    x.reshape(-1)[1::31] = np.inf
                    xt = torch.from_numpy(x).to("cuda", dt)
                    got = TFQ.fake_quant(xt, bits, signed)
                    torch.cuda.synchronize()
                    count += 1
                    want = TFQ.fake_quant_plain(xt, bits, signed)
                    torch.testing.assert_close(got, want, rtol=0, atol=0,
                                               equal_nan=True)
    assert TFQ.LAUNCHES == n0 + count
