"""The DoReFa baseline quantizers (``repro_torch.core.quant``) against the
reference's (``repro.core.quant``), values and straight-through gradients,
at bits 1-8 and 32 (pass-through).

The activation quantizer holds bit for bit, values and ``jax.grad``. The
weight quantizer runs through ``tanh``, and ``torch.tanh`` and XLA's round
differently by an ulp on most inputs (ROADMAP Queue C), and so do their
derivatives (XLA forms (g + g y)(1 - y), torch g (1 - y^2)). So: the
quantized weights equal the reference's except where the reference's
pre-rounding value lies within TIE_ULPS f32 ulps of a half-level (there
they may sit one level apart, and nowhere else), and the weight gradients
lie within GRAD_RTOL of max |reference gradient| - an ulp-level gap; a
lost straight-through path or a wrong normalization is off by O(1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as RQ
from repro_torch.core import quant as TQ

BITS = (1, 2, 3, 4, 5, 6, 7, 8, 32)
TIE_ULPS = 8
GRAD_RTOL = 1e-5


def _draw(seed, shape=(64, 96), scale=0.7, shift=0.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * scale + shift).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return x, g


def _torch_grad(fn, x, g):
    xt = torch.from_numpy(x).requires_grad_()
    y = fn(xt)
    (y * torch.from_numpy(g)).sum().backward()
    return y.detach().numpy(), xt.grad.numpy()


@pytest.mark.parametrize("bits", BITS)
def test_activation_quantizer_equals_reference(bits):
    """Values and gradients bit for bit, with inputs on and beyond both
    clip bounds and on exact half-levels."""
    x, g = _draw(bits, shift=0.4)
    levels = 2.0 ** min(bits, 8) - 1.0
    x[0, :8] = [0.0, 1.0, -0.0, 2.0, -1.0, 0.5 / levels, 1.5 / levels,
                1.0 - 0.5 / levels]
    want = np.asarray(RQ.dorefa_quantize_activation(jnp.asarray(x), bits))
    want_g = np.asarray(jax.grad(lambda a: jnp.sum(
        RQ.dorefa_quantize_activation(a, bits) * g))(jnp.asarray(x)))
    got, got_g = _torch_grad(
        lambda a: TQ.dorefa_quantize_activation(a, bits), x, g)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_g, want_g)
    if bits < 32:
        assert len(np.unique(got)) <= levels + 1


@pytest.mark.parametrize("bits", BITS)
def test_weight_quantizer_equals_reference(bits):
    """Values equal up to an ulp-level tie (see the module docstring) and
    on the grid 2 k / (2^bits - 1) - 1; gradients within GRAD_RTOL."""
    w, g = _draw(100 + bits)
    wj = jnp.asarray(w)
    want = np.asarray(RQ.dorefa_quantize_weight(wj, bits))
    want_g = np.asarray(jax.grad(lambda a: jnp.sum(
        RQ.dorefa_quantize_weight(a, bits) * g))(wj))
    got, got_g = _torch_grad(lambda a: TQ.dorefa_quantize_weight(a, bits),
                             w, g)
    if bits >= 32:
        np.testing.assert_array_equal(got, w)
        np.testing.assert_array_equal(got_g, g)
        return
    levels = 2.0 ** bits - 1.0
    pre = (np.asarray(jnp.tanh(wj) / (2.0 * jnp.max(jnp.abs(jnp.tanh(wj)))
                                       + 1e-12) + 0.5) * levels)
    near_tie = np.abs(pre - np.floor(pre) - 0.5) <= TIE_ULPS * np.spacing(
        np.abs(pre).astype(np.float32))
    differ = got != want
    assert not (differ & ~near_tie).any(), np.argwhere(differ & ~near_tie)
    np.testing.assert_allclose(got[differ], want[differ], rtol=0,
                               atol=2.0 / levels + 1e-6)
    k = (got + 1.0) / 2.0 * levels
    np.testing.assert_allclose(k, np.round(k), atol=1e-4)
    err = np.abs(got_g - want_g).max() / np.abs(want_g).max()
    assert err <= GRAD_RTOL, err


def test_weight_gradient_is_straight_through():
    """With the rounding gone the gradient is d/dw of the normalized tanh:
    the port's autograd through the straight-through estimator equals
    autograd of the same expression with no rounding at all."""
    w, g = _draw(7, shape=(16, 24))

    def smooth(a):
        t = torch.tanh(a)
        return 2.0 * (t / (2.0 * t.abs().amax() + 1e-12) + 0.5) - 1.0

    _, want = _torch_grad(smooth, w, g)
    for bits in (1, 4, 8):
        _, got = _torch_grad(lambda a: TQ.dorefa_quantize_weight(a, bits),
                             w, g)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
