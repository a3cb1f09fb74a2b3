"""The last public names of the reference that the port took on, each
against the reference on seeded numpy inputs at smoke size:
``registry.shape_config`` and ``ShapeConfig.is_serving``,
``quant.round_ste`` and ``quant.weight_int_levels`` (half-level inputs,
where ``round`` must go to even as ``jnp.round`` does), ``ops.ssd_intra``
(the plain version on the CPU, bit for bit, and the reference's Pallas
kernel in interpret mode) and ``layers.decode_attention``, the one-token
decode over a contiguous cache, past a window and, as a ring, past its
wrap.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as RQ
from repro.kernels import ops as ROPS
from repro.models import layers as RL
from repro.models import registry as RR
from repro_torch import convert
from repro_torch.core import quant as TQ
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ssd_intra as TSI
from repro_torch.models import layers as TL
from repro_torch.models import registry as TR


@pytest.mark.parametrize("name", ["train_4k", "prefill_32k", "decode_32k",
                                  "long_500k"])
def test_shape_config_and_is_serving(name):
    want, got = RR.shape_config(name), TR.shape_config(name)
    assert (got.name, got.seq_len, got.global_batch, got.kind) == (
        want.name, want.seq_len, want.global_batch, want.kind)
    assert got.is_serving is want.is_serving
    with pytest.raises(KeyError):
        TR.shape_config("no_such_shape")


def test_round_ste_values_and_gradient():
    """Half-integers round to even; the gradient is the identity."""
    x = np.concatenate([np.arange(-4, 4) + 0.5, np.random.default_rng(0)
                        .standard_normal(64) * 3]).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    y = TQ.round_ste(xt)
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.asarray(RQ.round_ste(jnp.asarray(x))))
    (g,) = torch.autograd.grad((y * torch.arange(x.size)).sum(), xt)
    want = jax.grad(lambda v: jnp.sum(RQ.round_ste(v) * jnp.arange(x.size)))(
        jnp.asarray(x))
    np.testing.assert_array_equal(g.numpy(), np.asarray(want))


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_weight_int_levels_on_half_levels(bits):
    """eq. 8 outputs and values half a level between two codes: the codes
    equal the reference's int8, half to even."""
    step = 2.0 ** (bits - 1)
    qmax = int(step) - 1
    half = (np.arange(-qmax, qmax) + 0.5) / step
    rng = np.random.default_rng(bits)
    eq8 = np.array(RQ.quantize_weight_symmetric(
        jnp.asarray(rng.uniform(-1, 1, 256).astype(np.float32)), bits))
    for w in (half.astype(np.float32), eq8):
        got = TQ.weight_int_levels(torch.from_numpy(w), bits)
        want = np.asarray(RQ.weight_int_levels(jnp.asarray(w), bits))
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)


def test_ops_ssd_intra_is_the_plain_version_on_cpu():
    """On CPU tensors ``ops.ssd_intra`` is ``ssd_intra_chunk_plain`` bit
    for bit (f32 and its out_dtype), and within 1e-5 of the reference's
    ``ops.ssd_intra`` (its Pallas kernel in interpret mode)."""
    rng = np.random.default_rng(3)
    C, H, l, N, P = 3, 2, 16, 8, 4
    a = -np.abs(rng.standard_normal((C, H, l))).astype(np.float32) * 0.3
    b, c = (rng.standard_normal((C, l, N)).astype(np.float32)
            for _ in range(2))
    x = rng.standard_normal((C, l, H, P)).astype(np.float32)
    at, bt, ct, xt = map(torch.from_numpy, (a, b, c, x))
    got = TOPS.ssd_intra(at, bt, ct, xt)
    assert torch.equal(got, TSI.ssd_intra_chunk_plain(at, bt, ct, xt))
    assert torch.equal(
        TOPS.ssd_intra(at, bt, ct, xt, out_dtype=torch.bfloat16),
        TSI.ssd_intra_chunk_plain(at, bt, ct, xt, torch.bfloat16))
    want = ROPS.ssd_intra(*map(jnp.asarray, (a, b, c, x)), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


_PARAMS = {}


def _dense(arch):
    """(rcfg, tcfg, the reference's layer-0 attention params, the port's
    copy) of an f32 smoke config."""
    kw = dict(dtype="float32")
    rcfg, tcfg = RR.get_smoke_config(arch, **kw), TR.get_smoke_config(
        arch, **kw)
    if arch not in _PARAMS:
        rp = RR.model_fns(rcfg).init_params(rcfg, jax.random.PRNGKey(0))
        tp = convert.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, rp), tcfg, device="cpu")
        keys = ("wq", "wk", "wv", "wo")
        _PARAMS[arch] = ({k: rp["layers"][k][0] for k in keys},
                         {k: tp["layers"][k][0] for k in keys})
    return (rcfg, tcfg) + _PARAMS[arch]


def _decode(arch, pos, smax, window, ring):
    rcfg, tcfg, rp, tp = _dense(arch)
    rng = np.random.default_rng(pos + 1000 * ring)
    kv = (2, smax, tcfg.n_kv_heads, tcfg.dh)
    x1 = (rng.standard_normal((2, 1, tcfg.d_model)) * 0.5).astype(np.float32)
    kc, vc = ((rng.standard_normal(kv) * 0.5).astype(np.float32)
              for _ in range(2))
    y, kw, vw = RL.decode_attention(rp, jnp.asarray(x1), jnp.asarray(kc),
                                    jnp.asarray(vc), jnp.asarray(pos, jnp.int32),
                                    rcfg, window=window, ring=ring)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got, gk, gv = TL.decode_attention(tp, torch.from_numpy(x1), tk, tv, pos,
                                      tcfg, window=window, ring=ring)
    assert gk is tk and gv is tv  # written in place
    for g, w in ((got, y), (gk, kw), (gv, vw)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("pos", [3, 40, 95])
def test_decode_attention_past_a_window(pos):
    """A static cache of 96 slots, a window of 8: before, at and long past
    the window, y and the written caches within 1e-5 of the reference's."""
    _decode("yi-6b", pos, 96, 8, ring=False)


@pytest.mark.parametrize("pos", [5, 31, 32, 77])
def test_decode_attention_ring_past_its_wrap(pos):
    """A 32-slot ring: before the wrap, at its last slot and past it."""
    _decode("yi-6b", pos, 32, 0, ring=True)
