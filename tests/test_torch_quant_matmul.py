"""The port's dense int8 matmul (``quant_matmul``) against the Pallas
kernel and the reference's oracle.

On these CPU tensors the port's entry point runs its plain version; the
JAX side runs ``repro.kernels.quant_matmul.quant_matmul`` in interpret mode
and ``ref.quant_matmul_ref``, on test_kernels.py's four shapes. Both sides
cast x to f32 exactly (bf16 widens without rounding), multiply int8 levels
exactly and sum in f32, so only the order of the f32 sums differs:
tolerance 1e-4, relative and absolute, for f32 and bf16 x alike. The CUDA
kernel itself is held against the plain version by the ``cuda``-marked
test, which runs only on a GPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import quant_matmul as TQM

TOL = 1e-4
QM_CASES = [  # (m, k, n, x dtype) - tests/test_kernels.py's QM_CASES
    (128, 256, 256, "float32"),
    (100, 200, 300, "float32"),  # every edge ragged
    (256, 128, 512, "bfloat16"),
    (64, 384, 128, "float32"),
]


def _reference():
    """JAX and the reference, imported only by the tests that compare
    against them: the GPU machine that runs the ``cuda`` test has no JAX."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as RREF
    from repro.kernels.quant_matmul import quant_matmul as rqm
    return jnp, RREF, rqm


def _inputs(m, k, n):
    """test_kernels.py's draws: int8 levels in [-127, 127], scales in
    [0.01, 0.11), normal x."""
    rng = np.random.default_rng(m * 7 + n)
    w = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    scale = (rng.random(n) * 0.1 + 0.01).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    return x, w, scale


@pytest.mark.parametrize("m,k,n,xdtype", QM_CASES)
def test_plain_matches_pallas_and_oracle(m, k, n, xdtype):
    jnp, RREF, rqm = _reference()
    x, w, scale = _inputs(m, k, n)
    xj = jnp.asarray(x, getattr(jnp, xdtype))
    want_pallas = np.asarray(rqm(xj, jnp.asarray(w), jnp.asarray(scale),
                                 interpret=True))
    want_ref = np.asarray(RREF.quant_matmul_ref(xj, w, scale))
    cpu = torch.device("cpu")
    n0 = TQM.LAUNCHES
    got = TOPS.quant_matmul(tensor_from_numpy(np.asarray(xj), cpu),
                            torch.from_numpy(w), torch.from_numpy(scale))
    assert TQM.LAUNCHES == n0  # a CPU tensor takes the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    for want in (want_pallas, want_ref):
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_plain_applies_scale_after_the_sum():
    """The scale is per output channel, after the K sum: a zero scale
    zeroes its column whatever x is, and a row slice of a wider x gives
    the rows of the whole product."""
    x, w, scale = _inputs(10, 48, 20)
    scale[3] = 0.0
    xt, wt, st = (torch.from_numpy(a) for a in (x, w, scale))
    y = TOPS.quant_matmul(xt, wt, st)
    assert torch.all(y[:, 3] == 0)
    torch.testing.assert_close(TOPS.quant_matmul(xt[2:7], wt, st), y[2:7],
                               rtol=0, atol=0)


def test_operand_checks():
    x, w, scale = (torch.from_numpy(a) for a in _inputs(4, 16, 8))
    with pytest.raises(ValueError):
        TQM.quant_matmul(x, w[:8], scale)
    with pytest.raises(ValueError):
        TQM.quant_matmul(x, w, scale[:4])
    with pytest.raises(TypeError):
        TQM.quant_matmul(x, w.float(), scale)
    with pytest.raises(TypeError):
        TQM.quant_matmul(x.double(), w, scale)


@pytest.mark.cuda
def test_quant_matmul_kernel_matches_plain_on_gpu():
    """The CUDA kernel against its plain version on the card, within 1e-4
    of the largest |output| (the f32 sums run in another order), with x a
    row slice of a NaN-poisoned buffer so a read past the edge would
    show."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    n0 = TQM.LAUNCHES
    for m, k, n, xdtype in QM_CASES + [(4, 4096, 11008, "bfloat16")]:
        x, w, scale = _inputs(m, k, n)
        buf = torch.full((m + 5, k + 3), float("nan"), device="cuda")
        buf[:m, :k] = torch.from_numpy(x).cuda()
        xt = buf.to(getattr(torch, xdtype))[:m, :k]
        wt, st = torch.from_numpy(w).cuda(), torch.from_numpy(scale).cuda()
        got = TQM.quant_matmul(xt, wt, st)
        torch.cuda.synchronize()
        want = TQM.quant_matmul_plain(xt, wt, st)
        assert torch.isfinite(got).all()
        tol = TOL * float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=0, atol=tol)
    assert TQM.LAUNCHES == n0 + len(QM_CASES) + 1
