"""The port's SSD intra-chunk block and chunked SSD scan against the
reference.

``ssd_intra_chunk_plain`` (what the wrapper runs on CPU tensors) is held
against the Pallas kernel in interpret mode and the float64 oracle
``ref.ssd_intra_ref`` on ``tests/test_kernels.py``'s cases, at that file's
tolerances: 1e-4 for f32 (the frameworks order the f32 sums differently)
and 3e-2 for bf16 (the output is rounded to bf16). The port's
``ssd_chunked`` is held against ``repro.models.ssm.ssd_chunked`` at 1e-4
over several chunks, a ragged tail and an entering state. The CUDA kernel
itself is held against the plain version by the ``cuda``-marked test, which
runs only on a GPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ssd_intra as TK
from repro_torch.models import ssm as TSSM

SSD_CASES = [
    # (C, H, l, N, P, dtype) - tests/test_kernels.py's cases
    (4, 2, 64, 16, 32, "float32"),
    (2, 3, 128, 32, 64, "float32"),
    (1, 1, 16, 8, 8, "float32"),
    (3, 2, 64, 16, 32, "bfloat16"),
]
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _reference():
    """JAX and the reference, imported only by the tests that compare
    against them: the GPU machine that runs the ``cuda`` test has no JAX."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as ROPS
    from repro.kernels import ref as RREF
    from repro.models import ssm as RSSM
    return jnp, ROPS, RREF, RSSM


def _inputs(C, H, l, N, P, seed):
    """test_kernels.py's draws: negative decay logits, 0.3-scaled normals."""
    rng = np.random.default_rng(seed)
    a = (-np.abs(rng.standard_normal((C, H, l))) * 0.1).astype(np.float32)
    b = (rng.standard_normal((C, l, N)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((C, l, N)) * 0.3).astype(np.float32)
    x = (rng.standard_normal((C, l, H, P)) * 0.3).astype(np.float32)
    return a, b, c, x


def _torch(a, dtype="float32"):
    from repro_torch.convert import tensor_from_numpy
    return tensor_from_numpy(np.asarray(a), torch.device("cpu")).to(
        getattr(torch, dtype))


@pytest.mark.parametrize("C,H,l,N,P,dtype", SSD_CASES)
def test_ssd_intra_plain_matches_pallas_and_oracle(C, H, l, N, P, dtype):
    jnp, ROPS, RREF, _ = _reference()
    a, b, c, x = _inputs(C, H, l, N, P, C * 10 + l)
    aj = jnp.asarray(a)
    bj, cj, xj = (jnp.asarray(t, getattr(jnp, dtype)) for t in (b, c, x))
    at, bt, ct, xt = _torch(aj), _torch(bj), _torch(cj), _torch(xj)
    got = TK.ssd_intra_chunk(at, bt, ct, xt)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    got32 = TK.ssd_intra_chunk(at, bt, ct, xt, out_dtype=torch.float32)
    assert got32.dtype == torch.float32
    tol = TOL[dtype]
    for want in (ROPS.ssd_intra(aj, bj, cj, xj, interpret=True),
                 RREF.ssd_intra_ref(aj, bj, cj, xj)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=tol)
        np.testing.assert_allclose(got32.numpy(), want, rtol=tol, atol=tol)


def _chunked_inputs(B, S, H, P, N, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, H, P)) * 0.3).astype(np.float32)
    a = (-np.abs(rng.standard_normal((B, S, H))) * 0.1).astype(np.float32)
    b = (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32)
    h0 = (rng.standard_normal((B, H, P, N)) * 0.3).astype(np.float32)
    return x, a, b, c, h0


@pytest.mark.parametrize("S,chunk,with_h0", [
    (64, 16, False),   # four whole chunks
    (53, 16, False),   # ragged tail: zero-padded steps
    (53, 16, True),    # and an entering state
    (24, 24, True),    # one chunk
])
def test_ssd_chunked_matches_reference(S, chunk, with_h0):
    jnp, _, _, RSSM = _reference()
    x, a, b, c, h0 = _chunked_inputs(2, S, 3, 8, 6, S + chunk)
    kw = dict(h0=jnp.asarray(h0)) if with_h0 else {}
    want_y, want_h = RSSM.ssd_chunked(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), jnp.asarray(c),
        chunk, **kw)
    got_y, got_h = TSSM.ssd_chunked(
        *(torch.from_numpy(t) for t in (x, a, b, c)), chunk,
        h0=torch.from_numpy(h0) if with_h0 else None)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=1e-4,
                               atol=1e-4)


def test_ssd_step_continues_the_chunked_scan():
    """ssd_chunked over S+1 steps == ssd_chunked over S, then one ssd_step,
    inside the port (the decode recurrence continues the prefill state)."""
    x, a, b, c, _ = _chunked_inputs(2, 33, 3, 8, 6, 4)
    t = [torch.from_numpy(v) for v in (x, a, b, c)]
    y_all, h_all = TSSM.ssd_chunked(*t, 16)
    _, h = TSSM.ssd_chunked(*(v[:, :32] for v in t), 16)
    y1, h1 = TSSM.ssd_step(h, t[0][:, 32], t[1][:, 32], t[2][:, 32],
                           t[3][:, 32])
    torch.testing.assert_close(y1, y_all[:, 32], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h1, h_all, rtol=1e-5, atol=1e-5)


def test_ssd_chunked_refuses_low_precision_intra():
    t = [torch.from_numpy(v) for v in _chunked_inputs(1, 16, 2, 4, 4, 0)[:4]]
    with pytest.raises(NotImplementedError):
        TSSM.ssd_chunked(*t, 16, intra_dtype=torch.bfloat16)


def test_ssd_intra_wrapper_checks():
    a, b, c, x = (torch.from_numpy(t) for t in _inputs(2, 3, 16, 4, 8, 0))
    with pytest.raises(ValueError):
        TK.ssd_intra_chunk(a, b[:, :8], c, x)  # l disagrees
    with pytest.raises(ValueError):
        TK.ssd_intra_chunk(a, b, c, x[:, :, :2])  # H disagrees
    with pytest.raises(ValueError):
        TK.ssd_intra_chunk(a[0], b, c, x)  # a not (C, H, l)


@pytest.mark.cuda
def test_ssd_intra_kernel_matches_plain_on_gpu():
    """The CUDA kernel against its plain version on the card: f32 in and
    out at 1e-4, bf16 in with f32 or bf16 out at 2e-2."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cases = [case[:5] for case in SSD_CASES] + [(3, 2, 100, 20, 70),
                                                (2, 4, 256, 128, 64)]
    for C, H, l, N, P in cases:
        a, b, c, x = (torch.from_numpy(t).cuda()
                      for t in _inputs(C, H, l, N, P, l))
        for dt, out, tol in ((torch.float32, torch.float32, 1e-4),
                             (torch.bfloat16, torch.float32, 2e-2),
                             (torch.bfloat16, torch.bfloat16, 2e-2)):
            args = (a, b.to(dt), c.to(dt), x.to(dt))
            n0 = TK.LAUNCHES
            got = TK.ssd_intra_chunk(*args, out_dtype=out)
            torch.cuda.synchronize()
            assert TK.LAUNCHES == n0 + 1 and got.dtype == out
            want = TK.ssd_intra_chunk_plain(*args, out_dtype=out)
            torch.testing.assert_close(got, want, rtol=tol, atol=tol)
