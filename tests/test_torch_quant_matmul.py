"""The port's dense int8 matmul (``quant_matmul``) against the Pallas
kernel and the reference's oracle.

On these CPU tensors the port's entry point runs its plain version; the
JAX side runs ``repro.kernels.quant_matmul.quant_matmul`` in interpret mode
and ``ref.quant_matmul_ref``, on test_kernels.py's four shapes. Both sides
cast x to f32 exactly (bf16 widens without rounding), multiply int8 levels
exactly and sum in f32, so only the order of the f32 sums differs:
tolerance 1e-4, relative and absolute, for f32 and bf16 x alike. The CUDA
kernel itself is held against the plain version by the ``cuda``-marked
test, which runs only on a GPU. What the kernel's dispatch decides is pure
Python and tested here: ``plan`` (tile height, split-K slices, load path),
``is_aligned`` (the 16-byte path's conditions) and ``split_bf16x3``, the
CPU twin of the kernel's exact three-plane split of f32 x.
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


# (m, k, n, x dtype): full-width yi-6b's w_gate / w_down at decode and
# prefill rows, and benchmarks/kernel_bench.py's shape
YI_CASES = [(4, 4096, 11008, "bfloat16"), (128, 4096, 11008, "bfloat16"),
            (4, 11008, 4096, "bfloat16"), (128, 11008, 4096, "bfloat16"),
            (256, 1024, 1024, "float32")]


@pytest.mark.parametrize("m,bm", [(1, 16), (4, 16), (16, 16), (17, 64),
                                  (128, 128), (256, 128)])
def test_plan_tile_height_follows_m(m, bm):
    """bf16 x takes 16 / 64 / 128 rows; f32 x stops at 64 (its stage is
    twice as wide and each k-step three MMAs deep)."""
    p = TQM.plan(m, 4096, 4096, torch.bfloat16, True)
    assert p.bm == bm
    p32 = TQM.plan(m, 4096, 4096, torch.float32, True)
    assert p32.bm == min(bm, 64)
    for q in (p, p32):
        assert q.smem_bytes <= TQM.SMEM_LIMIT and q.blocks_per_sm >= 1


@pytest.mark.parametrize("m,k,n,xdtype", YI_CASES + QM_CASES)
def test_plan_slices_cover_k(m, k, n, xdtype):
    """Split-K slices are whole stages, at least one stage each, and
    together cover K exactly once; a grid of a whole wave or more is not
    split, nor cut past one wave."""
    p = TQM.plan(m, n, k, getattr(torch, xdtype), True)
    assert p.k_slice % TQM.BK == 0 and p.k_slice >= TQM.BK
    assert (p.splits - 1) * p.k_slice < max(k, 1) <= p.splits * p.k_slice
    tiles = -(-m // p.bm) * -(-n // TQM.BN)
    wave = TQM.SMS * p.blocks_per_sm
    if tiles >= wave:
        assert p.splits == 1
    assert p.splits == 1 or tiles * p.splits <= wave


@pytest.mark.parametrize("m,k,n", [(4, 4096, 11008), (4, 11008, 4096)])
def test_plan_splits_yi6b_decode(m, k, n):
    """Decode rows fill too few tiles for the card (86 and 32 of 132 SMs),
    so K is cut into slices."""
    p = TQM.plan(m, n, k, torch.bfloat16, True)
    assert p.bm == 16 and p.splits >= 2
    assert -(-m // p.bm) * -(-n // TQM.BN) * p.splits >= TQM.SMS


@pytest.mark.parametrize("m,k,n,xdtype", YI_CASES)
def test_yi6b_and_kernel_bench_take_the_aligned_path(m, k, n, xdtype):
    x = torch.zeros((m, k), dtype=getattr(torch, xdtype))
    w = torch.zeros((k, n), dtype=torch.int8)
    scale = torch.zeros(n)
    assert TQM.is_aligned(x, w, scale)
    assert TQM.is_aligned(torch.zeros((m + 8, k), dtype=x.dtype)[8:], w,
                          scale)  # a row slice of a wider buffer
    p = TQM.plan(m, n, k, x.dtype, TQM.is_aligned(x, w, scale))
    assert p.path == "aligned"


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
def test_ragged_and_strided_operands_take_the_masked_path(xdtype):
    dt = getattr(torch, xdtype)
    x, w, scale = (torch.from_numpy(a) for a in _inputs(100, 200, 300))
    assert not TQM.is_aligned(x.to(dt), w, scale)  # N = 300
    assert TQM.plan(100, 300, 200, dt, False).path == "masked"
    k, n = 4096, 11008
    buf = torch.zeros((7, k + 3), dtype=dt)  # row stride K + 3
    w, scale = torch.zeros((k, n), dtype=torch.int8), torch.zeros(n)
    assert not TQM.is_aligned(buf[:4, :k], w, scale)
    assert not TQM.is_aligned(buf[1:5, 1:k + 1], w, scale)
    wide = torch.zeros((k, n + 16), dtype=torch.int8)
    assert not TQM.is_aligned(torch.zeros((4, k), dtype=dt),
                              wide[:, 1:n + 1], scale)


def test_split_bf16x3_is_exact():
    """The CPU twin of the kernel's f32 split: three bf16 planes that sum
    to x bit for bit over 120 octaves, and each plane times an int8 level
    exact in f32 (held against float64)."""
    rng = np.random.default_rng(15)
    n = 200_000
    x = (rng.choice([-1.0, 1.0], n) * np.exp2(rng.uniform(-60, 60, n))
         * (1 + rng.random(n))).astype(np.float32)
    x[:4] = [0.0, 1.0, -3.0, np.float32(1 / 3)]
    xt = torch.from_numpy(x)
    planes = TQM.split_bf16x3(xt)
    assert all(p.dtype == torch.bfloat16 for p in planes)
    total = (planes[0].float() + planes[1].float()) + planes[2].float()
    assert torch.equal(total, xt)
    w = torch.from_numpy(rng.integers(-127, 128, n).astype(np.float32))
    for p in planes:
        prod = p.float() * w
        assert torch.equal(prod.double(), p.double() * w.double())


@pytest.mark.cuda
def test_quant_matmul_kernel_matches_plain_on_gpu():
    """The CUDA kernel against its plain version on the card, within 1e-4
    of the largest |output| (the f32 sums run in another order), with x a
    row slice of a NaN-poisoned buffer so a read past the edge would
    show; at the tile-height edges, split-K shapes, K shorter than one
    stage and N < 8; a second call must give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    extra = [(4, 4096, 11008, "bfloat16"), (1, 1024, 512, "bfloat16"),
             (16, 1024, 512, "float32"), (17, 1024, 512, "bfloat16"),
             (64, 512, 384, "float32"), (65, 512, 384, "bfloat16"),
             (4, 11008, 4096, "bfloat16"), (8, 4096, 1024, "float32"),
             (96, 40, 256, "bfloat16"), (24, 8, 128, "float32"),
             (33, 520, 5, "float32"), (9, 96, 7, "bfloat16")]
    n0 = TQM.LAUNCHES
    for m, k, n, xdtype in QM_CASES + extra:
        x, w, scale = _inputs(m, k, n)
        buf = torch.full((m + 5, k + 3), float("nan"), device="cuda")
        buf[:m, :k] = torch.from_numpy(x).cuda()
        wt, st = torch.from_numpy(w).cuda(), torch.from_numpy(scale).cuda()
        for xt in (buf.to(getattr(torch, xdtype))[:m, :k],
                   torch.from_numpy(x).cuda().to(getattr(torch, xdtype))):
            got = TQM.quant_matmul(xt, wt, st)
            again = TQM.quant_matmul(xt, wt, st)
            torch.cuda.synchronize()
            want = TQM.quant_matmul_plain(xt, wt, st)
            assert torch.isfinite(got).all()
            assert torch.equal(got, again)
            tol = TOL * float(want.abs().max())
            torch.testing.assert_close(got, want, rtol=0, atol=tol)
    assert TQM.LAUNCHES == n0 + 4 * (len(QM_CASES) + len(extra))
