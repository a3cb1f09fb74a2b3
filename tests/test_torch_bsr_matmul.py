"""The port's block-sparse int8 matmul against the Pallas kernels.

The JAX side runs ``bsr_matmul`` / ``bsr_matmul_stacked`` in interpret mode;
the port's wrappers run their plain version on these CPU tensors. The same
numpy inputs feed both. Tolerances are ``tests/test_kernels.py``'s: 1e-5
for f32 inputs and 2e-2 for bf16 (the two frameworks order the f32 sums
differently). Inside the port the stacked entry point must equal the
single-layer one bit for bit. The CUDA kernel itself is held against the
plain version by the ``cuda``-marked test, which runs only on a GPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import deploy as TD
from repro_torch.core.cim_layer import CIMConfig
from repro_torch.core.mapping import pack_bsr
from repro_torch.core.quant import QuantConfig
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.kernels import cim_bsr_matmul as TK

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
KEYS = ("blocks", "scales", "row_idx", "nnz")


def _reference():
    """JAX and the Pallas kernels, imported only by the tests that compare
    against them: the GPU machine that runs the ``cuda`` test has no JAX."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import cim_bsr_matmul as RK
    return jnp, RK


BSR_CASES = [
    # (m, k, n, bk, bn, density, xdtype) - tests/test_kernels.py's cases
    (128, 256, 256, 128, 128, 0.5, "float32"),
    (64, 512, 384, 128, 128, 0.3, "float32"),
    (256, 256, 512, 128, 128, 0.0, "float32"),  # fully pruned
    (256, 256, 512, 128, 128, 1.0, "bfloat16"),  # dense
    (128, 128, 128, 64, 64, 0.6, "float32"),  # small blocks
    (32, 768, 256, 128, 128, 0.25, "bfloat16"),
    (128, 512, 256, 256, 128, 0.5, "float32"),  # rectangular blocks
]


def _sparse_weight(rng, k, n, bk, bn, density):
    """Random int8-level weight with block sparsity."""
    keep = rng.random((k // bk, n // bn)) < density
    w = rng.integers(-7, 8, size=(k, n)).astype(np.int8)
    mask = np.repeat(np.repeat(keep, bk, axis=0), bn, axis=1)
    return (w * mask).astype(np.int8)


def _packing(seed, k, n, bk, bn, density, nnz_max=None, scale=1.0 / 8):
    rng = np.random.default_rng(seed)
    bsr = pack_bsr(_sparse_weight(rng, k, n, bk, bn, density), bk, bn,
                   nnz_max=nnz_max)
    scales = np.full(bsr.row_idx.shape, scale, np.float32)
    return rng, [bsr.blocks, scales, bsr.row_idx, bsr.nnz]


def _t(a):
    return torch.from_numpy(np.array(a))


def _both(x, arrs, xdtype, m):
    """(Pallas interpret result, port result) for a single-layer packing."""
    jnp, RK = _reference()
    want = RK.bsr_matmul(jnp.asarray(x, getattr(jnp, xdtype)),
                         *[jnp.asarray(a) for a in arrs],
                         bm=min(128, m), interpret=True)
    got = TK.bsr_matmul(_t(x).to(TORCH[xdtype]), *[_t(a) for a in arrs])
    return np.asarray(want), got


@pytest.mark.parametrize("m,k,n,bk,bn,density,xdtype", BSR_CASES)
def test_bsr_matmul_plain_vs_pallas(m, k, n, bk, bn, density, xdtype):
    rng, arrs = _packing(42 + m + k + n, k, n, bk, bn, density)
    x = rng.standard_normal((m, k)).astype(np.float32)
    want, got = _both(x, arrs, xdtype, m)
    tol = TOL[xdtype]
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    # the stacked entry point with L = 1, against its own Pallas twin
    tx = _t(x).to(TORCH[xdtype])
    got_st = TK.bsr_matmul_stacked(tx, *[_t(a)[None] for a in arrs],
                                   torch.tensor([0], dtype=torch.int32))
    jnp, RK = _reference()
    want_st = RK.bsr_matmul_stacked(
        jnp.asarray(x, getattr(jnp, xdtype)),
        *[jnp.asarray(a)[None] for a in arrs],
        jnp.int32(0), bm=min(128, m), interpret=True)
    np.testing.assert_allclose(got_st.numpy(), np.asarray(want_st),
                               rtol=tol, atol=tol)
    assert torch.equal(got_st, got)
    assert got.dtype == torch.float32 and got.shape == (m, n)


def test_bsr_poisoned_padding_never_counted():
    """Padding slots hold 99s; both versions must mask them by nnz."""
    rng, arrs = _packing(0, 256, 256, 128, 128, 0.5)
    clean = arrs[0].copy()
    assert (arrs[3] < arrs[0].shape[1]).any()  # some column has padding
    for j in range(arrs[0].shape[0]):
        arrs[0][j, arrs[3][j]:] = 99
    x = rng.standard_normal((128, 256)).astype(np.float32)
    want, got = _both(x, arrs, "float32", 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    clean_got = TK.bsr_matmul(_t(x), _t(clean), *[_t(a) for a in arrs[1:]])
    assert torch.equal(got, clean_got)


def test_bsr_truncated_packing():
    """nnz > nnz_max: only the stored slots count, in both versions."""
    rng, arrs = _packing(7, 512, 256, 64, 64, 0.9, nnz_max=3)
    assert (arrs[3] > 3).any()
    x = rng.standard_normal((24, 512)).astype(np.float32)
    want, got = _both(x, arrs, "float32", 24)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _layer_stack():
    """Four layers: unpruned (sets the envelope), sparse, all-zero, and a
    truncated packing (true counts above its stored slots)."""
    cim = CIMConfig(quant=QuantConfig(w_bits=8, a_bits=8, group_size=16,
                                      a_signed=True),
                    sparsity=SparsityConfig(alpha=16, n=16), mode="qat")
    rng = np.random.default_rng(3)
    dws = []
    for ts, zero in ((0.0, False), (0.9, False), (0.5, True)):
        w = rng.standard_normal((64, 128)).astype(np.float32) * 0.2
        dws.append(TD.deploy_weight(torch.from_numpy(w * (not zero)), cim,
                                    bk=16, bn=16, target_sparsity=ts))
    levels = rng.integers(-127, 128, (64, 128)).astype(np.int8)
    bsr = pack_bsr(levels, 16, 16, nnz_max=2)
    dws.append(TD.DeployedWeight([{
        "blocks": _t(bsr.blocks), "row_idx": _t(bsr.row_idx),
        "nnz": _t(bsr.nnz), "density": bsr.density,
        "scales": torch.full(bsr.row_idx.shape, 1 / 128)}], 64, 128, 8))
    return dws, TD.stack_deployed(dws)


def test_bsr_stacked_layers_match_pallas_and_single_layer():
    jnp, RK = _reference()
    dws, sw = _layer_stack()
    st = [getattr(sw, k) for k in KEYS]
    x = np.random.default_rng(1).standard_normal((5, 64)).astype(np.float32)
    for i, dw in enumerate(dws):
        want = RK.bsr_matmul_stacked(
            jnp.asarray(x), *[jnp.asarray(a.numpy()) for a in st],
            jnp.int32(i), bm=8, interpret=True)
        got = TK.bsr_matmul_stacked(_t(x), *st,
                                    torch.tensor([i], dtype=torch.int32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5, err_msg=f"layer {i}")
        single = TK.bsr_matmul(_t(x), *[dw.packed[0][k] for k in KEYS])
        assert torch.equal(got, single), f"layer {i}"
    assert int(sw.nnz[2].sum()) == 0
    assert torch.count_nonzero(TK.bsr_matmul_stacked(_t(x), *st, 2)) == 0


def test_bsr_wrapper_rejects_bad_operands():
    _, arrs = _packing(0, 128, 128, 64, 64, 0.5)
    ts = [_t(a) for a in arrs]
    with pytest.raises(ValueError):
        TK.bsr_matmul(torch.zeros(4, 100), *ts)  # K not a multiple of bk
    with pytest.raises(TypeError):
        TK.bsr_matmul(torch.zeros(4, 128, dtype=torch.float16), *ts)
    with pytest.raises(TypeError):
        TK.bsr_matmul(torch.zeros(4, 128), ts[0].float(), *ts[1:])


@pytest.mark.cuda
def test_bsr_kernel_matches_plain_on_gpu():
    """The CUDA kernel against its plain version, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    cases = [(m, k, n, bk, bn, d, xd, None) for m, k, n, bk, bn, d, xd
             in BSR_CASES] + [(24, 512, 256, 64, 64, 0.9, "float32", 3),
                              (3, 96, 120, 24, 40, 0.7, "bfloat16", None)]
    for m, k, n, bk, bn, density, xdtype, nmax in cases:
        rng, arrs = _packing(m + k, k, n, bk, bn, density, nnz_max=nmax)
        for j in range(arrs[0].shape[0]):  # poison every padding slot
            arrs[0][j, arrs[3][j]:] = 99
        x = _t(rng.standard_normal((m, k)).astype(np.float32)).to(
            dev, TORCH[xdtype])
        ops = [_t(a).to(dev)[None] for a in arrs]
        n0 = TK.LAUNCHES
        got = TK.bsr_matmul_stacked(x, *ops, 0)
        torch.cuda.synchronize()
        assert TK.LAUNCHES == n0 + 1
        want = TK.bsr_matmul_stacked_plain(x, *ops, 0)
        tol = TOL[xdtype]
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    dws, sw = _layer_stack()
    st = [getattr(sw, k).to(dev) for k in KEYS]
    x = torch.randn(5, 64, device=dev)
    ids = torch.arange(len(dws), dtype=torch.int32, device=dev)
    for i, dw in enumerate(dws):
        got = TK.bsr_matmul_stacked(x, *st, ids[i:i + 1])
        single = TK.bsr_matmul(x, *[dw.packed[0][k].to(dev) for k in KEYS])
        assert torch.equal(got, single)
        torch.testing.assert_close(
            got, TK.bsr_matmul_stacked_plain(x, *st, i), rtol=1e-5, atol=1e-5)
