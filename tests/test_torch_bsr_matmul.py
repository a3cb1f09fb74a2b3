"""The port's block-sparse int8 matmul against the Pallas kernels.

The JAX side runs ``bsr_matmul`` / ``bsr_matmul_stacked`` in interpret mode;
the port's wrappers run their plain version on these CPU tensors. The same
numpy inputs feed both. Tolerances are ``tests/test_kernels.py``'s: 1e-5
for f32 inputs and 2e-2 for bf16 (the two frameworks order the f32 sums
differently). Inside the port the stacked entry point must equal the
single-layer one bit for bit. The CUDA kernel itself is held against the
plain version by the ``cuda``-marked tests, which run only on a GPU. What
the kernel's dispatch decides is pure Python and tested here: ``plan`` and
``launch_plan`` (tile height, S slots per split, load path), and the
invariant that keeps loop = scan bit for bit: a layer's own packing and
the padded envelope cut every column's slots alike.
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


# --- the launch plan (pure Python; the kernel follows it on the card) ---


def _ranges(p, nnz, nmax):
    """Per column, the slot ranges the kernel's splits take: split z holds
    slots [z * S, (z + 1) * S) below min(nnz, nmax), empty runs dropped."""
    out = []
    for c in nnz.tolist():
        cnt, s = min(c, nmax), p.slots
        out.append([(z * s, min(z * s + s, cnt))
                    for z in range(p.splits(nmax)) if z * s < cnt])
    return out


@pytest.mark.parametrize("m", [1, 4, 17, 129])
@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
def test_plan_cuts_layer_packing_and_envelope_alike(m, xdtype):
    """The loop runtime's per-layer packings (their own nnz_max; one is
    truncated) and StackedWeight.layer(i) against the scan runtime's
    envelope: the same plan, and every column the same slot ranges up to
    the layer's own count. Past it the envelope holds zero blocks with zero
    scales (the truncated layer), which add exact zeros."""
    dws, sw = _layer_stack()
    x = torch.zeros((m, sw.d_in), dtype=TORCH[xdtype])
    env, env_splits = TK.launch_plan(x, sw.blocks)
    nmax_env = sw.blocks.shape[2]
    assert env_splits == env.splits(nmax_env)
    for i, dw in enumerate(dws):
        for own in (dw.packed[0], sw.layer(i).packed[0]):
            p, _ = TK.launch_plan(x, own["blocks"][None])
            assert p == env, i
            nmax = own["blocks"].shape[1]
            mine = _ranges(p, own["nnz"], nmax)
            theirs = _ranges(env, sw.nnz[i], nmax_env)
            for j, (a, b) in enumerate(zip(mine, theirs)):
                cnt = min(int(own["nnz"][j]), nmax)
                cut = [(lo, min(hi, cnt)) for lo, hi in b if lo < cnt]
                assert a == cut, (i, j)
                read = min(int(sw.nnz[i, j]), nmax_env)  # the envelope's
                assert not sw.scales[i, j, cnt:read].any(), (i, j)
                assert not sw.blocks[i, j, cnt:read].any(), (i, j)


@pytest.mark.parametrize("nmax,n_layers", [(1, 1), (5, 1), (5, 7), (40, 3)])
def test_plan_reads_no_slot_count_and_no_depth(nmax, n_layers):
    """S comes from M, K / bk, go, bn and the SM count alone."""
    x = torch.zeros((4, 1024), dtype=torch.float32)
    base, _ = TK.launch_plan(x, torch.zeros((1, 6, 2, 128, 64),
                                            dtype=torch.int8))
    p, splits = TK.launch_plan(
        x, torch.zeros((n_layers, 6, nmax, 128, 64), dtype=torch.int8))
    assert p == base
    assert splits == -(-nmax // p.slots) and (splits - 1) * p.slots < nmax


@pytest.mark.parametrize("m,bm", [(1, 16), (4, 16), (16, 16), (17, 64),
                                  (128, 64), (129, 64)])
def test_plan_tile_height_follows_m(m, bm):
    for dt in (torch.float32, torch.bfloat16):
        p = TK.plan(m, 86, 32, 128, dt, True)
        assert p.bm == bm and 1 <= p.slots <= TK.MAX_SLOTS
        assert p.smem_bytes <= 232448 and p.blocks_per_sm >= 1


@pytest.mark.parametrize("m", [4, 128])
def test_plan_fills_the_card_at_w_down(m):
    """yi-6b's w_down (K 11008 = 86 blocks of 128, go 32): at about 28 live
    slots a column the splits give at least one block per SM (decode:
    several times over), where one block per column gave 32 or 64."""
    p = TK.plan(m, 86, 32, 128, torch.float32, True)
    blocks = -(-m // p.bm) * 32 * -(-28 // p.slots)
    assert blocks >= TK.SMS * (2 if m <= 16 else 1), (p, blocks)


@pytest.mark.parametrize("bk,bn,xdtype,aligned,copy", [
    (128, 128, "float32", True, True), (128, 128, "bfloat16", True, False),
    (64, 64, "float32", True, True), (16, 16, "bfloat16", True, False),
    (40, 24, "float32", False, False),   # bn not a multiple of 16
    (24, 40, "bfloat16", False, False),  # bn not a multiple of 16
    (12, 32, "float32", True, False),    # bk * 4 = 48 bytes, bf16 copy 24
    (12, 32, "bfloat16", False, False),  # bk * 2 bytes = 24
])
def test_load_path(bk, bn, xdtype, aligned, copy):
    """The 16-byte path, and whether f32 x goes through its bf16 copy (on
    the 16-byte path, when the copy's rows are whole 16-byte chunks too)."""
    x = torch.zeros((3, 10 * bk), dtype=TORCH[xdtype])
    blocks = torch.zeros((1, 2, 3, bk, bn), dtype=torch.int8)
    p, _ = TK.launch_plan(x, blocks)
    assert p.path == ("aligned" if aligned else "masked")
    assert p.copy == copy
    if aligned:  # an x that starts off 16 bytes takes the masked path
        shifted = torch.zeros(3 * 10 * bk + 1, dtype=TORCH[xdtype])[1:]
        p2, _ = TK.launch_plan(shifted.view(3, 10 * bk), blocks)
        assert p2.path == "masked" and not p2.copy


# --- the kernel on the card ---

GPU_CASES = [
    # (m, k, n, bk, bn, x kind, truncate): x kinds "eq5" (f32 on the eq. 5
    # grid, one MMA plane), "f32" (off the grid, three planes), "bf16"
    (1, 1024, 512, 128, 128, "eq5", None),
    (4, 2048, 1024, 128, 128, "eq5", None),
    (17, 1024, 512, 128, 128, "f32", None),
    (129, 1024, 512, 128, 128, "bf16", None),
    (129, 2048, 384, 128, 128, "eq5", 3),      # truncated packing
    (4, 1024, 640, 64, 128, "f32", None),
    (17, 400, 240, 40, 24, "eq5", None),       # masked path
    (129, 400, 240, 40, 24, "bf16", None),     # masked path
    (1, 480, 200, 24, 40, "f32", None),        # masked path, bk != bn
    (64, 768, 192, 192, 96, "bf16", 2),        # bn 96: a part column tile
]
GPU_TOL = {"eq5": 1e-5, "f32": 1e-5, "bf16": 2e-2}


def _gpu_stack(case, dev):
    """Two layers packed on their own (the loop runtime's form) and as
    the envelope (the scan runtime's), padding slots poisoned in both: 99
    blocks, NaN scales, out-of-range row indices."""
    m, k, n, bk, bn, kind, trunc = case
    rng = np.random.default_rng(m * 31 + k + bn)
    dws = []
    for layer, density in enumerate((0.55, 0.3)):
        levels = rng.integers(-127, 128, (k, n)).astype(np.int8)
        keep = rng.random((k // bk, n // bn)) < density
        levels *= np.repeat(np.repeat(keep, bk, 0), bn, 1).astype(np.int8)
        bsr = pack_bsr(levels, bk, bn, nnz_max=trunc if layer == 0 else None)
        scales = rng.uniform(0.5, 1.5, bsr.row_idx.shape).astype(
            np.float32) / 128
        dws.append(TD.DeployedWeight([{
            "blocks": _t(bsr.blocks), "scales": _t(scales),
            "row_idx": _t(bsr.row_idx), "nnz": _t(bsr.nnz),
            "density": bsr.density}], k, n, 8))
    sw = TD.stack_deployed(dws)
    env = {key: getattr(sw, key).clone() for key in KEYS}
    own = [{key: dw.packed[0][key].clone() for key in KEYS} for dw in dws]
    for pk in own + [{key: v[i] for key, v in env.items()}
                     for i in range(2)]:
        nmax = pk["blocks"].shape[1]
        for j in range(pk["blocks"].shape[0]):
            cnt = min(int(pk["nnz"][j]), nmax)
            pk["blocks"][j, cnt:] = 99
            pk["scales"][j, cnt:] = float("nan")
            pk["row_idx"][j, cnt:] = 10 ** 6
    x = rng.standard_normal((m, k)).astype(np.float32)
    if kind == "eq5":
        x = np.round(np.clip(x, -1, 1) * 127) / 128
    xt = _t(x).to(dev, torch.bfloat16 if kind == "bf16" else torch.float32)
    to = lambda pk: [pk[key].to(dev) for key in KEYS]
    return xt, to(env), [to(pk) for pk in own]


@pytest.mark.cuda
@pytest.mark.parametrize("case", GPU_CASES)
def test_bsr_kernel_cases_on_gpu(case):
    """Kernel against plain (f32 x off the eq. 5 grid: against the plain
    version's function in f64), a second call bit for bit, each layer's own
    packing bit for bit against the envelope, the load path the plan
    names, and NaN for a layer id out of range."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    x, env, own = _gpu_stack(case, dev)
    tol = GPU_TOL[case[5]]
    for i in range(2):
        before = dict(TK.LAUNCHES_BY_PATH)
        got = TK.bsr_matmul_stacked(x, *env, i)
        again = TK.bsr_matmul_stacked(x, *env,
                                      torch.tensor([i], dtype=torch.int32,
                                                   device=dev))
        single = TK.bsr_matmul(x, *own[i])
        torch.cuda.synchronize()
        p, splits = TK.launch_plan(x, env[0])
        path = f"{'split' if splits > 1 else 'single'} {p.path}"
        assert TK.LAUNCHES_BY_PATH[path] >= before[path] + 2
        assert torch.equal(got, again), (case, i)
        assert torch.equal(got, single), (case, i)
        want = TK.bsr_matmul_stacked_plain(x, *env, i)
        if case[5] == "f32":  # off the grid: the f64 product
            want = x.double() @ TK.dense_weight(*env, i, x.shape[1],
                                                torch.float64)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.to(want.dtype), want, rtol=tol,
                                   atol=tol)
    bad = TK.bsr_matmul_stacked(x, *env, 5)
    torch.cuda.synchronize()
    assert bad.isnan().all()
