"""The grouped float product's kernel design (``csrc/grouped_matmul.cu``),
held on the CPU: its launch plan, its operand handling and a CPU emulation
of its arithmetic.

* ``plan()`` reads the two types, K and N and nothing else: it is the same
  for every row count and every ``counts``, and changes only with the
  types, K or N.
* The emulation follows the kernel's algorithm on each route. Tensor
  cores (bf16 w): x split into exact bf16 planes (``split_bf16x3``), rows
  in blocks of ``rows`` and row tiles of ``row_tile``, each step of
  ``step_k`` rows of K summed per plane from zero in k16 products (a k16
  product's 16 terms are exact; the tensor core's addition into its
  accumulator is taken as rounding toward zero, as its truncation does),
  the planes added smallest first, the step folded into an f32 running sum
  with its TwoSum error carried, y = run + err. CUDA cores (f32 x and w):
  thread t of the cluster's T chains k = t, t + T, ... in fused
  multiply-adds, a xor butterfly combines each warp's lanes, and the warps
  and then the cluster's blocks are added in order.
* The emulation is within the card's tolerances (f32 1e-5, bf16 2e-2 of
  max |y|, as chip_smoke's GM_F32_TOL / GM_BF16_TOL) of an f64 product,
  and each row of it is bit for bit the same at every R, at every place in
  the row blocks and tiles, and whatever the other rows hold.

The ``cuda`` case holds the kernel itself to the same on the card; it
skips without one.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import grouped_matmul as GM
from repro_torch.kernels import quant_matmul as QM

F32_TOL, BF16_TOL = 1e-5, 2e-2
ROWS = (1, 2, 8, 20, 40, 47, 48, 49, 63, 64, 65, 128)
TYPES = [(torch.float32, torch.bfloat16), (torch.bfloat16, torch.bfloat16),
         (torch.float32, torch.float32)]


def _inputs(g, r, k, n, xt, wt, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((g, r, k), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((g, k, n), dtype=np.float32)
                         / np.float32(np.sqrt(k)))
    return x.to(xt), w.to(wt)


def _toward_zero(v: torch.Tensor) -> torch.Tensor:
    """f64 values rounded to f32 toward zero."""
    r = v.float()
    over = r.double().abs() > v.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def _two_sum(s: torch.Tensor, v: torch.Tensor):
    t = s + v
    vv = t - s
    return t, (s - (t - vv)) + (v - vv)


def _emulate_tc(x, w, pl, counts=None):
    """The tensor-core route on one group: x (R, K), w (K, N) bf16."""
    r, k = x.shape
    planes = QM.split_bf16x3(x) if pl.planes == 3 else (x.bfloat16(),)
    # rows past R arrive as zeros (the tensor map's bounds)
    pad = -(-r // 8) * 8 - r
    planes = [torch.cat([p.double(), torch.zeros((pad, k),
                                                 dtype=torch.float64)])
              for p in planes]
    wd = w.double()
    filled = r if counts is None else min(r, max(int(counts), 0))
    y = torch.zeros((r, w.shape[1]), dtype=torch.float32)
    for r0 in range(0, r, pl.rows):
        active = min(pl.rows, filled - r0)
        if active <= 0:
            continue
        halves = -(-active // 8)  # row halves (8 rows) that hold a row
        rows = slice(r0, r0 + 8 * halves)
        run = torch.zeros((8 * halves, w.shape[1]))
        err = torch.zeros_like(run)
        for s0 in range(0, k, pl.step_k):
            acc = []
            for p in planes:
                a = torch.zeros((8 * halves, w.shape[1]), dtype=torch.float64)
                for c in range(s0, min(k, s0 + pl.step_k), 16):
                    a = _toward_zero(a + p[rows, c:c + 16] @ wd[c:c + 16]
                                     ).double()
                acc.append(a.float())
            v = acc[-1]
            for a in reversed(acc[:-1]):  # smallest first: (lo + mid) + hi
                v = v + a
            run, e = _two_sum(run, v)
            err = err + e
        y[r0:r0 + active] = (run + err)[:active]
    return y.to(x.dtype)


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _emulate_warp(x, w, pl, counts=None):
    """The CUDA-core route on one group: x (R, K), w (K, N) f32."""
    r, k = x.shape
    n = w.shape[1]
    filled = r if counts is None else min(r, max(int(counts), 0))
    t_all = pl.stage_k  # the cluster's threads, the chains' K stride
    y = torch.zeros((r, n))
    for row in range(filled):
        acc = torch.zeros((t_all, n))
        for base in range(0, k, t_all):
            ks = torch.arange(base, min(k, base + t_all))
            acc[:len(ks)] = _fma(x[row, ks, None], w[ks], acc[:len(ks)])
        lanes = acc.reshape(t_all // 32, 32, n)
        for off in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[:, torch.arange(32) ^ off]
        warps = lanes[:, 0]  # every lane holds its warp's sum
        per_block = pl.threads // 32
        blocks = []
        for b in range(pl.cluster):
            s = warps[b * per_block]
            for i in range(1, per_block):
                s = s + warps[b * per_block + i]
            blocks.append(s)
        s = blocks[0]
        for b in blocks[1:]:
            s = s + b
        y[row] = s
    return y


def _emulate(x, w, counts=None):
    """The kernel's arithmetic on the CPU, group by group."""
    pl = GM.launch_plan(x, w, counts)
    w = GM._check(x, w, counts)
    fn = _emulate_tc if pl.route == "wgmma" else _emulate_warp
    return torch.stack([fn(x[g], w[g], pl, None if counts is None
                           else counts[g]) for g in range(x.shape[0])])


@pytest.mark.parametrize("xt,wt", TYPES)
def test_plan_reads_types_k_and_n_only(xt, wt):
    """plan() is one for every R and every counts; it moves only with the
    types, K and N."""
    k, n = 4096, 6400 if wt == torch.bfloat16 else 16
    want = GM.plan(xt, wt, k, n)
    rng = np.random.default_rng(3)
    for r in ROWS:
        x = torch.empty((4, r, k), dtype=xt, device="meta")
        w = torch.empty((4, k, n), dtype=wt, device="meta")
        counts = torch.from_numpy(rng.integers(0, r + 1, 4))
        assert GM.launch_plan(x, w) == want
        assert GM.launch_plan(x, w, counts) == want
    if want.route == "warp":  # the cluster follows K, the chunk N
        assert GM.plan(xt, wt, 100, n).cluster == 1 != want.cluster
        assert GM.plan(xt, wt, k, 8).cols == 8 != want.cols
        assert GM.plan(xt, wt, k, 333).cols == 32
    else:  # the planes follow x's type; the tiles are fixed
        other = torch.bfloat16 if xt == torch.float32 else torch.float32
        assert GM.plan(other, wt, k, n).planes != want.planes
        assert GM.plan(xt, wt, 100, 130) == want
    assert GM.plan(xt, wt, k, n) is GM.plan(xt, wt, k, n)  # cached


def test_plan_routes():
    f32, bf16 = torch.float32, torch.bfloat16
    assert GM.plan(f32, f32, 4096, 16).route == "warp"
    assert GM.plan(f32, bf16, 4096, 16).route == "wgmma"
    assert GM.plan(bf16, bf16, 5376, 262144).route == "wgmma"
    assert GM.plan(f32, bf16, 1, 1).planes == 3
    assert GM.plan(bf16, bf16, 1, 1).planes == 1
    with pytest.raises(TypeError):
        GM.plan(torch.float16, bf16, 8, 8)
    with pytest.raises(TypeError):
        GM.plan(bf16, f32, 8, 8)  # the wrapper reads an f32 w as bf16


def test_split_planes_exact():
    """hi + mid + lo equals x exactly for normal f32, over a wide range of
    exponents; each plane is a bf16."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.standard_normal(20000)
                          * 2.0 ** rng.integers(-60, 60, 20000)
                          ).astype(np.float32))
    hi, mid, lo = QM.split_bf16x3(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())


@pytest.mark.parametrize("g,r,k,n,xt,wt", [
    (2, 5, 4096, 24, torch.float32, torch.bfloat16),
    (1, 3, 16384, 8, torch.float32, torch.bfloat16),
    (2, 9, 777, 72, torch.float32, torch.bfloat16),
    (2, 4, 512, 16, torch.bfloat16, torch.bfloat16),
    (1, 4, 4096, 16, torch.float32, torch.float32),
    (1, 3, 6144, 8, torch.float32, torch.float32),
    (2, 2, 300, 40, torch.float32, torch.float32),
])
def test_emulation_within_tolerance(g, r, k, n, xt, wt):
    """The kernel's arithmetic is within the card's tolerance of the f64
    product, with and without counts (rows past a count exactly 0)."""
    x, w = _inputs(g, r, k, n, xt, wt, seed=k + n)
    ref = torch.bmm(x.double(), w.to(xt).double())
    tol = BF16_TOL if xt == torch.bfloat16 else F32_TOL
    got = _emulate(x, w)
    assert got.dtype == xt
    err = float((got.double() - ref).abs().max())
    assert err <= tol * max(1.0, float(ref.abs().max())), err
    counts = torch.tensor([r - 1, 1][:g])
    got = _emulate(x, w, counts)
    for gi in range(g):
        c = int(counts[gi])
        assert not got[gi, c:].any()
        assert torch.equal(got[gi, :c], _emulate(x[gi:gi + 1, :c],
                                                 w[gi:gi + 1])[0])


def test_steps_keep_the_truncation_off_the_running_sum():
    """Why the kernel folds: with the tensor cores' truncating addition
    the emulation of one step over all of K = 16384 (grok-1's w_down)
    misses the f32 tolerance, while the plan's steps folded into the
    error-carrying sum stay far inside it."""
    x, w = _inputs(1, 3, 16384, 8, torch.float32, torch.bfloat16, seed=3)
    ref = torch.bmm(x.double(), w.double())[0]
    pl = GM.launch_plan(x, w)
    scale = float(ref.abs().max())
    err = lambda p: float((_emulate_tc(x[0], w[0], p).double() - ref)
                          .abs().max()) / scale
    assert err(pl) <= F32_TOL / 10
    assert err(dataclasses.replace(pl, step_k=16384)) > F32_TOL


@pytest.mark.parametrize("xt,wt,k,n", [
    (torch.float32, torch.bfloat16, 1000, 16),
    (torch.bfloat16, torch.bfloat16, 300, 8),
    (torch.float32, torch.float32, 700, 16),
])
def test_emulation_rows_bit_invariant(xt, wt, k, n):
    """Each row of the emulation is bit for bit the same at every R, at
    rows 0, 47, 48, 63 and 64 (other row blocks, tiles and halves), and
    whatever the other rows hold."""
    x, w = _inputs(1, 2, k, n, xt, wt, seed=11)
    want = _emulate(x, w)
    rng = np.random.default_rng(12)
    rows = (1, 2, 8, 20, 47, 48, 49, 64, 65) if wt == torch.bfloat16 \
        else (1, 2, 8, 20, 40)
    for r in rows:
        other = torch.from_numpy(rng.standard_normal(
            (1, r, k), dtype=np.float32)).to(xt)
        for at in sorted({0, min(r, 47), min(r, 48), min(r, 63),
                          min(r, 64), r}):
            xs = torch.cat([other[:, :at], x, other[:, at:]], 1)
            got = _emulate(xs, w)
            assert torch.equal(got[:, at:at + 2], want), (r, at)


def test_tma_operands():
    """The wrapper's operands for the tensor maps: taken as they are when
    16-byte aligned with strides of whole 16 bytes, else a zero-padded copy
    with rows of a multiple of 8 elements."""
    x = torch.randn(2, 3, 64)
    t, sg, sr = GM._tma_operand(x)
    assert t is x and (sg, sr) == (192, 64)
    view = torch.randn(2, 3, 100)[:, :, :64]
    t, sg, sr = GM._tma_operand(view)
    assert t is view and (sg, sr) == (300, 100)
    for odd in (torch.randn(2, 3, 30), torch.randn(3, 1, 101),
                torch.randn(1, 5, 130).bfloat16()):
        t, sg, sr = GM._tma_operand(odd)
        cols = odd.shape[2]
        assert t.shape[2] % 8 == 0 and t.shape[2] - cols < 8
        assert torch.equal(t[..., :cols], odd) and not t[..., cols:].any()
        assert sr == t.shape[2] and (sg * t.element_size()) % 16 == 0
    one = torch.randn(1, 1, 64)  # size-1 dims take the padded strides
    assert GM._tma_operand(one)[1:] == (64, 64)


def test_cpu_wrapper_is_the_plain_version():
    x, w = _inputs(3, 5, 40, 24, torch.float32, torch.bfloat16)
    counts = torch.tensor([5, 0, 2])
    assert torch.equal(GM.grouped_matmul(x, w, counts),
                       GM.grouped_matmul_plain(x, w, counts))


@pytest.mark.cuda
def test_kernel_plan_rows_and_placement_on_gpu():
    """On the card: the library's own plan equals plan(); the kernel is
    within tolerance of its plain version at row-block and tile edges and
    odd shapes, and each row is bit for bit the same at every R and at
    rows 0, 47, 48, 63 and 64."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for xt, wt in TYPES:
        for k, n in ((4096, 6400), (6144, 8), (100, 333), (250, 130)):
            assert GM.describe(xt, wt, k, n) == GM.plan(
                xt, wt, k, n).fields()
    gen = torch.Generator(device="cuda").manual_seed(2)
    for xt, wt, k, n in ((torch.float32, torch.bfloat16, 4096, 640),
                         (torch.bfloat16, torch.bfloat16, 1000, 200),
                         (torch.float32, torch.float32, 4096, 16)):
        x = torch.randn((2, 130, k), generator=gen, device="cuda").to(xt)
        w = (torch.randn((2, k, n), generator=gen, device="cuda")
             / k ** 0.5).to(wt)
        full = GM.grouped_matmul(x, w)
        want = GM.grouped_matmul_plain(x, w).float()
        tol = BF16_TOL if xt == torch.bfloat16 else F32_TOL
        assert float((full.float() - want).abs().max()) <= tol * max(
            1.0, float(want.abs().max()))
        for r in ROWS:
            assert torch.equal(GM.grouped_matmul(x[:, :r].contiguous(), w),
                               full[:, :r]), r
            other = torch.randn((2, r, k), generator=gen,
                                device="cuda").to(xt)
            for at in sorted({0, min(r, 47), min(r, 48), min(r, 63),
                              min(r, 64)}):
                xs = torch.cat([other[:, :at], x[:, :2], other[:, at:]], 1)
                assert torch.equal(GM.grouped_matmul(xs, w)[:, at:at + 2],
                                   full[:, :2]), (r, at)
