"""The port's SSD intra-chunk block and chunked SSD scan against the
reference.

``ssd_intra_chunk_plain`` (what the wrapper runs on CPU tensors) is held
against the Pallas kernel in interpret mode and the float64 oracle
``ref.ssd_intra_ref`` on ``tests/test_kernels.py``'s cases, at that file's
tolerances: 1e-4 for f32 (the frameworks order the f32 sums differently)
and 3e-2 for bf16 (the output is rounded to bf16). The port's
``ssd_chunked`` is held against ``repro.models.ssm.ssd_chunked`` at 1e-4
over several chunks, a ragged tail and an entering state. The kernel's
launch plan (which blocks own which chunk, row tile and heads) and its
arithmetic (prefix sums from the row tile's origin, S * L as bf16 hi and lo
planes) are held on the CPU; the CUDA kernel itself is held against the
plain version and the function in float64 by the ``cuda``-marked tests,
which run only on a GPU.

The backward: the port's ``ssd_chunked`` differentiated by autograd (the
plain intra-chunk version on the CPU) against ``jax.vjp`` of the
reference's, for x, a, b, c and the entering state, at 1e-4 of each
gradient's max (f32 sums in other orders). A CPU emulation of the backward
kernel's algorithm (``csrc/ssd_intra_bwd.cu``: 64 x 64 causal tiles, a
block per (chunk, column tile, head group), the products over three exact
bf16 planes of each f32 operand, one partial dS per head group summed over
the groups in order,
da from row and column sums by a reverse prefix sum) agrees with the plain
backward at 1e-5 on a small shape and within the card's bar at the
training chunk length, and gives the same bits whatever order its blocks
run in, which is what makes each call of the kernel repeat bit for bit.
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


@pytest.mark.parametrize("S,chunk,with_h0", [
    (64, 16, False),
    (53, 16, True),    # ragged tail and an entering state
])
def test_ssd_chunked_grads_match_reference(S, chunk, with_h0):
    jnp, _, _, RSSM = _reference()
    import jax
    x, a, b, c, h0 = _chunked_inputs(2, S, 3, 8, 6, S + chunk + 1)
    rng = np.random.default_rng(S)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    dh = rng.standard_normal(h0.shape).astype(np.float32)
    ins = [x, a, b, c] + ([h0] if with_h0 else [])

    def f(x, a, b, c, *h):
        return RSSM.ssd_chunked(x, a, b, c, chunk, h0=h[0] if h else None)

    _, vjp = jax.vjp(f, *(jnp.asarray(t) for t in ins))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    tins = [torch.from_numpy(t).requires_grad_() for t in ins]
    y, h = TSSM.ssd_chunked(*tins[:4], chunk,
                            h0=tins[4] if with_h0 else None)
    got = torch.autograd.grad((y, h), tins,
                              (torch.from_numpy(dy), torch.from_numpy(dh)))
    for name, w, g in zip("x a b c h0".split(), want, got):
        w = np.asarray(w)
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= 1e-4, (name, err)


def _planes(v):
    """The kernel's bf16 planes of an operand, in f64: one exact plane for
    bf16, the three of ``split3`` for f32."""
    if v.dtype == torch.bfloat16:
        return [v.double()]
    return [p.double() for p in TK.split3(v)]


def _mma(a, b):
    """A B over the kernel's plane products (pa + pb <= the larger plane
    count - 1: the six of order <= 2^-16 for three planes each, every pair
    when a side has one plane), exact products summed in f64 where the
    tensor cores sum in f32, rounded to f32."""
    pa_, pb_ = _planes(a), _planes(b)
    order = max(len(pa_), len(pb_)) - 1
    return sum(x @ y for i, x in enumerate(pa_)
               for j, y in enumerate(pb_) if i + j <= order).float()


def _bwd_blocks(n_c, n_h, l):
    """The main launch's blocks, (chunk, column tile, head group)."""
    groups = -(-n_h // TK.BWD_HEADS)
    return [(ci, jt, grp) for jt in range(-(-l // TK.BWD_TILE))
            for ci in range(n_c) for grp in range(groups)]


def _bwd_emulation(a, b, c, x, dy, order):
    """The backward kernel's algorithm (``csrc/ssd_intra_bwd.cu``) on the
    CPU, its main clusters run in ``order``. A cluster (chunk, 64-column
    tile j, group of BWD_HEADS heads; blocks of BWD_SUB heads) walks the
    row tiles i >= j: S^T = B_j C_i^T, then per head dM^T = x_j dy_i^T, L,
    M = S L, G = dM M, dx_j += M^T dy_i (summed over the row tiles in
    order), G's column sums (over i) and its row sums over the tile's
    columns, and dS^T += dM^T L in four sums (per block, its heads hb, hb +
    2 and hb + 1, hb + 3 as the kernel's two warpgroups), added per block
    and then over the blocks in rank order into the group's partial dS. The
    finish: dS as the partials summed over the groups in order, dC = dS B
    and dB = dS^T C, and da as the reverse prefix sum of G's row sums (over
    the column tiles in order) minus its column sums. Every product is
    ``_mma`` of the kernel's bf16 planes (dy, M and dS split as f32; x, b
    and c one plane when bf16); the rest is f32."""
    n_c, n_h, l = a.shape
    T, hg = TK.BWD_TILE, TK.BWD_HEADS
    tiles, groups = -(-l // T), -(-n_h // hg)
    dy = dy.float()
    part = torch.zeros((n_c, groups, l, l))
    rowp = torch.zeros((n_c, n_h, tiles, l))
    colg = torch.zeros((n_c, n_h, l))
    dx = torch.zeros(x.shape)
    cum = a.float().cumsum(-1)
    for ci, jt, grp in order:
        jj = torch.arange(jt * T, min(l, jt * T + T))
        heads = range(grp * hg, min(n_h, grp * hg + hg))
        for it in range(jt, tiles):
            ii = torch.arange(it * T, min(l, it * T + T))
            st = _mma(b[ci, jj], c[ci, ii].T)
            acc = [torch.zeros((len(jj), len(ii)))
                   for _ in range(2 * TK.BWD_HEADS // TK.BWD_SUB)]
            valid = ii[None, :] >= jj[:, None]
            for q, h in enumerate(heads):
                dmt = _mma(x[ci, jj, h], dy[ci, ii, h].T)
                lt = torch.where(valid, torch.exp(cum[ci, h, ii][None, :]
                                                  - cum[ci, h, jj][:, None]),
                                 torch.zeros(()))
                mt = st * lt
                gt = dmt * mt
                w = 2 * (q // TK.BWD_SUB) + q % 2  # (block, warpgroup)
                acc[w] = acc[w] + dmt * lt
                colg[ci, h, jj] += gt.sum(1)
                rowp[ci, h, jt, ii] = gt.sum(0)
                dx[ci, jj, h] = (dx[ci, jj, h].double()
                                 + _mma(mt, dy[ci, ii, h]).double()).float()
            total = acc[0] + acc[1]
            for r in range(2, len(acc), 2):  # the blocks in rank order
                total = total + (acc[r] + acc[r + 1])
            part[ci, grp, ii[:, None], jj[None, :]] = total.T
    ds = part[:, 0].clone()
    for grp in range(1, groups):
        ds += part[:, grp]
    dc = torch.stack([_mma(ds[ci], b[ci]) for ci in range(n_c)])
    db = torch.stack([_mma(ds[ci].T, c[ci]) for ci in range(n_c)])
    dcum = rowp[:, :, 0].clone()
    for jt in range(1, tiles):
        dcum += rowp[:, :, jt]
    dcum -= colg
    da = torch.zeros(a.shape)
    run = torch.zeros((n_c, n_h))
    for i in range(l - 1, -1, -1):
        run = run + dcum[..., i]
        da[..., i] = run
    return da, db, dc, dx


def test_backward_kernel_emulation_is_right_and_order_free():
    C, H, l, N, P = 2, 3, 70, 16, 24  # two row tiles, the last ragged
    a, b, c, x = (torch.from_numpy(t)
                  for t in _inputs(C, H, l, N, P, seed=9))
    dy = torch.from_numpy(np.random.default_rng(1).standard_normal(
        x.shape).astype(np.float32))
    want = TK.ssd_intra_chunk_bwd_plain(a, b, c, x, dy)
    blocks = _bwd_blocks(C, H, l)
    got = _bwd_emulation(a, b, c, x, dy, blocks)
    rng = np.random.default_rng(2)
    shuffled = [blocks[i] for i in rng.permutation(len(blocks))]
    again = _bwd_emulation(a, b, c, x, dy, shuffled)
    for name, w, g, g2 in zip("da db dc dx".split(), want, got, again):
        assert torch.equal(g, g2), name
        err = float((g - w).abs().max() / w.abs().max())
        assert err <= 1e-5, (name, err)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_backward_kernel_planes_hold_the_bar_at_the_training_length(dtype,
                                                                    tol):
    """The kernel's algorithm at mamba2-780m's training chunk (l 256, N
    128, P 64) and the serving path's decay draw, at narrow H (two head
    groups): da, db, dc and dx within the card's bar of each gradient's
    max |plain| (1e-4 for f32; 2e-2 for bf16 b, c, x, whose gradients are
    rounded to bf16), at the split's plane products."""
    C, H, l, N, P = 2, 20, 256, 128, 64
    rng = np.random.default_rng(7)
    z = rng.standard_normal((C, H, l)).astype(np.float32)
    a = torch.from_numpy(-np.logaddexp(0.0, z).astype(np.float32))
    b, c = (torch.from_numpy((rng.standard_normal((C, l, N)) * 0.3).astype(
        np.float32)).to(getattr(torch, dtype)) for _ in range(2))
    x = torch.from_numpy((rng.standard_normal((C, l, H, P)) * 0.3).astype(
        np.float32)).to(getattr(torch, dtype))
    dy = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    want = TK.ssd_intra_chunk_bwd_plain(a, b, c, x, dy)
    got = _bwd_emulation(a, b, c, x, dy, _bwd_blocks(C, H, l))
    for name, w, g, t in zip("da db dc dx".split(), want, got, (a, b, c, x)):
        err = float((g.to(t.dtype).float() - w.float()).abs().max()
                    / w.float().abs().max())
        assert err <= tol, (name, err)


def test_ssd_intra_autograd_on_the_cpu_is_the_plain_gradient():
    """The wrapper differentiates the plain version on CPU tensors; the
    backward entry point gives the same gradients, each in its operand's
    type."""
    a, b, c, x = (torch.from_numpy(t) for t in _inputs(2, 2, 40, 8, 16, 3))
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(0))
    for dt in (torch.float32, torch.bfloat16):
        ins = [a.clone().requires_grad_()] + [
            t.to(dt).requires_grad_() for t in (b, c, x)]
        y = TK.ssd_intra_chunk(*ins, out_dtype=torch.float32)
        got = torch.autograd.grad(y, ins, dy)
        want = TK.ssd_intra_chunk_bwd(*(t.detach() for t in ins), dy)
        for g, w, t in zip(got, want, ins):
            assert w.dtype == t.dtype and torch.equal(g, w)
    with pytest.raises(ValueError, match="shape"):
        TK.ssd_intra_chunk_bwd(a, b, c, x, dy[:, :-1])


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
    """bf16 is the reference's ``ssd_lowp`` and runs (held against the
    reference in ``test_torch_opt_overrides.py``); any other low precision
    intra type is refused."""
    t = [torch.from_numpy(v) for v in _chunked_inputs(1, 16, 2, 4, 4, 0)[:4]]
    y, h = TSSM.ssd_chunked(*t, 16, intra_dtype=torch.bfloat16)
    assert y.shape == t[0].shape and bool(torch.isfinite(y).all())
    with pytest.raises(ValueError, match="intra_dtype"):
        TSSM.ssd_chunked(*t, 16, intra_dtype=torch.float16)


def test_ssd_intra_wrapper_checks():
    a, b, c, x = (torch.from_numpy(t) for t in _inputs(2, 3, 16, 4, 8, 0))
    with pytest.raises(ValueError):
        TK.ssd_intra_chunk(a, b[:, :8], c, x)  # l disagrees
    with pytest.raises(ValueError):
        TK.ssd_intra_chunk(a, b, c, x[:, :, :2])  # H disagrees
    with pytest.raises(ValueError):
        TK.ssd_intra_chunk(a[0], b, c, x)  # a not (C, H, l)


# (C, H, l): the serving shape of mamba2-780m (4 prompts of 1024 tokens in
# chunks of 256), the ragged case, l < 16, H = 1, odd H, and an l past one
# pass over S's 256 columns
PLAN_CASES = [(16, 48, 256), (3, 5, 100), (2, 3, 9), (4, 1, 64), (1000, 3, 256),
              (2, 4, 600)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("C,H,l", PLAN_CASES)
def test_plan_covers_every_chunk_head_and_row_tile_once(C, H, l, dtype):
    """Every (chunk, head, i-tile) belongs to exactly one block; head
    groups divide H or only the last one is short (masked); blocks run
    heaviest i-tile first; the shared memory fits the card."""
    pl = TK.plan(C, H, l, getattr(torch, dtype), True)
    seen = {}
    last_tile = pl.row_tiles
    for idx in range(pl.blocks):
        chunk, tile, h0, h1 = pl.block(idx)
        assert tile <= last_tile  # heaviest first
        last_tile = tile
        assert 0 <= chunk < C and 0 <= tile < pl.row_tiles
        assert h0 < h1 <= H and h1 - h0 <= pl.heads
        for h in range(h0, h1):
            key = (chunk, h, tile)
            assert key not in seen, (key, idx, seen.get(key))
            seen[key] = idx
    assert len(seen) == C * H * pl.row_tiles == C * H * -(-l // TK.ROWS)
    assert H % pl.heads == 0 or -(-H // pl.heads) == pl.groups
    assert pl.heads % 2 == 0 or pl.heads == H  # two heads a pass
    assert pl.smem_bytes + 1024 <= 233472
    assert pl.blocks_per_sm >= 1
    assert pl.path == f"{'bf16' if dtype == 'bfloat16' else 'f32'} aligned"


def test_plan_at_the_serving_shape():
    """16 chunks x 4 row tiles x (48 / g) head groups; the heaviest block
    (the last row tile: 4 units a head) no heavier than a block slot's
    share of the causal work, two blocks resident an SM."""
    pl = TK.plan(16, 48, 256, torch.bfloat16, True)
    assert pl.row_tiles == 4 and 48 % pl.heads == 0 and pl.heads % 2 == 0
    assert pl.blocks == 16 * 4 * (48 // pl.heads)
    assert pl.blocks_per_sm == 2
    work = 16 * 48 * (1 + 2 + 3 + 4)
    assert pl.heads * 4 <= work / (TK.SMS * pl.blocks_per_sm)
    assert pl.s_cols == 256  # one pass over S's columns
    long = TK.plan(2, 4, TK.MAX_LEN, torch.float32, True)
    assert long.s_cols == TK.MAX_S_COLS  # the last i-tile takes 4 passes
    assert long.smem_bytes + 1024 <= 233472


def test_hi_lo_split_reconstructs_within_2_pow_minus_17():
    """The kernel's hi/lo planes of f32 S * L: exact bf16 values whose sum
    is within 2^-17 of v, relative, over normal f32 of every scale."""
    rng = np.random.default_rng(3)
    v = (rng.standard_normal(200_000)
         * np.exp2(rng.integers(-60, 60, 200_000))).astype(np.float32)
    v = torch.from_numpy(np.concatenate([v, [0.0, 1.0, -1.5, 3.0e-30]
                                         ]).astype(np.float32))
    hi, lo = TK.split_hi_lo(v)
    assert hi.dtype == lo.dtype == torch.bfloat16
    back = hi.double() + lo.double()
    rel = ((back - v.double()).abs() / v.double().abs().clamp_min(1e-300))
    assert float(rel.max()) <= 2.0 ** -17, float(rel.max())
    assert torch.equal(TK.split_hi_lo(hi.float())[1].float(),
                       torch.zeros_like(v))  # a bf16 value has no lo plane


def test_split3_is_exact():
    """The backward kernel's three planes of an f32 operand: bf16 values,
    each the rounded remainder of the ones before, whose sum is v exactly
    over normal f32 of every scale; a bf16 value is its first plane."""
    rng = np.random.default_rng(4)
    v = (rng.standard_normal(200_000)
         * np.exp2(rng.integers(-60, 60, 200_000))).astype(np.float32)
    v = torch.from_numpy(np.concatenate([v, [0.0, 1.0, -1.5, 3.0e-30]
                                         ]).astype(np.float32))
    planes = TK.split3(v)
    assert all(p.dtype == torch.bfloat16 for p in planes)
    assert torch.equal(sum(p.double() for p in planes), v.double())
    assert torch.equal(planes[0], v.to(torch.bfloat16))
    assert torch.equal(planes[1], TK.split_hi_lo(v)[1])
    b = v.to(torch.bfloat16)
    assert all(torch.equal(p.float(), torch.zeros_like(v))
               for p in TK.split3(b.float())[1:])


def ssd_f64(a, b, c, x):
    """The intra-chunk function evaluated in float64."""
    l = a.shape[-1]
    cum = a.double().cumsum(-1)
    causal = torch.ones((l, l), dtype=torch.bool, device=a.device).tril()
    diff = (cum[..., :, None] - cum[..., None, :]).masked_fill(
        ~causal, float("-inf"))
    s = torch.einsum("cin,cjn->cij", c.double(), b.double())
    return torch.einsum("chij,cjhp->cihp", torch.exp(diff) * s[:, None],
                        x.double())


def _kernel_arithmetic(a, b, c, x):
    """The CUDA kernel's arithmetic on the CPU, per 64-row i-tile: f32
    prefix sums of a from the tile's first row (forward over the tile,
    backward below it), S = c b^T in f32, S * exp(e_i - e_j) in f32 where
    i >= j, split into bf16 hi and lo planes, the plane products with bf16
    x summed (exact products; f64 sums stand in for the MMA's f32)."""
    n_c, n_h, l = a.shape
    y = torch.zeros(x.shape, dtype=torch.float64)
    s = torch.einsum("cin,cjn->cij", c.double(), b.double()).float()
    a32 = a.float()
    for i0 in range(0, l, TK.ROWS):
        rows = torch.arange(i0, min(l, i0 + TK.ROWS))
        j_end = int(rows[-1]) + 1
        e = torch.zeros((n_c, n_h, j_end))
        run = torch.zeros((n_c, n_h))
        for k in range(i0 + 1, j_end):
            run = run + a32[..., k]
            e[..., k] = run
        run = torch.zeros((n_c, n_h))
        for k in range(i0 - 1, -1, -1):
            run = run - a32[..., k + 1]
            e[..., k] = run
        causal = rows[:, None] >= torch.arange(j_end)[None, :]
        diff = torch.where(causal, e[..., rows, None] - e[..., None, :],
                           torch.zeros(()))
        v = torch.where(causal, s[:, None, rows, :j_end] * torch.exp(diff),
                        torch.zeros(()))
        hi, lo = TK.split_hi_lo(v)
        y[:, rows] = torch.einsum("chij,cjhp->cihp",
                                  hi.double() + lo.double(),
                                  x[:, :j_end].double())
    return y


@pytest.mark.parametrize("draw", ["kernels", "serve"])
def test_kernel_arithmetic_within_the_f64_bar(draw):
    """The kernel's arithmetic (``_kernel_arithmetic``) on bf16 b, c, x
    within 1e-5 of max |f64| of the function in float64, over two row
    tiles and both decay draws (test_kernels.py's -0.1 |N(0,1)| and the
    serving path's -softplus(N(0,1)))."""
    rng = np.random.default_rng(5)
    C, H, l, N, P = 2, 4, 128, 32, 16
    z = rng.standard_normal((C, H, l)).astype(np.float32)
    a = torch.from_numpy(-np.abs(z) * 0.1 if draw == "kernels"
                         else -np.logaddexp(0.0, z)).float()
    b, c = (torch.from_numpy(rng.standard_normal((C, l, N)).astype(
        np.float32) * 0.3).to(torch.bfloat16) for _ in range(2))
    x = torch.from_numpy(rng.standard_normal((C, l, H, P)).astype(
        np.float32) * 0.3).to(torch.bfloat16)
    ref = ssd_f64(a, b, c, x)
    got = _kernel_arithmetic(a, b, c, x)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


GPU_CASES = [case[:5] for case in SSD_CASES] + [
    (3, 5, 100, 20, 70),     # ragged: l, N, P off the tile grid (masked)
    (16, 48, 256, 128, 64),  # the serving shape
    (2, 3, 9, 16, 64),       # l < 16
    (4, 1, 64, 32, 64),      # H = 1
    (2, 4, 600, 64, 64),     # three passes over S's columns
]


def _gpu_inputs(C, H, l, N, P, seed, draw="kernels"):
    """``_inputs`` on the card; the "serve" draw takes the serving path's
    decay logits, a = dt * A with A = -1: -softplus(N(0,1))."""
    a, b, c, x = (torch.from_numpy(t).cuda()
                  for t in _inputs(C, H, l, N, P, seed))
    if draw == "serve":
        z = np.random.default_rng(seed + 1).standard_normal((C, H, l))
        a = -torch.nn.functional.softplus(
            torch.from_numpy(z.astype(np.float32)).cuda())
    return a, b, c, x


@pytest.mark.cuda
def test_ssd_intra_kernel_matches_plain_on_gpu():
    """The CUDA kernel against its plain version on the card: f32 in and
    out at 1e-4, bf16 in with f32 or bf16 out at 2e-2; every call repeated
    bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for C, H, l, N, P in GPU_CASES:
        a, b, c, x = _gpu_inputs(C, H, l, N, P, l)
        for dt, out, tol in ((torch.float32, torch.float32, 1e-4),
                             (torch.bfloat16, torch.float32, 2e-2),
                             (torch.bfloat16, torch.bfloat16, 2e-2)):
            args = (a, b.to(dt), c.to(dt), x.to(dt))
            n0 = TK.LAUNCHES
            got = TK.ssd_intra_chunk(*args, out_dtype=out)
            again = TK.ssd_intra_chunk(*args, out_dtype=out)
            torch.cuda.synchronize()
            assert TK.LAUNCHES == n0 + 2 and got.dtype == out
            assert torch.equal(got, again), (C, H, l, N, P, dt)
            # the f32 plain version rounded once, as the kernel rounds
            want = TK.ssd_intra_chunk_plain(*args,
                                            out_dtype=torch.float32).to(out)
            torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("draw", ["kernels", "serve"])
def test_ssd_intra_kernel_within_f64_bar_on_gpu(draw):
    """bf16 b, c, x in, f32 out, against the function in float64: max
    |kernel - f64| within 1e-5 of max |f64|, or no farther than the f32
    plain version is where that is farther. Prints both distances."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for C, H, l, N, P in GPU_CASES[len(SSD_CASES):]:
        a, b, c, x = _gpu_inputs(C, H, l, N, P, l + 1, draw)
        args = (a, b.to(torch.bfloat16), c.to(torch.bfloat16),
                x.to(torch.bfloat16))
        got = TK.ssd_intra_chunk(*args, out_dtype=torch.float32)
        plain = TK.ssd_intra_chunk_plain(*args, out_dtype=torch.float32)
        ref = ssd_f64(*args)
        scale = float(ref.abs().max())
        d_kernel = float((got.double() - ref).abs().max())
        d_plain = float((plain.double() - ref).abs().max())
        print(f"{(C, H, l, N, P)} {draw}: max |kernel - f64| / max |f64| "
              f"{d_kernel / scale:.3e}, plain f32 {d_plain / scale:.3e}")
        assert d_kernel <= max(1e-5 * scale, d_plain), (d_kernel, d_plain)


@pytest.mark.cuda
def test_ssd_intra_bwd_kernel_matches_plain_on_gpu():
    """The backward kernel against its plain version on the card: f32 at
    1e-4 of each gradient's max |plain|, bf16 b, c, x at 2e-2; every call
    repeated bit for bit; the autograd path of the wrapper launches it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for C, H, l, N, P in GPU_CASES:
        a, b, c, x = _gpu_inputs(C, H, l, N, P, l + 2, "serve")
        dy = torch.randn(x.shape, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(l))
        for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            args = (a, b.to(dt), c.to(dt), x.to(dt))
            n0 = TK.BWD_LAUNCHES
            got = TK.ssd_intra_chunk_bwd(*args, dy)
            again = TK.ssd_intra_chunk_bwd(*args, dy)
            torch.cuda.synchronize()
            assert TK.BWD_LAUNCHES == n0 + 2
            want = TK.ssd_intra_chunk_bwd_plain(*args, dy)
            for g, g2, w, t in zip(got, again, want, args):
                assert torch.equal(g, g2), (C, H, l, N, P, dt)
                assert g.dtype == t.dtype
                err = float((g.float() - w.float()).abs().max()
                            / w.float().abs().max())
                assert err <= tol, (C, H, l, N, P, dt, err)
    ins = [t.clone().requires_grad_() for t in (a, b, c, x)]
    n0 = TK.BWD_LAUNCHES
    torch.autograd.grad(TK.ssd_intra_chunk(*ins, out_dtype=torch.float32),
                        ins, dy)
    assert TK.BWD_LAUNCHES == n0 + 1
