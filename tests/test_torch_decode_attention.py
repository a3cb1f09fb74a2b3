"""The paged decode-attention kernel's plain version and wrapper
(``repro_torch/kernels/decode_attention.py``) against the reference's
attention (``repro.models.layers.attention_scores`` over the masked,
head-expanded view), and a CPU emulation of the kernel's arithmetic.

Sizes are small (2 rows, views of up to 40 positions, 4 heads over 2 kv
heads, dh 16 or 64). Tolerances: f32 against the reference at 1e-5 (the
sums run in other orders); the kernel's emulation against the plain
version in bf16 within DA_TOL of max |plain| (a score or a probability
may round to the neighbouring bf16 value when its f32 sum, taken in
another order, sits on a rounding edge), in f32 at 1e-5. The property the
speculative accept rule stands on is held bit for bit: a row's output does
not change with T, with the other rows or with the view's length.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as DA

# kernel vs plain in bf16: within this share of max |plain| (chip_smoke.py
# holds the card's kernel to the same bar)
DA_TOL = 2e-2


def _inputs(b=2, t=3, h=4, kv=2, dh=16, sv=40, seed=0, pos=(5, 30)):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, t, h, dh), np.float32))
    k = torch.from_numpy(rng.standard_normal((b, sv, kv, dh), np.float32))
    v = torch.from_numpy(rng.standard_normal((b, sv, kv, dh), np.float32))
    return q, k, v, torch.tensor(pos[:b], dtype=torch.int32)


def _reference(q, k, v, pos, window, n_true):
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.models import layers as RL
    b, t, h, _ = q.shape
    pp = pos.numpy()[:, None] + np.arange(t)[None, :]
    kj = np.arange(k.shape[1])[None, None, None, :]
    pe = pp[:, None, :, None]
    mask = kj <= pe
    if window > 0:
        mask = mask & (kj > pe - window)
    out = RL.attention_scores(
        jnp.asarray(q.numpy()),
        RL._expand_kv(jnp.asarray(k.numpy()), h, n_true),
        RL._expand_kv(jnp.asarray(v.numpy()), h, n_true), jnp.asarray(mask))
    return np.asarray(out)


def _tree_sum(threads, warps=8):
    """The kernel's block sum: a butterfly in each warp, then the warps in
    order."""
    lanes = threads.reshape(warps, 32)
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, lane ^ o]
    total = lanes[0, 0]
    for w in range(1, warps):
        total = total + lanes[w, 0]
    return total


def _emulate_kernel(q, k, v, pos, window=0, n_true=0, chunk=256, warps=8):
    """The CUDA kernel's arithmetic, step by step in f32 on the CPU. Each
    q . k runs over d in turn. A short row (every key in chunk 0) sums its
    exps in one block tree (one key a thread) and its p . v in warp w over
    keys lo+w, lo+w+8, ..., the warps in order. A long row cuts its keys
    into chunks of ``chunk`` by absolute position: a chunk's exp sum is one
    block tree, its p . v runs over its keys in turn, and the chunk sums
    and partials add in chunk order."""
    dt = q.dtype
    rnd = (lambda x: x.to(dt).float()) if dt != torch.float32 else (
        lambda x: x)
    b, t, h, dh = q.shape
    sv, kv = k.shape[1], k.shape[2]
    n_true = n_true or h
    scale = torch.tensor(float(np.sqrt(dh)), dtype=torch.float32).to(dt)
    out = torch.zeros((b, t, h, dh), dtype=torch.float32)
    qf, kf, vf = q.float(), k.float(), v.float()
    for bi in range(b):
        for ti in range(t):
            pe = int(pos[bi]) + ti
            hi = min(pe, sv - 1)
            lo = max(0, pe - window + 1) if window > 0 else 0
            spans = [(max(lo, c * chunk), min(hi, c * chunk + chunk - 1))
                     for c in range(lo // chunk, hi // chunk + 1)]
            for hh in range(n_true):
                kvh = hh // (n_true // kv)
                keys = kf[bi, lo:hi + 1, kvh]  # (n, dh)
                vals = vf[bi, lo:hi + 1, kvh]
                acc = torch.zeros(keys.shape[0])
                for d in range(dh):  # one thread per key, d in turn
                    acc = acc + qf[bi, ti, hh, d] * keys[:, d]
                s = rnd(rnd(acc) / scale.float())
                e = torch.exp(s - s.max())
                if hi < chunk:  # short row
                    threads = torch.zeros(warps * 32)
                    threads[:e.shape[0]] = e
                    p = rnd(e / _tree_sum(threads, warps))
                    part = torch.zeros(warps, dh)
                    for j in range(e.shape[0]):
                        part[j % warps] = part[j % warps] + p[j] * vals[j]
                    o_ = part[0]
                    for w in range(1, warps):
                        o_ = o_ + part[w]
                else:
                    denom = torch.zeros(())
                    for j0, j1 in spans:
                        threads = torch.zeros(chunk)
                        first = j0 % chunk
                        threads[first:first + j1 - j0 + 1] = \
                            e[j0 - lo:j1 - lo + 1]
                        denom = denom + _tree_sum(threads, warps)
                    p = rnd(e / denom)
                    o_ = torch.zeros(dh)
                    for j0, j1 in spans:
                        part = torch.zeros(dh)
                        for j in range(j0, j1 + 1):
                            part = part + p[j - lo] * vals[j - lo]
                        o_ = o_ + part
                out[bi, ti, hh] = o_
    return out.to(dt)


@pytest.mark.parametrize("window,n_true,dh", [(0, 0, 16), (7, 0, 16),
                                              (0, 2, 16), (0, 0, 64)])
def test_plain_matches_reference_attention(window, n_true, dh):
    """The plain version against the reference's masked attention in f32:
    causal, sliding window, zero-padded heads (n_true < H) and a wider
    head."""
    q, k, v, pos = _inputs(dh=dh)
    got = DA.decode_attention_plain(q, k, v, pos, window, n_true)
    want = _reference(q, k, v, pos, window, n_true or q.shape[2])
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if n_true:
        assert not got[:, :, n_true:].any()  # padded heads write zeros


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 7])
def test_plain_row_is_independent_of_t_and_view(dtype, window):
    """A T-token pass gives position t exactly what a one-token pass at
    pos + t gives over a view cut just past it: the property the verify
    pass stands on, bit for bit."""
    q, k, v, pos = _inputs(t=4)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    full = DA.decode_attention_plain(q, k, v, pos, window)
    for ti in range(q.shape[1]):
        for bi in range(q.shape[0]):
            cut = int(pos[bi]) + ti + 1
            one = DA.decode_attention_plain(
                q[bi:bi + 1, ti:ti + 1], k[bi:bi + 1, :cut],
                v[bi:bi + 1, :cut], pos[bi:bi + 1] + ti, window)
            assert torch.equal(one[0, 0], full[bi, ti]), (bi, ti)


@pytest.mark.parametrize("n", [1, 7, 33, 100])
def test_row_sum_is_independent_of_row_count_and_trailing_zeros(n):
    """``row_sum`` (the plain version's sums and the paged pass's norm):
    each row's sum is the same alone, in any batch and with zeros appended
    to the dim, and close to the f64 sum; ``rmsnorm_rows`` over it is row
    by row the same in any batch."""
    from repro_torch.models import layers as L
    x = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (200, n), np.float32))
    full = DA.row_sum(x)
    for rows in (1, 3, 64, 200):
        assert torch.equal(DA.row_sum(x[:rows]), full[:rows]), rows
        assert torch.equal(DA.row_sum(x.t()[:, :rows].t()), full[:rows])
    assert torch.equal(DA.row_sum(torch.cat([x, x.new_zeros(200, 40)], 1)),
                       full)
    np.testing.assert_allclose(full.double().numpy(),
                               x.double().sum(1).numpy(), rtol=1e-5,
                               atol=1e-5)
    g = torch.linspace(-0.5, 0.5, n)
    norm = L.rmsnorm_rows(x, g)
    for rows in (1, 3, 64):
        assert torch.equal(L.rmsnorm_rows(x[:rows], g), norm[:rows]), rows


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, DA_TOL)])
def test_kernel_arithmetic_matches_plain(dtype, tol):
    """The kernel's order of sums, emulated on the CPU, against the plain
    version: within 1e-5 in f32 and DA_TOL of max |plain| in bf16, with
    padded heads and a window."""
    q, k, v, pos = _inputs(t=2, dh=16, sv=600, pos=(3, 590))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    for window, n_true in ((0, 0), (300, 2)):
        want = DA.decode_attention_plain(q, k, v, pos, window, n_true).float()
        got = _emulate_kernel(q, k, v, pos, window, n_true).float()
        err = float((got - want).abs().max())
        assert err <= tol * max(1.0, float(want.abs().max())), (window, err)


def test_wrapper_takes_the_plain_version_on_cpu():
    """On CPU tensors the wrapper is the plain version, bit for bit, and
    launches nothing; bad shapes are refused."""
    q, k, v, pos = _inputs()
    n0 = DA.LAUNCHES
    assert torch.equal(DA.decode_attention(q, k, v, pos, 7),
                       DA.decode_attention_plain(q, k, v, pos, 7))
    assert DA.LAUNCHES == n0
    with pytest.raises(ValueError):
        DA.decode_attention(q, k[:, :, :1].expand(-1, -1, 3, -1), v, pos)
    with pytest.raises(ValueError):
        DA.decode_attention(q, k, v, pos[:1])
    with pytest.raises(ValueError):
        DA.decode_attention(q, k, v, pos, n_true=3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_gpu(dtype):
    """The CUDA kernel against its plain version on the card (bf16 within
    DA_TOL of max |plain|, f32 at 1e-5), and a T-token launch against
    one-token launches over shorter views, bit for bit; the first row's
    tokens cross from the kernel's one-block form (keys in chunk 0) into
    its chunked form."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    q, k, v, pos = (a.cuda() for a in _inputs(t=5, h=8, kv=2, dh=128,
                                              sv=400, pos=(253, 390)))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    tol = DA_TOL if dtype == torch.bfloat16 else 1e-5
    n0 = DA.LAUNCHES
    for window, n_true in ((0, 0), (64, 4)):
        got = DA.decode_attention(q, k, v, pos, window, n_true).float()
        want = DA.decode_attention_plain(q, k, v, pos, window, n_true).float()
        assert float((got - want).abs().max()) <= tol * max(
            1.0, float(want.abs().max()))
    full = DA.decode_attention(q, k, v, pos)
    for ti in range(q.shape[1]):
        cut = int(pos.max()) + ti + 1
        one = DA.decode_attention(q[:, ti:ti + 1], k[:, :cut], v[:, :cut],
                                  pos + ti)
        assert torch.equal(one[:, 0], full[:, ti]), ti
    assert DA.LAUNCHES == n0 + 3 + q.shape[1]
