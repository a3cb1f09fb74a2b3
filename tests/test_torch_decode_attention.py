"""The paged decode-attention kernel's plain version and wrapper
(``repro_torch/kernels/decode_attention.py``) against the reference's
attention (``repro.models.layers.attention_scores`` over the masked,
head-expanded view), a CPU emulation of the kernel's arithmetic and
bookkeeping, its launch plan, the ``k_new``/``v_new`` path and the paged
pass that uses it.

Sizes are small (2 rows, views of up to 600 positions, 4 heads over 2 kv
heads, dh 16 or 64). Tolerances: f32 against the reference at 1e-5 (the
sums run in other orders); the kernel's emulation against the plain
version in bf16 within DA_TOL of max |plain| (a score or a probability
may round to the neighbouring bf16 value when its f32 sum, taken in
another order, sits on a rounding edge), in f32 at 1e-5. The property the
speculative accept rule stands on is held bit for bit: a row's output does
not change with T, with the other rows, with the view's length or with
the launch plan.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as DA

# kernel vs plain in bf16: within this share of max |plain| (chip_smoke.py
# holds the card's kernel to the same bar)
DA_TOL = 2e-2


def _chunk_keys(kv_elt):
    return 128 if kv_elt == 2 else 64


def _smem_bytes(q_elt, kv_elt, m_tiles, dh, sv, cluster, cache, slots):
    """A CTA's dynamic shared memory as the kernel lays it out
    (``make_layout`` in ``csrc/decode_attention.cu``): q (three bf16 planes
    for f32 q over bf16 K/V), the K/V ring of two tiles, cache + 1 score
    tiles, p's planes, the partials, the chunk sums, the running sums and
    the row stats."""
    al = lambda n: -(-n // 16) * 16
    dp = -(-dh // 16) * 16
    rows = 16 * m_tiles
    chunk = _chunk_keys(kv_elt)
    split = q_elt == 4 and kv_elt == 2
    nk_cap = -(-(-(-sv // chunk)) // cluster)
    threads = chunk // 8 * 32  # a warp to each 8-key group of a chunk
    per = cluster * threads * 4
    acc_n = -(-(rows * dp) // per) * threads * 4
    return (al(rows * (dp + 8) * (6 if split else q_elt))
            + al(2 * chunk * (dp + 8) * kv_elt)
            + al((cache + 1) * rows * (chunk + 8) * q_elt)
            + al(3 * rows * (chunk + 8) * 2 if split else 0)
            + al(slots * rows * (dp + 4) * 4) + al(nk_cap * rows * 4)
            + al(acc_n * 4)
            + al((5 * rows + 2 * chunk // 8 * max(rows, 32)) * 4))


# the kernel's layout as the CPU sees it, where the library is not built;
# test_kernel_matches_plain_on_gpu holds it equal to the library's
_LAYOUT = types.SimpleNamespace(decode_attention_smem=_smem_bytes,
                                decode_attention_chunk_keys=_chunk_keys)


@pytest.fixture(autouse=True)
def _layout_on_cpu(request, monkeypatch):
    """``plan`` and ``chunk_keys`` ask the built kernel for its layout;
    the tests that run on the CPU give them this file's copy."""
    if request.node.get_closest_marker("cuda") is None:
        monkeypatch.setattr(DA, "_lib", lambda: _LAYOUT)


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


def _k16_dot(a, b):
    """(rows, n) x (cols, n) -> (rows, cols) as the kernel's bf16 MMA
    takes it: n in steps of 16 in turn, each step's 16 exact products
    summed, then added to the running f32 sum."""
    acc = torch.zeros(a.shape[0], b.shape[0])
    for k0 in range(0, a.shape[1], 16):
        acc = acc + (a[:, None, k0:k0 + 16] * b[None, :, k0:k0 + 16]
                     ).contiguous().sum(-1)
    return acc


def _split(x):
    """The kernel's three bf16 planes of f32 x: hi + mid + lo == x."""
    hi = x.to(torch.bfloat16).float()
    mid = (x - hi).to(torch.bfloat16).float()
    return hi, mid, (x - hi - mid).to(torch.bfloat16).float()


def _split_dot(a, b):
    """(rows, n) f32 x (cols, n) bf16 -> (rows, cols) as the kernel takes
    f32 q (or p) over bf16 K/V: n in steps of 16 in turn, each step a's
    three planes in turn, each plane's 16 exact products summed, then
    added to the running f32 sum."""
    planes = _split(a)
    acc = torch.zeros(a.shape[0], b.shape[0])
    for k0 in range(0, a.shape[1], 16):
        for pl in planes:
            acc = acc + (pl[:, None, k0:k0 + 16] * b[None, :, k0:k0 + 16]
                         ).contiguous().sum(-1)
    return acc


def _seq_dot(a, b):
    """(rows, n) x (cols, n) -> (rows, cols) as the kernel's f32 path takes
    it: one chain over n in turn."""
    acc = torch.zeros(a.shape[0], b.shape[0])
    for k in range(a.shape[1]):
        acc = acc + a[:, None, k] * b[None, :, k]
    return acc


def _chunk_sum(e):
    """A chunk's exp sum (rows, chunk) -> (rows,) in the kernel's order: in
    each group of 8 keys lane t adds keys 2t and 2t+1 and the four lanes
    add as a butterfly, (x0 + x1) + (x2 + x3); then the groups in turn."""
    x = e[:, 0::2] + e[:, 1::2]  # lane t of group n at 4n + t
    x = x.reshape(e.shape[0], -1, 4)
    z = (x[..., 0] + x[..., 1]) + (x[..., 2] + x[..., 3])  # (rows, groups)
    total = z[:, 0]
    for n in range(1, z.shape[1]):
        total = total + z[:, n]
    return total


def _fold(values):
    """Left fold from 0 in the given (ascending chunk) order."""
    total = torch.zeros_like(values[0])
    for x in values:
        total = total + x
    return total


def _emulate_kernel(q, k, v, pos, window=0, n_true=0, k_new=None,
                    v_new=None, plan=None, sms=132):
    """The CUDA kernel's arithmetic and bookkeeping, step by step in f32 on
    the CPU, under ``plan`` (default: the wrapper's plan for ``sms`` SMs).
    Query tiles of ``plan.tokens`` tokens x G heads; their chunks of
    ``chunk_keys`` absolute key positions (128 over bf16 K/V, 64 over f32)
    dealt to the cluster's ranks in turn (chunk g
    to rank g % cluster as its local chunk g // cluster). Each chunk's
    scores (q . k in k16 steps over bf16 K/V, f32 q as three planes; one
    chain over d over f32 K/V), max, exp sum (:func:`_chunk_sum`) and
    p . v partial (keys in k16 steps, or in turn) depend on the chunk
    alone; a row's max is the
    max of its chunks', its sum and its output fold its own chunks in
    ascending order, the output in rounds of ``plan.slots`` local chunks
    a rank with the running sum carried over."""
    n_true, dt, kv_dt = DA._check(q, k, v, pos, n_true, k_new, v_new)
    rnd = (lambda x: x.to(dt).float()) if dt != torch.float32 else (
        lambda x: x)
    dot = (_k16_dot if dt == torch.bfloat16 else
           _split_dot if kv_dt == torch.bfloat16 else _seq_dot)
    b, t, h, dh = q.shape
    sv, kv = k.shape[1], k.shape[2]
    grp = n_true // kv
    C = DA.chunk_keys(DA._elt(kv_dt))
    if k_new is not None:  # the kernel reads these keys from k_new, v_new
        rows = torch.arange(b)[:, None]
        pp = pos.long()[:, None] + torch.arange(t)[None, :]
        k = k.to(kv_dt).index_put((rows, pp), k_new.to(kv_dt))
        v = v.to(kv_dt).index_put((rows, pp), v_new.to(kv_dt))
    plan = plan or DA.plan(b, t, n_true, kv, sv, dh, DA._elt(dt),
                           DA._elt(kv_dt), sms)
    cs = plan.cluster
    scale = float(torch.tensor(float(np.sqrt(dh))).to(dt))
    qf, kf, vf = q.to(dt).float(), k.float(), v.float()
    out = torch.zeros((b, t, h, dh))
    for bi in range(b):
        for kvh in range(kv):
            for t0 in range(0, t, plan.tokens):
                toks = range(t0, min(t, t0 + plan.tokens))
                rows = [(ti, kvh * grp + gi) for ti in toks
                        for gi in range(grp)]
                pe = torch.tensor([int(pos[bi]) + ti for ti, _ in rows])
                hi = torch.clamp(pe, max=sv - 1)
                lo = (torch.clamp(pe - window + 1, min=0) if window > 0
                      else torch.zeros_like(pe))
                cf = int(lo.min()) // C
                nch = int(hi.max()) // C - cf + 1
                qt = torch.stack([qf[bi, ti, hh] for ti, hh in rows])
                keys = torch.zeros((cf + nch) * C, dh)
                vals = torch.zeros((cf + nch) * C, dh)
                n = min(sv, (cf + nch) * C)
                keys[:n], vals[:n] = kf[bi, :n, kvh], vf[bi, :n, kvh]
                # per chunk g (relative to cf): scores and masks
                s, live = {}, {}
                for g in range(nch):
                    j = torch.arange((cf + g) * C, (cf + g + 1) * C)
                    s[g] = rnd(rnd(dot(qt, keys[j])) / scale)
                    live[g] = (j[None, :] >= lo[:, None]) & (
                        j[None, :] <= hi[:, None])
                m = torch.stack([torch.where(live[g], s[g], -np.inf).amax(1)
                                 for g in range(nch)]).amax(0)
                e = {g: torch.where(live[g], torch.exp(s[g] - m[:, None]),
                                    0.0) for g in range(nch)}
                # chunk sums kept by (rank, local chunk), read back in order
                held = {(g % cs, g // cs): _chunk_sum(e[g])
                        for g in range(nch)}
                c0 = lo // C - cf
                c1 = hi // C - cf
                total = torch.stack([_fold([
                    held[(g % cs, g // cs)][r] for g in
                    range(int(c0[r]), int(c1[r]) + 1)])
                    for r in range(len(rows))])
                p = {g: torch.where(live[g], rnd(e[g] / total[:, None]), 0.0)
                     for g in range(nch)}
                # p . v partials in rounds, added in chunk order
                acc = torch.zeros(len(rows), dh)
                per_round = plan.slots * cs
                for g_lo in range(0, nch, per_round):
                    part = {}
                    for g in range(g_lo, min(nch, g_lo + per_round)):
                        j = torch.arange((cf + g) * C, (cf + g + 1) * C)
                        part[(g % cs, g // cs - g_lo // cs)] = dot(
                            p[g], vals[j].t().contiguous())
                    for r in range(len(rows)):
                        for g in range(max(g_lo, int(c0[r])),
                                       min(g_lo + per_round, int(c1[r]) + 1)):
                            acc[r] = acc[r] + part[
                                (g % cs, g // cs - g_lo // cs)][r]
                for r, (ti, hh) in enumerate(rows):
                    out[bi, ti, hh] = acc[r]
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


@pytest.mark.parametrize("dtype,kv_dtype,tol", [
    (torch.float32, torch.float32, 1e-5),
    (torch.bfloat16, torch.bfloat16, DA_TOL),
    (torch.float32, torch.bfloat16, 1e-5)],
    ids=["dtype0-1e-05", "dtype1-0.02", "f32q-bf16kv-1e-05"])
def test_kernel_arithmetic_matches_plain(dtype, kv_dtype, tol):
    """The kernel's order of sums, emulated on the CPU, against the plain
    version: within 1e-5 in f32 (also f32 q over bf16 K/V, the compressed
    serving path's form) and DA_TOL of max |plain| in bf16, with padded
    heads and a window."""
    q, k, v, pos = _inputs(t=2, dh=16, sv=600, pos=(3, 590))
    q, k, v = q.to(dtype), k.to(kv_dtype), v.to(kv_dtype)
    for window, n_true in ((0, 0), (300, 2)):
        want = DA.decode_attention_plain(q, k, v, pos, window, n_true).float()
        got = _emulate_kernel(q, k, v, pos, window, n_true).float()
        err = float((got - want).abs().max())
        assert err <= tol * max(1.0, float(want.abs().max())), (window, err)


# the plans the emulation is held to: (tokens, cluster, cache, slots)
PLANS = [(1, 1, 0, 1), (1, 2, 1, 1), (2, 3, 0, 2), (3, 8, 64, 64),
         (1, 4, 2, 1)]


def _plan(tokens, cluster, cache, slots, h=4, kv=2):
    return DA.Plan(tokens, -(-(h // kv * tokens) // 16), cluster, cache,
                   slots)


@pytest.mark.parametrize("dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("plan", PLANS)
def test_emulation_is_the_same_under_every_plan(dtype, kv_dtype, plan):
    """The kernel's bookkeeping, emulated: rows bit for bit the same
    whatever query tile, cluster size, score cache and partial slots the
    launch takes (rounds and recomputed scores included)."""
    q, k, v, pos = _inputs(t=3, dh=16, sv=300, pos=(3, 290))
    q, k, v = q.to(dtype), k.to(kv_dtype), v.to(kv_dtype)
    want = _emulate_kernel(q, k, v, pos, 70)
    assert torch.equal(_emulate_kernel(q, k, v, pos, 70,
                                       plan=_plan(*plan)), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulation_row_is_independent_of_t_b_and_view(dtype):
    """The kernel's order, emulated: a T-token pass gives position t what
    a one-token pass over a view cut just past it gives, and one batch row
    alone what it gives beside another, bit for bit."""
    q, k, v, pos = _inputs(t=4, dh=16, sv=300, pos=(60, 250))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    full = _emulate_kernel(q, k, v, pos)
    for bi in range(2):
        alone = _emulate_kernel(q[bi:bi + 1], k[bi:bi + 1], v[bi:bi + 1],
                                pos[bi:bi + 1])
        assert torch.equal(alone[0], full[bi]), bi
        for ti in range(4):
            cut = int(pos[bi]) + ti + 1
            one = _emulate_kernel(q[bi:bi + 1, ti:ti + 1], k[bi:bi + 1, :cut],
                                  v[bi:bi + 1, :cut], pos[bi:bi + 1] + ti)
            assert torch.equal(one[0, 0], full[bi, ti]), (bi, ti)


def test_plan_reads_shapes_and_sm_count_only():
    """``plan`` is a function of the shapes and the SM count (its
    arguments; the lru cache holds one plan per argument tuple, never the
    data), fits the card's shared memory, keeps the clusters within three
    quarters of the SMs, and at yi-6b's heads (32 over 4, dh 128, bf16)
    takes all 8 heads of a kv head and the whole verify pass in one
    tile."""
    import inspect
    assert list(inspect.signature(DA.plan).parameters) == [
        "b", "t", "h_true", "kv", "sv", "dh", "q_elt", "kv_elt", "sms"]
    for b, t, h, kv, sv, dh, qe, ke in [(4, 1, 32, 4, 160, 128, 2, 2),
                                         (4, 5, 32, 4, 4096, 128, 2, 2),
                                         (4, 5, 32, 4, 4096, 128, 4, 2),
                                         (1, 64, 32, 4, 1024, 128, 4, 2),
                                         (1, 128, 32, 4, 4096, 128, 4, 4),
                                         (2, 3, 4, 2, 40, 16, 4, 4),
                                         (3, 7, 48, 3, 777, 256, 4, 2),
                                         (1, 1, 16, 1, 100000, 256, 2, 2)]:
        pl = DA.plan(b, t, h, kv, sv, dh, qe, ke, 132)
        assert pl == DA.plan(b, t, h, kv, sv, dh, qe, ke, 132)
        assert _smem_bytes(qe, ke, pl.m_tiles, dh, sv, pl.cluster,
                           pl.cache, pl.slots) <= DA.SMEM_MAX
        assert 16 * pl.m_tiles >= h // kv * pl.tokens
        assert 1 <= pl.cluster <= DA.MAX_CLUSTER and pl.slots >= 1
    decode = DA.plan(4, 1, 32, 4, 1024, 128, 2, 2, 132)
    assert (decode.tokens, decode.m_tiles, decode.cluster) == (1, 1, 6)
    assert DA.chunk_keys(2) == 128 and DA.chunk_keys(4) == 64
    assert 4 * 4 * decode.cluster <= 132 - 132 // 4
    verify = DA.plan(4, 5, 32, 4, 4096, 128, 2, 2, 132)
    assert (verify.tokens, verify.m_tiles) == (5, 3)
    assert DA.plan(4, 1, 32, 4, 4096, 128, 2, 2, 66).cluster < DA.plan(
        4, 1, 32, 4, 4096, 128, 2, 2, 132).cluster


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 7])
def test_plain_k_new_equals_the_spliced_view(dtype, window):
    """``k_new``/``v_new`` give what the view with them spliced in at each
    row's query positions gives, bit for bit (the plain version and the
    wrapper on CPU tensors); the caller's view is left as it was."""
    q, k, v, pos = _inputs(t=3)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    rng = np.random.default_rng(9)
    kn, vn = (torch.from_numpy(rng.standard_normal((2, 3, 2, 16), np.float32)
                               ).to(dtype) for _ in range(2))
    rows = torch.arange(2)[:, None]
    pp = pos.long()[:, None] + torch.arange(3)[None, :]
    k0, v0 = k.clone(), v.clone()
    want = DA.decode_attention_plain(q, k.index_put((rows, pp), kn),
                                     v.index_put((rows, pp), vn), pos,
                                     window)
    for fn in (DA.decode_attention_plain, DA.decode_attention):
        assert torch.equal(fn(q, k, v, pos, window, 0, kn, vn), want)
    assert torch.equal(k, k0) and torch.equal(v, v0)
    with pytest.raises(ValueError):
        DA.decode_attention(q, k, v, pos, 0, 0, kn)


def _spliced_multi(p, xt, kview, vview, pos, cfg, window=0, use_rope=True):
    """``layers.decode_attention_multi`` as it was composed before it passed
    ``k_new``/``v_new``: the step's K/V written into copies of the views."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    b, t, _ = xt.shape
    q, k, v = L.qkv_project(p, xt, cfg, cfg.cim)
    pp = pos[:, None] + torch.arange(t)[None, :]
    if use_rope:
        q, k = L.rope(q, pp, cfg.rope_theta), L.rope(k, pp, cfg.rope_theta)
    rows = torch.arange(b)[:, None]
    kview = kview.index_put((rows, pp), k.to(kview.dtype))
    vview = vview.index_put((rows, pp), v.to(vview.dtype))
    o = ops.decode_attention(q, kview.to(xt.dtype), vview.to(xt.dtype), pos,
                             window, cfg.n_heads)
    y = L.cim_matmul(o.reshape(b, t, -1), p["wo"], cfg.cim)
    return y, k, v


@pytest.fixture(scope="module")
def smoke_model():
    from repro_torch.models import registry as TR
    from repro_torch.serve import deployed as TDP
    from repro_torch.serve import stacked as TST
    cfg = TR.get_smoke_config("yi-6b", dtype="float32")
    params = TR.model_fns(cfg).init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    sp = TDP.compress(cfg, params, target_sparsity=0.6, tile=(16, 16),
                      uniform=True)
    return cfg, params, TST.stack(sp)


@pytest.mark.parametrize("view_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 5])
def test_decode_attention_multi_equals_the_spliced_composition(
        smoke_model, view_dtype, window):
    """The paged pass's attention with ``k_new``/``v_new`` gives the
    output and the K/V rows of the former composition (views copied with
    the step's K/V spliced in) bit for bit, and leaves the views as they
    were."""
    from repro_torch.models import layers as L
    cfg, params, _ = smoke_model
    p = {name: w[0] for name, w in params["layers"].items()}
    rng = np.random.default_rng(2)
    xt = torch.from_numpy(rng.standard_normal((3, 4, cfg.d_model),
                                              np.float32))
    kview, vview = (torch.from_numpy(rng.standard_normal(
        (3, 24, cfg.n_kv_heads, cfg.dh), np.float32)).to(view_dtype)
        for _ in range(2))
    pos = torch.tensor([0, 7, 20])
    k0, v0 = kview.clone(), vview.clone()
    got = L.decode_attention_multi(p, xt, kview, vview, pos, cfg, window)
    want = _spliced_multi(p, xt, kview, vview, pos, cfg, window)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(kview, k0) and torch.equal(vview, v0)


def test_paged_pass_equals_the_spliced_composition(smoke_model,
                                                   monkeypatch):
    """A verify pass and a decode step over paged views give the logits
    and K/V rows of the former composition bit for bit."""
    from repro_torch.models import layers as L
    from repro_torch.serve import stacked as TST
    cfg, _, sx = smoke_model
    rng = np.random.default_rng(5)
    shape = (cfg.n_layers, 3, 32, cfg.n_kv_heads, cfg.dh)
    vk, vv = (torch.from_numpy(rng.standard_normal(shape, np.float32))
              for _ in range(2))
    pos = torch.tensor([4, 11, 17])
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 5)))
    got = (TST.verify_step(sx, vk, vv, pos, toks, cfg),
           TST.decode_step_paged(sx, vk, vv, pos, toks[:, :1], cfg))
    monkeypatch.setattr(L, "decode_attention_multi", _spliced_multi)
    want = (TST.verify_step(sx, vk, vv, pos, toks, cfg),
            TST.decode_step_paged(sx, vk, vv, pos, toks[:, :1], cfg))
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert torch.equal(a, b)


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
@pytest.mark.parametrize("dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)], ids=["dtype0", "dtype1", "f32q-bf16kv"])
def test_kernel_matches_plain_on_gpu(dtype, kv_dtype):
    """The CUDA kernel against its plain version on the card (bf16 within
    DA_TOL of max |plain|, f32 at 1e-5), and a T-token launch against
    one-token launches over shorter views, bit for bit: a verify-sized
    pass whose first row crosses chunk edges, then a prefix-suffix pass
    (one slot, T = 64 over 1024 positions at yi-6b's heads), in f32, bf16
    and f32 q over bf16 K/V; each through
    ``k_new``/``v_new`` too, bit for bit equal to the spliced view; every
    launch counted once; this file's copy of the kernel's layout (shared
    memory, chunk keys) equal to the library's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    tol = DA_TOL if dtype == torch.bfloat16 else 1e-5
    elts = (DA._elt(dtype), DA._elt(kv_dtype))
    for args in ((1, 128, 400, 7, 1, 1), (4, 128, 4096, 6, 6, 6),
                 (3, 64, 1024, 3, 2, 2), (2, 256, 300, 2, 0, 1)):
        assert DA._lib().decode_attention_smem(*elts, *args) == \
            _smem_bytes(*elts, *args), args  # the CPU tests' layout
    assert DA.chunk_keys(elts[1]) == _chunk_keys(elts[1])
    n0, n = DA.LAUNCHES, 0
    for t, h, kv, sv, pos in ((5, 8, 2, 400, (253, 390)),
                              (64, 32, 4, 1024, (960,))):
        b = len(pos)
        q, k, v, pos = (a.cuda() for a in _inputs(b=b, t=t, h=h, kv=kv,
                                                  dh=128, sv=sv, pos=pos))
        q, k, v = q.to(dtype), k.to(kv_dtype), v.to(kv_dtype)
        for window, n_true in ((0, 0), (64, h // 2)):
            got = DA.decode_attention(q, k, v, pos, window, n_true).float()
            want = DA.decode_attention_plain(q, k, v, pos, window,
                                             n_true).float()
            n += 1
            assert float((got - want).abs().max()) <= tol * max(
                1.0, float(want.abs().max()))
        full = DA.decode_attention(q, k, v, pos)
        n += 1
        for ti in range(t):
            cut = int(pos.max()) + ti + 1
            one = DA.decode_attention(q[:, ti:ti + 1], k[:, :cut],
                                      v[:, :cut], pos + ti)
            n += 1
            assert torch.equal(one[:, 0], full[:, ti]), ti
        rows = torch.arange(b, device="cuda")[:, None]
        pp = pos.long()[:, None] + torch.arange(t, device="cuda")[None, :]
        kn, vn = (torch.randn((b, t, kv, 128), device="cuda").to(kv_dtype)
                  for _ in range(2))
        assert torch.equal(
            DA.decode_attention(q, k, v, pos, 0, 0, kn, vn),
            DA.decode_attention(q, k.index_put((rows, pp), kn),
                                v.index_put((rows, pp), vn), pos))
        n += 2
    assert DA.LAUNCHES == n0 + n


@pytest.mark.cuda
def test_ring_mapping_on_the_kernel_matches_plain_on_gpu():
    """The hybrid family's ring decode (``layers.decode_attention(...,
    ring=True)``:
    the step's K/V written at slot pos % Smax first, then one launch with
    the query at min(pos, Smax - 1), no window, no k_new) on the card
    against the same function over the plain version, before, at and past
    the wrap of the zamba2 smoke config's 64-slot ring: f32 within 1e-5
    and bf16 within DA_TOL of max |plain|, the written cache bit for bit,
    one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.models import layers as TL
    from repro_torch.models import registry as TR
    from repro_torch.models import transformer as TT
    cfg = TR.get_smoke_config("zamba2-1.2b", dtype="float32")
    shared = TT.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")["shared_attn"]
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, DA_TOL)):
        p = {k: (v if k.startswith("ln") else v.to(dtype)).cuda()
             for k, v in shared.items()}
        gen = torch.Generator().manual_seed(1)
        for pos in (10, 63, 64, 150):
            x1 = torch.randn((2, 1, cfg.d_model), generator=gen).to(dtype)
            kc, vc = (torch.randn((2, cfg.window, cfg.n_kv_heads, cfg.dh),
                                  generator=gen).to(dtype) for _ in range(2))
            x1, kc, vc = x1.cuda(), kc.cuda(), vc.cuda()
            caches = [(kc.clone(), vc.clone()) for _ in range(2)]
            n0 = DA.LAUNCHES
            got = TL.decode_attention(p, x1, *caches[0], pos, cfg,
                                      ring=True)[0]
            assert DA.LAUNCHES == n0 + 1
            saved = DA.decode_attention
            DA.decode_attention = DA.decode_attention_plain
            try:
                want = TL.decode_attention(p, x1, *caches[1], pos, cfg,
                                           ring=True)[0]
            finally:
                DA.decode_attention = saved
            assert torch.equal(caches[0][0], caches[1][0])
            assert torch.equal(caches[0][1], caches[1][1])
            scale = max(1.0, float(want.float().abs().max()))
            assert float((got.float() - want.float()).abs().max()) <= \
                tol * scale, (dtype, pos)
