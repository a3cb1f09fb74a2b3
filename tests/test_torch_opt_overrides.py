"""The reference's dry-run overrides in the port: ``attn_chunk`` (chunked
prefill attention), ``ssd_lowp`` (the SSD intra-chunk block in bf16) and
the two sharding hints (``seq_shard_residual``, ``moe_hints``).

Tolerances. ``chunked_attention`` is plain f32 on both sides, only the
order of the sums differs: 2e-5. ``ssd_lowp`` rounds L, C B^T and the
block's products to bf16 on both sides, but in other orders (XLA contracts
the four-operand einsum pairwise in an order of its own): the block and
``ssd_chunked`` within 2e-2 of the largest magnitude, the bf16 tolerance
of ``tests/test_kernels.py``. The mamba2 smoke train loss within 1e-2 and
each gradient leaf within 5e-2 of its largest magnitude (a bf16 rounding
of the block feeds every upstream gradient); the Engine's greedy tokens
by the margin rule at 5e-2 (they must equal the reference's wherever its
own top-2 margin is wider). On plain tensors the hints do nothing: bit
for bit.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as RL  # noqa: E402
from repro.models import registry as RR  # noqa: E402
from repro.models import ssm as RSSM  # noqa: E402
from repro.serve.engine import Engine as REngine  # noqa: E402
from repro.train import trainer as RTR  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ssd_intra as SI  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import ssm as TSSM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import Engine  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train import trainer as TTR  # noqa: E402


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# --------------------------------------------------------------------------
# attn_chunk
# --------------------------------------------------------------------------

CASES = [(w, kv, c) for w in (0, 48) for kv in (2, 4) for c in (32, 48, 128)]


@pytest.mark.parametrize("window,kv,chunk", CASES)
def test_chunked_attention_matches_reference(window, kv, chunk):
    rng = np.random.default_rng(window + kv * 10 + chunk)
    q = _rand(rng, (2, 100, 8, 16))
    k, v = _rand(rng, (2, 100, kv, 16)), _rand(rng, (2, 100, kv, 16))
    want = RL.chunked_attention(*map(jnp.asarray, (q, k, v)), 8, chunk,
                                window=window)
    got = TL.chunked_attention(*map(torch.from_numpy, (q, k, v)), 8, chunk,
                               window=window)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("window", [0, 48])
def test_chunked_attention_offset_and_head_padding(window):
    """Queries past the keys' start (``offset``), 6 true heads over 2 KV
    heads padded to 8, bf16 in and out."""
    rng = np.random.default_rng(7)
    q = _rand(rng, (2, 40, 8, 16))
    k, v = _rand(rng, (2, 100, 2, 16)), _rand(rng, (2, 100, 2, 16))
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        want = RL.chunked_attention(
            *(jnp.asarray(a).astype(jdt) for a in (q, k, v)), 8, 32,
            window=window, offset=60, n_true=6)
        got = TL.chunked_attention(
            *(torch.from_numpy(a).to(dt) for a in (q, k, v)), 8, 32,
            window=window, offset=60, n_true=6)
        assert got.dtype == dt
        tol = 2e-5 if dt == torch.float32 else 2e-2
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=tol,
                                   atol=tol)
        assert not got[:, :, 6:].float().abs().any()  # padded heads: zero


def _took_chunked(monkeypatch, s, chunk):
    """(the reference's choice, the port's) for a prefill of ``s``: the
    reference traced shape-only, the port on the meta device, each with
    its ``chunked_attention`` recording its calls."""
    rcfg = RR.get_smoke_config("yi-6b", dtype="float32", attn_chunk=chunk)
    tcfg = TR.get_smoke_config("yi-6b", dtype="float32", attn_chunk=chunk)
    seen = []
    real_r, real_t = RL.chunked_attention, TL.chunked_attention
    monkeypatch.setattr(RL, "chunked_attention",
                        lambda *a, **k: seen.append("r") or real_r(*a, **k))
    monkeypatch.setattr(TL, "chunked_attention",
                        lambda *a, **k: seen.append("t") or real_t(*a, **k))
    d, hd = rcfg.d_model, rcfg.n_heads * rcfg.dh
    kvd = rcfg.n_kv_heads * rcfg.dh
    shapes = {"wq": (d, hd), "wk": (d, kvd), "wv": (d, kvd), "wo": (hd, d)}
    rp = {k: jax.ShapeDtypeStruct(v, jnp.float32) for k, v in shapes.items()}
    jax.eval_shape(lambda p, x: RL.self_attention(p, x, rcfg), rp,
                   jax.ShapeDtypeStruct((1, s, d), jnp.float32))
    tp = {k: torch.empty(v, device="meta") for k, v in shapes.items()}
    TL.self_attention(tp, torch.empty((1, s, d), device="meta"), tcfg)
    return "r" in seen, "t" in seen


@pytest.mark.parametrize("s,chunk", [(8191, 1024), (8192, 1024),
                                     (8192, 2048), (8192, 4096),
                                     (16384, 4096), (16383, 4096),
                                     (32768, 1024), (32, 8), (8192, 0)])
def test_chunk_condition_matches_reference(monkeypatch, s, chunk):
    r, t = _took_chunked(monkeypatch, s, chunk)
    assert r == t == TL.uses_chunked_attention(
        TR.get_smoke_config("yi-6b", attn_chunk=chunk), s)


def test_self_attention_chunked_at_8192_matches_reference(monkeypatch):
    """One prefill attention at S = 8192, chunk 2048: both sides chunk."""
    rcfg = RR.get_smoke_config("yi-6b", dtype="float32", attn_chunk=2048)
    tcfg = TR.get_smoke_config("yi-6b", dtype="float32", attn_chunk=2048)
    seen = []
    real = TL.chunked_attention
    monkeypatch.setattr(TL, "chunked_attention",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    rng = np.random.default_rng(11)
    d, hd = rcfg.d_model, rcfg.n_heads * rcfg.dh
    kvd = rcfg.n_kv_heads * rcfg.dh
    p = {"wq": _rand(rng, (d, hd), d ** -0.5),
         "wk": _rand(rng, (d, kvd), d ** -0.5),
         "wv": _rand(rng, (d, kvd), d ** -0.5),
         "wo": _rand(rng, (hd, d), hd ** -0.5)}
    x = _rand(rng, (1, 8192, d))
    want, (wk, wv) = jax.jit(lambda p, x: RL.self_attention(p, x, rcfg))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got, (gk, gv) = TL.self_attention(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        tcfg)
    assert seen
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        assert _rel(g, w) < 2e-5


# --------------------------------------------------------------------------
# ssd_lowp
# --------------------------------------------------------------------------


def test_ssd_intra_lowp_plain_rounds_where_the_reference_does():
    """The plain version's lowp route against the reference's intra block
    (the einsum of ssd_chunked with intra_dtype bf16) and against its own
    f32 route; a bf16 result from f32 operands keeps the f32 route and
    rounds once."""
    rng = np.random.default_rng(3)
    c_, h, l, n, p = 3, 2, 16, 8, 16
    a = -np.abs(_rand(rng, (c_, h, l), 0.3))
    b, c = _rand(rng, (c_, l, n)), _rand(rng, (c_, l, n))
    x = _rand(rng, (c_, l, h, p))
    bf = jnp.bfloat16
    L = jnp.exp(RSSM._segsum(jnp.asarray(a))).astype(bf)
    want = jnp.einsum("cin,cjn,chij,cjhp->cihp", jnp.asarray(c).astype(bf),
                      jnp.asarray(b).astype(bf), L,
                      jnp.asarray(x).astype(bf))
    ta, tb, tc, tx = map(torch.from_numpy, (a, b, c, x))
    got = SI.ssd_intra_chunk(ta, tb.bfloat16(), tc.bfloat16(), tx.bfloat16(),
                             out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert _rel(got.float(), want.astype(jnp.float32)) < 2e-2
    f32 = SI.ssd_intra_chunk_plain(ta, tb, tc, tx)
    assert _rel(got.float(), f32) < 2e-2
    assert torch.equal(SI.ssd_intra_chunk_plain(
        ta, tb, tc, tx, out_dtype=torch.bfloat16), f32.bfloat16())


@pytest.mark.parametrize("s", [50, 64])
def test_ssd_chunked_lowp_matches_reference(s):
    rng = np.random.default_rng(s)
    x = _rand(rng, (2, s, 2, 16))
    a = -np.abs(_rand(rng, (2, s, 2), 0.3))
    b, c = _rand(rng, (2, s, 8)), _rand(rng, (2, s, 8))
    want_y, want_h = RSSM.ssd_chunked(*map(jnp.asarray, (x, a, b, c)), 16,
                                      intra_dtype=jnp.bfloat16)
    got_y, got_h = TSSM.ssd_chunked(*map(torch.from_numpy, (x, a, b, c)),
                                    16, intra_dtype=torch.bfloat16)
    assert got_y.dtype == torch.float32
    assert _rel(got_y, want_y) < 2e-2
    assert _rel(got_h, want_h) < 2e-5  # the states do not take the block
    with pytest.raises(ValueError, match="intra_dtype"):
        TSSM.ssd_chunked(*map(torch.from_numpy, (x, a, b, c)), 16,
                         intra_dtype=torch.float16)


@functools.lru_cache(maxsize=1)
def _mamba():
    """The mamba2 smoke config with ssd_lowp, the reference's params (its
    init jitted: eager it takes seconds) and the port's copy of them; the
    port's leaves are copied again by each caller that mutates them."""
    kw = dict(dtype="float32", ssd_lowp=True)
    rcfg = RR.get_smoke_config("mamba2-780m", **kw)
    tcfg = TR.get_smoke_config("mamba2-780m", **kw)
    rp = jax.jit(lambda: RR.model_fns(rcfg).init_params(
        rcfg, jax.random.PRNGKey(0)))()
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, rp),
                                   tcfg, device="cpu")
    return rcfg, tcfg, rp, tp


def test_mamba_lowp_train_loss_and_grads_match_reference():
    rcfg, tcfg, rp, tp = _mamba()
    toks = np.random.default_rng(5).integers(0, 256, (2, 40)).astype(
        np.int32)
    (_, rce), rg = jax.jit(jax.value_and_grad(RTR.make_loss_fn(rcfg),
                                              has_aux=True))(
        rp, {"tokens": jnp.asarray(toks)})
    tp = TO.tree_map(lambda t: t.detach().clone().requires_grad_(), tp)
    (_, tce), tg = TTR.value_and_grad(TTR.make_loss_fn(tcfg), tp,
                                      {"tokens": torch.from_numpy(toks)})
    assert abs(float(tce) - float(rce)) < 1e-2 * abs(float(rce))
    for g, w in zip(TO.leaves(tg), jax.tree_util.tree_leaves(rg)):
        assert tuple(g.shape) == w.shape
        if np.abs(np.asarray(w)).max() > 0:
            assert _rel(g, w) < 5e-2
        assert float(g.abs().max()) > 0 or not np.abs(np.asarray(w)).any()


def test_mamba_lowp_engine_tokens_match_reference():
    rcfg, tcfg, rp, tp = _mamba()
    toks = np.random.default_rng(4).integers(0, 256, (2, 24)).astype(
        np.int32)
    n_new = 6
    want = REngine(rcfg, rp).generate({"tokens": jnp.asarray(toks)}, n_new)
    got = Engine(tcfg, tp).generate({"tokens": torch.from_numpy(toks)}, n_new)
    # the reference's own margins, step by step, jitted as its Engine runs
    fns = RR.model_fns(rcfg)
    prefill = jax.jit(fns.prefill, static_argnames=("cfg",))
    decode = jax.jit(fns.decode_step, static_argnames=("cfg",))
    logits, cache = prefill(rp, {"tokens": jnp.asarray(toks)}, cfg=rcfg)
    margins = []
    for t in range(n_new):
        top2 = np.sort(np.asarray(logits), axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        logits, cache = decode(rp, cache, jnp.asarray(want[:, t:t + 1]),
                               cfg=rcfg)
    margins = np.stack(margins, 1)
    for row in range(2):
        diff = np.nonzero(got[row] != want[row])[0]
        if diff.size:
            assert margins[row, diff[0]] <= 5e-2, (row, got, want)


# --------------------------------------------------------------------------
# the sharding hints on plain tensors
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch,hint", [("yi-6b", "seq_shard_residual"),
                                       ("phi3.5-moe-42b-a6.6b", "moe_hints"),
                                       ("phi3.5-moe-42b-a6.6b",
                                        "seq_shard_residual")])
def test_hints_leave_plain_tensors_bit_for_bit(arch, hint):
    cfg = TR.get_smoke_config(arch, dtype="float32")
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 16)))
    off = TT.train_loss(params, {"tokens": toks}, cfg)
    on = TT.train_loss(params, {"tokens": toks},
                       dataclasses.replace(cfg, **{hint: True}))
    assert torch.equal(off, on)
    h_off, _, _ = TT.forward_hidden(params, {"tokens": toks}, cfg)
    h_on, _, _ = TT.forward_hidden(params, {"tokens": toks},
                                   dataclasses.replace(cfg, **{hint: True}))
    assert torch.equal(h_off, h_on)
