"""The port's mamba2 path (ssm family) against the reference.

Model: the mamba2-780m smoke config in float32 (2 layers, d_model 64, 2
heads of 64, state 16, chunk 16, vocab 256), with the reference's own
``init_params`` carried across through numpy, in the fused ``in_proj`` and
the split (``ssm_split_proj``) layouts.

Tolerances. In ``cim_mode="dense"`` every op is plain f32 on both sides and
only the order of the sums differs: 1e-4. In ``cim_mode="qat"`` (w8a8,
signed activations, as ``ModelConfig.cim`` sets it) the projections
multiply eq. 5 and eq. 8 levels, whose f32 sums are exact, so outputs and
logits agree bit for bit and the SSM states to about 1e-7 (the exp and
softplus of the two frameworks differ by ulps): QAT is held at 1e-5.
``test_qat_weights_quantize_to_the_reference_levels`` holds every eq. 8
level bit for bit, so a level flip cannot hide behind the tolerance.
Greedy tokens are held by the margin rule: they must equal the reference's
wherever the reference's own top-2 logit margin exceeds the tolerance.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import registry as RR  # noqa: E402
from repro.models import ssm as RSSM  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.serve.engine import Engine as REngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import ssm as TSSM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import Engine, ServeConfig  # noqa: E402

TOL = {"dense": 1e-4, "qat": 1e-5}
LAYOUTS = {"fused": {}, "split": {"ssm_split_proj": True}}


def _configs(mode="dense", layout="fused", arch="mamba2-780m"):
    kw = dict(dtype="float32", cim_mode=mode, **LAYOUTS[layout])
    return RR.get_smoke_config(arch, **kw), TR.get_smoke_config(arch, **kw)


_PARAMS = {}


def _params(mode="dense", layout="fused", arch="mamba2-780m"):
    """(rcfg, tcfg, reference params, the port's copy of them)."""
    rcfg, tcfg = _configs(mode, layout, arch)
    key = (layout, arch)
    if key not in _PARAMS:
        rp = RR.model_fns(rcfg).init_params(rcfg, jax.random.PRNGKey(0))
        tree = jax.tree_util.tree_map(np.asarray, rp)
        _PARAMS[key] = (rp, convert.params_from_numpy(tree, tcfg,
                                                      device="cpu"))
    return (rcfg, tcfg) + _PARAMS[key]


def _layer(params, i=0):
    return {k: v[i] for k, v in params["layers"].items()}


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(
        np.int32)


def _half_level_ulps(pre: np.ndarray) -> np.ndarray:
    """Distance of f32 values from the nearest half-level, in f32 ulps of
    the value."""
    pre = pre.astype(np.float32)
    half = np.floor(pre) + np.float32(0.5)
    return np.abs(pre.astype(np.float64) - half) / np.spacing(
        np.abs(pre)).astype(np.float64)


def _level_flips(name, got, want, pre, bits):
    """(projection, index, port level, reference level, ulps from a
    half-level) for every weight whose eq. 8 level differs."""
    step = 2.0 ** (bits - 1)
    lg = np.rint(got.astype(np.float64) * step).astype(np.int64)
    lw = np.rint(want.astype(np.float64) * step).astype(np.int64)
    ulps = _half_level_ulps(pre)
    return [(name, tuple(int(i) for i in idx), int(lg[idx]), int(lw[idx]),
             float(ulps[idx])) for idx in zip(*np.nonzero(lg != lw))]


@pytest.mark.parametrize("arch,layout", [("mamba2-780m", "fused"),
                                         ("mamba2-780m", "split"),
                                         ("yi-6b", "fused")])
def test_qat_weights_quantize_to_the_reference_levels(arch, layout):
    """Every projection weight of the parity params through ``maybe_quant_w``
    (eqs. 6 and 8) lands on the reference's level, bit for bit. The two
    frameworks' tanh round differently: their eq. 8 pre-rounding values
    ``w_bar * (2^(b-1) - 1)`` differ by up to 6 f32 ulps on these draws,
    and the nearest of them to a half-level lies 6 ulps from it, on the
    side both frameworks round to. The port's weights are first held equal
    to the reference's bit for bit, so that a failure tells weights that
    differ from levels that do; a level failure lists every differing
    level with its projection, index, both levels and the reference's
    distance from a half-level in ulps (a +-1 flip within a few ulps of
    one is the two tanh functions rounding; anything else is a fault of
    the port)."""
    from repro.core import quant as RQ
    from repro.models import layers as RL
    from repro_torch.models import layers as TL
    rcfg, tcfg, rp, tp = _params("qat", layout, arch)
    weights = [(f"{name}[{i}]", w[i], rp["layers"][name][i])
               for name, w in tp["layers"].items()
               if w.dim() == 3 and not name.startswith("conv")
               for i in range(w.shape[0])]  # the conv kernel is not CIM
    weights.append(("head", tp["head"], rp["head"]))
    q = rcfg.cim.quant
    flips, n_levels = [], 0
    for name, wt, wj in weights:
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj),
                                      err_msg=f"{name}: weights differ")
        got = TL.maybe_quant_w(wt, tcfg.cim).numpy()
        want = np.asarray(RL.maybe_quant_w(wj, rcfg.cim))
        assert got.shape == want.shape and got.dtype == want.dtype, name
        pre = np.asarray(RQ.tanh_normalize(jnp.asarray(wj, jnp.float32),
                                           q.group_size)
                         * (2.0 ** (q.w_bits - 1) - 1.0))
        flips += _level_flips(name, got, want, pre, q.w_bits)
        n_levels += got.size
    assert len(weights) >= 5
    report = "\n".join(f"{n} {i}: port {a}, reference {b}, {u:.1f} ulps "
                        "from a half-level" for n, i, a, b, u in flips)
    assert not flips, f"{len(flips)} of {n_levels} levels differ:\n{report}"


@pytest.mark.parametrize("mode", ["dense", "qat"])
@pytest.mark.parametrize("layout", ["fused", "split"])
def test_mamba_block_matches_reference(layout, mode):
    rcfg, tcfg, rp, tp = _params(mode, layout)
    x = (np.random.default_rng(1).standard_normal((2, 37, 64)) * 0.5
         ).astype(np.float32)
    want, (wconv, wh) = RSSM.mamba_block(_layer(rp), jnp.asarray(x), rcfg)
    got, (gconv, gh) = TSSM.mamba_block(_layer(tp), torch.from_numpy(x),
                                        tcfg)
    for g, w in ((got, want), (gconv, wconv), (gh, wh)):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w, TOL[mode])


@pytest.mark.parametrize("mode", ["dense", "qat"])
@pytest.mark.parametrize("layout", ["fused", "split"])
def test_mamba_decode_step_matches_reference(layout, mode):
    rcfg, tcfg, rp, tp = _params(mode, layout)
    rng = np.random.default_rng(2)
    di, n = rcfg.d_inner, rcfg.ssm_state
    x1 = (rng.standard_normal((3, 1, 64)) * 0.5).astype(np.float32)
    conv = (rng.standard_normal((3, rcfg.conv_width - 1, di + 2 * n)) * 0.5
            ).astype(np.float32)
    h = (rng.standard_normal((3, rcfg.n_ssm_heads, di // rcfg.n_ssm_heads,
                              n)) * 0.5).astype(np.float32)
    want = RSSM.mamba_decode_step(_layer(rp), *(jnp.asarray(t)
                                                for t in (x1, conv, h)), rcfg)
    got = TSSM.mamba_decode_step(_layer(tp), *(torch.from_numpy(t)
                                               for t in (x1, conv, h)), tcfg)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w, TOL[mode])


@pytest.mark.parametrize("mode", ["dense", "qat"])
def test_prefill_and_decode_logits_match_reference(mode):
    rcfg, tcfg, rp, tp = _params(mode)
    toks = _tokens(2, 40)
    want, rcache = RT.prefill(rp, {"tokens": jnp.asarray(toks)}, rcfg)
    got, tcache = TT.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    _close(got, want, TOL[mode])
    assert tcache["pos"] == int(rcache["pos"]) == 40
    for k in ("conv", "ssm"):
        _close(tcache[k], rcache[k], TOL[mode])
    nxt = _tokens(2, 3, seed=1)
    for t in range(3):  # the port's cache is updated in place
        want, rcache = RT.decode_step(rp, rcache, jnp.asarray(nxt[:, t:t + 1]),
                                      rcfg)
        got, out = TT.decode_step(tp, tcache, torch.from_numpy(
            nxt[:, t:t + 1]), tcfg)
        assert out is tcache and tcache["pos"] == 41 + t
        _close(got, want, TOL[mode])
        for k in ("conv", "ssm"):
            _close(tcache[k], rcache[k], TOL[mode])


@pytest.mark.parametrize("layout", ["fused", "split"])
def test_decode_matches_teacher_forced(layout):
    """Step-by-step decode from an empty cache == the full-sequence logits
    at every position (SSD chunked <-> recurrent equivalence), inside the
    port: the counterpart of tests/test_decode_consistency.py."""
    _, tcfg, _, tp = _params("dense", layout)
    toks = torch.from_numpy(_tokens(2, 20, seed=3))
    hidden, _, _ = TT.forward_hidden(tp, {"tokens": toks}, tcfg)
    full = hidden @ tp["head"]
    cache = TT.init_cache(tcfg, 2, 20, device="cpu")
    for t in range(20):
        logits, cache = TT.decode_step(tp, cache, toks[:, t:t + 1], tcfg)
        torch.testing.assert_close(logits, full[:, t], rtol=1e-4, atol=1e-4)


def _reference_margins(rp, rcfg, toks, n_new):
    """The reference's greedy run, step by step and jitted as its Engine
    runs it: its tokens and the top-2 logit margin at every step."""
    fns = RR.model_fns(rcfg)
    prefill = jax.jit(fns.prefill, static_argnames=("cfg",))
    decode = jax.jit(fns.decode_step, static_argnames=("cfg",))
    logits, cache = prefill(rp, {"tokens": jnp.asarray(toks)}, cfg=rcfg)
    if rcfg.family == "dense":
        cache = RT.pad_cache(cache, toks.shape[1] + n_new)
    out, margins = [], []
    for _ in range(n_new):
        top2 = np.sort(np.asarray(logits), axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        tok = np.asarray(jnp.argmax(logits, axis=-1)).astype(np.int32)
        out.append(tok)
        logits, cache = decode(rp, cache, jnp.asarray(tok[:, None]),
                               cfg=rcfg)
    return np.stack(out, 1), np.stack(margins, 1)


def _assert_tokens_by_margin(got, want, margins, tol):
    for row in range(want.shape[0]):
        diff = np.nonzero(got[row] != want[row])[0]
        if diff.size:  # the first divergence must sit on a near-tie
            assert margins[row, diff[0]] <= tol, (row, diff[0], got, want)


@pytest.mark.parametrize("arch,mode", [("mamba2-780m", "qat"),
                                       ("mamba2-780m", "dense"),
                                       ("yi-6b", "qat")])
def test_engine_greedy_tokens_match_reference(arch, mode):
    rcfg, tcfg, rp, tp = _params(mode, "fused", arch)
    toks = _tokens(2, 24, seed=4)
    want = REngine(rcfg, rp).generate({"tokens": jnp.asarray(toks)}, 8)
    got = Engine(tcfg, tp).generate({"tokens": torch.from_numpy(toks)}, 8)
    assert got.shape == (2, 8) and got.dtype == np.int32
    ref_toks, margins = _reference_margins(rp, rcfg, toks, 8)
    np.testing.assert_array_equal(ref_toks, want)
    _assert_tokens_by_margin(got, want, margins, TOL[mode])


def test_engine_eos_freezes_rows_and_samples_from_its_seed():
    _, tcfg, _, tp = _params("qat")
    toks = torch.from_numpy(_tokens(3, 12, seed=5))
    greedy = Engine(tcfg, tp).generate({"tokens": toks}, 6)
    eos = int(greedy[1, 2])
    stopped = Engine(tcfg, tp, ServeConfig(eos_id=eos)).generate(
        {"tokens": toks}, 6)
    for row in range(3):
        hit = np.nonzero(greedy[row] == eos)[0]
        if hit.size:
            k = hit[0]
            np.testing.assert_array_equal(stopped[row, :k + 1],
                                          greedy[row, :k + 1])
            assert (stopped[row, k + 1:] == 0).all()
        else:
            np.testing.assert_array_equal(stopped[row], greedy[row])
    hot = ServeConfig(temperature=1.0, seed=7)
    a = Engine(tcfg, tp, hot).generate({"tokens": toks}, 6)
    b = Engine(tcfg, tp, ServeConfig(temperature=1.0, seed=7)).generate(
        {"tokens": toks}, 6)
    np.testing.assert_array_equal(a, b)
    assert ((0 <= a) & (a < tcfg.vocab)).all()


def test_engine_refuses_unported_families():
    cfg = TR.get_smoke_config("yi-6b", family="rwkv")
    with pytest.raises(NotImplementedError):
        Engine(cfg, {})
    with pytest.raises(NotImplementedError):
        TR.model_fns(cfg)
    with pytest.raises(NotImplementedError):
        TT.init_params(cfg, torch.Generator(), device="cpu")


def test_init_params_matches_reference_tree():
    """The port's own random init has the reference's tree: same keys,
    shapes and dtypes, in both layouts (the numbers differ: torch cannot
    follow jax.random)."""
    for layout in ("fused", "split"):
        rcfg, tcfg = _configs("dense", layout)
        rp = RR.model_fns(rcfg).init_params(rcfg, jax.random.PRNGKey(0))
        tp = TT.init_params(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
        flat_r = {".".join(str(getattr(k, "key", k)) for k in path): v
                  for path, v in jax.tree_util.tree_leaves_with_path(rp)}
        flat_t = {f"layers.{k}" if k in tp["layers"] else k: v
                  for k, v in {**tp["layers"], **{
                      k: v for k, v in tp.items() if k != "layers"}}.items()}
        assert sorted(flat_r) == sorted(flat_t)
        for k, v in flat_r.items():
            assert tuple(v.shape) == tuple(flat_t[k].shape), k
            assert str(v.dtype) == str(flat_t[k].dtype).split(".")[-1], k
