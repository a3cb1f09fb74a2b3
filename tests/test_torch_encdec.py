"""The port's encdec family (whisper: encoder, decoder with cross
attention, learned decoder positions, tied head) against the reference.

Model: the whisper-tiny smoke config in float32 (2 + 2 layers, d_model 64,
4 heads of 16, d_ff 128, vocab 256, 32 stub frames), with the reference's
own ``init_params`` carried across through numpy; the frames are drawn
from a numpy seed.

Tolerances are ``test_torch_ssm.py``'s: 1e-4 in dense mode, 1e-5 in QAT.
Each module on the same inputs agrees within 1e-5 (QAT modules bit for
bit). The whole QAT slice is held within 1e-5 with the port's
``layernorm`` computing through the reference's: the two frameworks sum a
row of 64 f32 values in different orders, so LayerNorm outputs can differ
by an ulp (as the encoder's attention sums can), and eq. 5 turns such an
ulp into a whole activation level wherever a value sits on a half-level;
the stub frames (0.02 a unit) are scaled some 50x by the encoder's first
LayerNorm, so one such level reaches many later ones. On these tests'
batches the substituted LayerNorm meets every level where the reference
does. ``test_qat_layers_agree_bit_for_bit`` holds the decoder's QAT
modules bit for bit on the reference's inputs;
``test_qat_slice_with_own_layernorm_departs_only_by_level_flips`` runs the
whole QAT prefill with the port's own ``layernorm`` on a batch where
levels do flip, and the Engine test's ``qat_own_layernorm`` case serves
with it (on that trace no level flips).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.launch import serve as RSERVE  # noqa: E402
from repro.models import encdec as RE  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import registry as RR  # noqa: E402
from repro.serve.engine import Engine as REngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import serve as TSERVE  # noqa: E402
from repro_torch.models import encdec as TE  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.serve import Engine  # noqa: E402

ARCH = "whisper-tiny"
TOL = {"dense": 1e-4, "qat": 1e-5}
_PARAMS = {}
_R_PREFILL = jax.jit(RE.prefill, static_argnames=("cfg",))
_R_DECODE = jax.jit(RE.decode_step, static_argnames=("cfg",))


def _params(mode="dense"):
    """(rcfg, tcfg, reference params, the port's copy of them)."""
    kw = dict(dtype="float32", cim_mode=mode)
    rcfg, tcfg = RR.get_smoke_config(ARCH, **kw), TR.get_smoke_config(
        ARCH, **kw)
    if not _PARAMS:
        rp = RR.model_fns(rcfg).init_params(rcfg, jax.random.PRNGKey(0))
        _PARAMS["p"] = (rp, convert.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, rp), tcfg, device="cpu"))
    return (rcfg, tcfg) + _PARAMS["p"]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _batch(b, s, seed=0, enc_seq=32):
    """(reference batch, port batch): tokens and stub frames."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (b, s)).astype(np.int32)
    frames = (rng.standard_normal((b, enc_seq, 64)) * 0.02).astype(
        np.float32)
    return ({"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)},
            {"tokens": torch.from_numpy(toks),
             "frames": torch.from_numpy(frames)})


def _reference_layernorm(x, g, b, eps=1e-5):
    y = RL.layernorm(jnp.asarray(x.numpy()), jnp.asarray(g.numpy()),
                     jnp.asarray(b.numpy()), eps)
    return torch.from_numpy(np.array(y))


@pytest.fixture
def shared_layernorm(monkeypatch):
    """The port's ``layernorm`` computed by the reference's (see the module
    docstring): the QAT slice then meets every level where the reference
    does."""
    monkeypatch.setattr(TL, "layernorm", _reference_layernorm)


def _layer(stack, i=0):
    return jax.tree_util.tree_map(lambda a: a[i], stack)


def _x(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.5
            ).astype(np.float32)


@pytest.mark.parametrize("rows", [1, 7, 300])
def test_layernorm_matches_reference(rows):
    x = _x((2, rows, 64), rows) * 3 + 1
    g, b = _x((64,), 1) + 1, _x((64,), 2)
    want = RL.layernorm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    got = TL.layernorm(*(torch.from_numpy(a) for a in (x, g, b)))
    assert got.dtype == torch.float32
    _close(got, want, 1e-5)
    xb = torch.from_numpy(x).bfloat16()
    assert TL.layernorm(xb, torch.from_numpy(g), torch.from_numpy(b)
                        ).dtype == torch.bfloat16


@pytest.mark.parametrize("mode", ["dense", "qat"])
def test_layers_match_reference(mode):
    """``gelu_mlp`` (GELU's tanh form), ``bidir_attention`` and
    ``cross_attention`` on the same inputs within 1e-5."""
    rcfg, tcfg, rp, tp = _params(mode)
    enc, dec = _layer(rp["enc_layers"]), TE._layer(tp["dec_layers"], 0)
    denc = _layer(rp["dec_layers"])
    tenc = TE._layer(tp["enc_layers"], 0)
    x, y = _x((2, 9, 64), 3), _x((2, 32, 64), 4)
    kv = (_x((2, 32, 4, 16), 5), _x((2, 32, 4, 16), 6))
    cases = [
        (RL.gelu_mlp(enc["mlp"], jnp.asarray(x), rcfg.cim),
         TL.gelu_mlp(tenc["mlp"], torch.from_numpy(x), tcfg.cim)),
        (RL.bidir_attention(enc["attn"], jnp.asarray(y), rcfg),
         TL.bidir_attention(tenc["attn"], torch.from_numpy(y), tcfg)),
        (RL.cross_attention(denc["cross"], jnp.asarray(x),
                            tuple(map(jnp.asarray, kv)), rcfg),
         TL.cross_attention(dec["cross"], torch.from_numpy(x),
                            tuple(map(torch.from_numpy, kv)), tcfg))]
    for want, got in cases:
        assert tuple(got.shape) == tuple(want.shape)
        _close(got, want, 1e-5)


def test_qat_layers_agree_bit_for_bit():
    """In QAT every module but LayerNorm is the reference's bit for bit on
    the reference's own inputs: each decoder layer's self attention, cross
    K/V, cross attention and MLP, fed the reference's activations."""
    rcfg, tcfg, rp, tp = _params("qat")
    rb, _ = _batch(2, 12, seed=7)
    enc = RE.encode(rp, rb["frames"], rcfg)
    x = RE._dec_embed(rp, rb["tokens"], 0, rcfg)
    t = lambda a: torch.from_numpy(np.array(a))
    eq = lambda got, want: np.testing.assert_array_equal(
        got.numpy(), np.asarray(want))
    for i in range(rcfg.n_layers):
        p, q = _layer(rp["dec_layers"], i), TE._layer(tp["dec_layers"], i)
        h = RE._ln(x, p["ln1"])
        a, _ = RL.self_attention(p["self"], h, rcfg, use_rope=False)
        eq(TL.self_attention(q["self"], t(h), tcfg, use_rope=False)[0], a)
        x = x + a
        h = RE._ln(x, p["lnx"])
        kx = RL.cim_matmul(enc, p["cross"]["wk"], rcfg.cim).reshape(
            2, 32, 4, 16)
        vx = RL.cim_matmul(enc, p["cross"]["wv"], rcfg.cim).reshape(
            2, 32, 4, 16)
        tk, tv = TE._cross_kv(q, t(enc), tcfg)
        eq(tk, kx)
        eq(tv, vx)
        c = RL.cross_attention(p["cross"], h, (kx, vx), rcfg)
        eq(TL.cross_attention(q["cross"], t(h), (t(kx), t(vx)), tcfg), c)
        x = x + c
        h = RE._ln(x, p["ln2"])
        m = RL.gelu_mlp(p["mlp"], h, rcfg.cim)
        eq(TL.gelu_mlp(q["mlp"], t(h), tcfg.cim), m)
        x = x + m


def test_init_params_and_cache_match_reference_tree():
    """The port's own random init and empty cache have the reference's
    trees: the same keys, shapes and dtypes (the numbers differ)."""
    rcfg, tcfg, rp, _ = _params()
    tp = TE.init_params(tcfg, torch.Generator().manual_seed(0),
                        device="cpu")
    for want, got in ((rp, tp), (RE.init_cache(rcfg, 2, 40),
                                 TE.init_cache(tcfg, 2, 40, device="cpu"))):
        flat_r = {jax.tree_util.keystr(p): v for p, v in
                  jax.tree_util.tree_leaves_with_path(want)}
        flat_t = {jax.tree_util.keystr(p): v for p, v in
                  jax.tree_util.tree_leaves_with_path(got)}
        assert sorted(flat_r) == sorted(flat_t)
        for k, v in flat_r.items():
            if k != "['pos']":
                assert tuple(v.shape) == tuple(flat_t[k].shape), k
                assert str(v.dtype) == str(flat_t[k].dtype).split(".")[-1], k


def test_encode_decode_full_and_train_loss_match_reference():
    rcfg, tcfg, rp, tp = _params()
    rb, tb = _batch(2, 10, seed=1)
    want = RE.encode(rp, rb["frames"], rcfg)
    got = TE.encode(tp, tb["frames"], tcfg)
    _close(got, want, TOL["dense"])
    _close(TE.decode_full(tp, tb["tokens"], got, tcfg),
           RE.decode_full(rp, rb["tokens"], want, rcfg), TOL["dense"])
    _close(TE.train_loss(tp, tb, tcfg), RE.train_loss(rp, rb, rcfg),
           TOL["dense"])


def test_decoder_positions_clamp_to_the_last():
    """Learned positions past MAX_DEC_POS - 1 take the last one."""
    rcfg, tcfg, rp, tp = _params()
    toks = np.arange(6, dtype=np.int32)[None]
    want = RE._dec_embed(rp, jnp.asarray(toks), 8189, rcfg)
    got = TE._dec_embed(tp, torch.from_numpy(toks), 8189, tcfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rows = torch.tensor([8189, 8190, 8191, 8191, 8191, 8191])
    assert torch.equal(got[0], tp["embed"][:6] + tp["pos_dec"][rows])


def _prefill_and_decode(mode, steps=6):
    rcfg, tcfg, rp, tp = _params(mode)
    rb, tb = _batch(2, 12, seed=2)
    want, rc = _R_PREFILL(rp, rb, cfg=rcfg)
    got, tc = TE.prefill(tp, tb, tcfg)
    _close(got, want, TOL[mode])
    assert tc["pos"] == int(rc["pos"]) == 12
    assert sorted(tc) == sorted(rc)
    for k in ("k", "v", "xk", "xv"):
        _close(tc[k], rc[k], TOL[mode])
    # the Engine's cache: self K/V grown to the whole length
    rc = {**rc, **{k: jnp.pad(rc[k], [(0, 0), (0, 0), (0, steps), (0, 0),
                                      (0, 0)]) for k in ("k", "v")}}
    tc = Engine(tcfg, tp)._decode_cache(tc, 12 + steps)
    nxt = np.random.default_rng(3).integers(0, 256, (2, steps)).astype(
        np.int32)
    for t in range(steps):
        want, rc = _R_DECODE(rp, rc, jnp.asarray(nxt[:, t:t + 1]), cfg=rcfg)
        got, out = TE.decode_step(tp, tc, torch.from_numpy(nxt[:, t:t + 1]),
                                  tcfg)
        assert out is tc and tc["pos"] == 13 + t
        _close(got, want, TOL[mode])
        for k in ("k", "v"):
            _close(tc[k], rc[k], TOL[mode])


def test_prefill_and_decode_logits_match_reference_dense():
    _prefill_and_decode("dense")


def test_prefill_and_decode_logits_match_reference_qat(shared_layernorm):
    _prefill_and_decode("qat")


def _eq5_sites(monkeypatch, module, record):
    """Record every eq. 5 activation quantization ``module`` makes, in
    order, through ``record(sites, x, y)``: (input, quantized output)."""
    sites, quant = [], module.maybe_quant_a

    def quant_recorded(x, cim):
        y = quant(x, cim)
        record(sites, x, y)
        return y
    monkeypatch.setattr(module, "maybe_quant_a", quant_recorded)
    return sites


def _record_jax(sites, x, y):
    """Inside a jitted function: the values reach ``sites`` in order."""
    jax.debug.callback(lambda a, b: sites.append(
        (np.asarray(a, np.float64), np.asarray(b, np.float64))), x, y,
        ordered=True)


def _record_torch(sites, x, y):
    sites.append((x.detach().double().numpy(), y.detach().double().numpy()))


def test_qat_slice_with_own_layernorm_departs_only_by_level_flips(
        monkeypatch):
    """The whole QAT prefill (encoder, decoder, cross K/V, tied head) with
    the port's own ``layernorm``, against the reference's jitted prefill
    with its eq. 5 sites recorded (its logits unchanged by the recording),
    on a batch where levels do flip. Every eq. 5 site of the reference is one
    of the port's, in the same order and shape. Up to the first site where
    a level differs every level is equal, and there the inputs agree
    within 1e-5 of max |x| (the f32 LayerNorm rows and attention sums,
    taken in other orders, differ by ulps) and each differing level is one
    level apart: an ulp moves a value across at most one edge."""
    rcfg, tcfg, rp, tp = _params("qat")
    q = tcfg.cim.quant
    unit = 2.0 ** (q.a_bits - 1) if q.a_signed else 2.0 ** q.a_bits
    rb, tb = _batch(2, 12, seed=5)
    want = np.asarray(_R_PREFILL(rp, rb, cfg=rcfg)[0])
    ref_sites = _eq5_sites(monkeypatch, RL, _record_jax)
    # a function of its own, so that jit traces it anew with the recorder
    recorded = jax.jit(lambda p, b: RE.prefill(p, b, rcfg)[0])(rp, rb)
    jax.effects_barrier()
    np.testing.assert_array_equal(np.asarray(recorded), want)
    own_sites = _eq5_sites(monkeypatch, TL, _record_torch)
    got, _ = TE.prefill(tp, tb, tcfg)
    assert len(own_sites) == len(ref_sites) > 0
    assert all(g[0].shape == r[0].shape
               for g, r in zip(own_sites, ref_sites))
    levels = [np.abs(g[1] - r[1]) * unit
              for g, r in zip(own_sites, ref_sites)]
    first = next(i for i, d in enumerate(levels) if d.max() > 0)
    x_own, x_ref = own_sites[first][0], ref_sites[first][0]
    assert np.abs(x_own - x_ref).max() <= 1e-5 * np.abs(x_ref).max()
    assert set(np.unique(levels[first])) == {0.0, 1.0}
    assert np.isfinite(got.numpy()).all() and got.shape == want.shape


class _RecordingEngine(REngine):
    """The reference Engine keeping the logits it samples from."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.logits = []

    def _sample(self, logits, key):
        self.logits.append(np.asarray(logits))
        return super()._sample(logits, key)


@pytest.mark.parametrize("mode", ["dense", "qat", "qat_own_layernorm"])
def test_engine_tokens_match_reference(mode, request):
    """Engine greedy tokens, 4 prompts of 10 with 16 new: equal to the
    reference Engine's where its top-2 margin exceeds the tolerance. The
    ``qat`` case serves with the reference's LayerNorm substituted, the
    ``qat_own_layernorm`` case with the port's own."""
    if mode == "qat":
        request.getfixturevalue("shared_layernorm")
    mode = mode.split("_")[0]
    rcfg, tcfg, rp, tp = _params(mode)
    rb, tb = _batch(4, 10, seed=4)
    ref = _RecordingEngine(rcfg, rp)
    want = ref.generate(rb, 16)
    got = Engine(tcfg, tp).generate(tb, 16)
    assert got.shape == (4, 16) and got.dtype == np.int32
    top2 = np.sort(np.stack(ref.logits, 1), axis=-1)[..., -2:]
    margins = top2[..., 1] - top2[..., 0]
    for row in range(4):
        diff = np.nonzero(got[row] != want[row])[0]
        if diff.size:
            assert margins[row, diff[0]] <= TOL[mode], (row, got, want)


def test_cli_legacy_tokens_equal_reference_cli(monkeypatch, capsys):
    """``--engine legacy`` on the smoke config: the stub frames come from
    the CLI's numpy stream after the tokens, so the port's CLI (the
    reference's weights carried across in place of its own seeded init)
    prints the reference CLI's tokens."""
    argv = ["--arch", ARCH, "--smoke", "--engine", "legacy", "--batch", "2",
            "--new-tokens", "8"]
    RSERVE.main(argv)
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("   [")]
    _, _, _, tp = _params()
    monkeypatch.setattr(TSERVE, "_init_params", lambda cfg, seed, dev: tp)
    out = TSERVE.main(argv + ["--device", "cpu"])
    got = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("   [")]
    assert len(want) == 2 and got == want
    assert out.shape == (2, 8)
