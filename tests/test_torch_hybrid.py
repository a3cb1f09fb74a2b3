"""The port's hybrid family (zamba2: mamba2 blocks with a shared attention
block whose KV cache is a ring of the window) against the reference.

Model: the zamba2-1.2b smoke config in float32 (5 layers: 2 super-layers
of 2 mamba blocks, each followed by the shared block, and 1 tail block;
d_model 64, 4 heads of 16, state 16, chunk 16, window 64, vocab 256), with
the reference's own ``init_params`` carried across through numpy.

Tolerances are ``test_torch_ssm.py``'s: 1e-4 in dense mode (plain f32 on
both sides, sums in other orders), 1e-5 in QAT (w8a8; the projections'
f32 sums of eq. 5 and eq. 8 levels are exact). Greedy tokens are held by
the margin rule: equal to the reference's wherever the reference's top-2
logit margin exceeds the tolerance.

The reference serves a prompt longer than the window wrongly: its Engine
pads the shared cache to ``min(total, window)``, which leaves a longer
prefill cache as it is, and its decode then treats the cache as no ring,
writes every step's K/V at the clamped last slot and attends without the
window. The port keeps the prompt's last ``window`` positions in their
ring slots (``transformer.ring_cache``); that case is held against a
from-scratch windowed forward of the whole sequence, and the reference's
divergence there is shown.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.launch import serve as RSERVE  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import registry as RR  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.serve.engine import Engine as REngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import serve as TSERVE  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import Engine  # noqa: E402

ARCH = "zamba2-1.2b"
TOL = {"dense": 1e-4, "qat": 1e-5}
_PARAMS = {}


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


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(
        np.int32)


class _RecordingEngine(REngine):
    """The reference Engine keeping the logits it samples from."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.logits = []

    def _sample(self, logits, key):
        self.logits.append(np.asarray(logits))
        return super()._sample(logits, key)


def _margins(logits):
    top2 = np.sort(np.stack(logits, 1), axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def _assert_tokens_by_margin(got, want, margins, tol):
    for row in range(want.shape[0]):
        diff = np.nonzero(got[row] != want[row])[0]
        if diff.size:  # the first divergence must sit on a near-tie
            assert margins[row, diff[0]] <= tol, (row, diff[0], got, want)


def test_init_params_and_cache_match_reference_tree():
    """The port's own random init and empty cache have the reference's
    trees: the same keys, shapes and dtypes (the numbers differ)."""
    rcfg, tcfg, rp, _ = _params()
    tp = TT.init_params(tcfg, torch.Generator().manual_seed(0),
                        device="cpu")
    for want, got in ((rp, tp),
                      (RT.init_cache(rcfg, 2, 80),
                       TT.init_cache(tcfg, 2, 80, device="cpu"))):
        flat_r = {jax.tree_util.keystr(p): v for p, v in
                  jax.tree_util.tree_leaves_with_path(want)}
        flat_t = {jax.tree_util.keystr(p): v for p, v in
                  jax.tree_util.tree_leaves_with_path(got)}
        assert sorted(flat_r) == sorted(flat_t)
        for k, v in flat_r.items():
            if k == "['pos']":
                continue
            assert tuple(v.shape) == tuple(flat_t[k].shape), k
            assert str(v.dtype) == str(flat_t[k].dtype).split(".")[-1], k
    assert tuple(TT.init_cache(tcfg, 2, 80, device="cpu")["k"].shape) == (
        2, 2, 64, 4, 16)  # the ring: the window, not max_len


@pytest.mark.parametrize("pos", [5, 63, 64, 100])
def test_ring_decode_attention_matches_reference(pos):
    """``decode_attention(..., ring=True)`` against the reference's own
    decode on the same ring cache, before the wrap, at its last slot and
    after it: y and the written cache within 1e-5."""
    rcfg, tcfg, rp, tp = _params()
    rng = np.random.default_rng(pos)
    x1 = (rng.standard_normal((2, 1, 64)) * 0.5).astype(np.float32)
    kc, vc = ((rng.standard_normal((2, 64, 4, 16)) * 0.5).astype(np.float32)
              for _ in range(2))
    y, kw, vw = RL.decode_attention(rp["shared_attn"], jnp.asarray(x1),
                                    jnp.asarray(kc), jnp.asarray(vc),
                                    jnp.asarray(pos, jnp.int32), rcfg,
                                    window=0, use_rope=True, ring=True)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got, _, _ = TL.decode_attention(tp["shared_attn"], torch.from_numpy(x1),
                                    tk, tv, pos, tcfg, ring=True)
    _close(got, y, 1e-5)
    _close(tk, kw, 1e-5)
    _close(tv, vw, 1e-5)


# the reference's serving entry points, jitted as its Engine runs them
_R_PREFILL = jax.jit(RT.prefill, static_argnames=("cfg",))
_R_DECODE = jax.jit(RT.decode_step, static_argnames=("cfg",))


@jax.jit
def _r_all_logits(rp, toks):
    """The reference's windowed forward: every position's logits."""
    rcfg = RR.get_smoke_config(ARCH, dtype="float32")
    hidden, _, _ = RT.forward_hidden(rp, {"tokens": toks}, rcfg)
    return RL.logits_out(rp["head"], hidden, rcfg.cim)


def _prefill(rcfg, tcfg, rp, tp, toks):
    want, rc = _R_PREFILL(rp, {"tokens": jnp.asarray(toks)}, cfg=rcfg)
    got, tc = TT.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    return want, rc, got, tc


@pytest.mark.parametrize("mode", ["dense", "qat"])
def test_prefill_and_ring_decode_logits_match_reference(mode):
    """A prompt of 48 through prefill (every cache tensor held), then 24
    decode steps over the ring of the 64-slot window, wrapping at the 17th:
    logits and caches within TOL at every step."""
    rcfg, tcfg, rp, tp = _params(mode)
    toks = _tokens(2, 48)
    want, rc, got, tc = _prefill(rcfg, tcfg, rp, tp, toks)
    _close(got, want, TOL[mode])
    assert tc["pos"] == int(rc["pos"]) == 48
    assert sorted(tc) == sorted(rc)
    for k in rc:
        if k != "pos":
            _close(tc[k], rc[k], TOL[mode])
    rc = RT.pad_cache(rc, 64)
    tc = TT.ring_cache(tc, 64)
    nxt = _tokens(2, 24, seed=1)
    for t in range(24):
        want, rc = _R_DECODE(rp, rc, jnp.asarray(nxt[:, t:t + 1]),
                             cfg=rcfg)
        got, out = TT.decode_step(tp, tc, torch.from_numpy(nxt[:, t:t + 1]),
                                  tcfg)
        assert out is tc and tc["pos"] == 49 + t
        _close(got, want, TOL[mode])
        for k in rc:
            if k != "pos":
                _close(tc[k], rc[k], TOL[mode])


@pytest.mark.parametrize("mode", ["dense", "qat"])
def test_engine_tokens_match_reference_past_the_wrap(mode):
    """Engine greedy tokens: a prompt of 48 with 32 new, so the ring wraps
    at the 16th decode step; equal to the reference Engine's by the margin
    rule."""
    rcfg, tcfg, rp, tp = _params(mode)
    toks = _tokens(2, 48, seed=2)
    ref = _RecordingEngine(rcfg, rp)
    want = ref.generate({"tokens": jnp.asarray(toks)}, 32)
    got = Engine(tcfg, tp).generate({"tokens": torch.from_numpy(toks)}, 32)
    assert got.shape == (2, 32) and got.dtype == np.int32
    _assert_tokens_by_margin(got, want, _margins(ref.logits), TOL[mode])


def test_prompt_longer_than_the_window_decodes_its_window():
    """A prompt of 80 (> window 64), 8 new: each decode step's logits
    equal, within 1e-4, a from-scratch windowed forward of the whole
    sequence (causal, so its position p is a prefill of the first p + 1
    tokens). The reference's Engine, on the same tokens, diverges from its
    own windowed forward: its prefill cache keeps all 80 positions, so its
    decode runs without the ring and without the window."""
    rcfg, tcfg, rp, tp = _params()
    toks = _tokens(2, 80, seed=3)
    eng = Engine(tcfg, tp)
    logits = []
    decode = eng.fns.decode_step

    def recording(params, cache, tok, cfg):
        assert cache["k"].shape[2] == 64  # the ring of the window
        out = decode(params, cache, tok, cfg)
        logits.append(out[0])
        return out

    eng.fns = TR.ModelFns(**{**eng.fns.__dict__, "decode_step": recording})
    out = eng.generate({"tokens": torch.from_numpy(toks)}, 8)
    seq = np.concatenate([toks, out], axis=1)  # step t reads out[:, t]
    hidden, _, _ = TT.forward_hidden(tp, {"tokens": torch.from_numpy(seq)},
                                     tcfg)
    whole = TL.logits_out(tp["head"], hidden, tcfg.cim)[:, 80:]
    assert len(logits) == 8
    gap = float((torch.stack(logits, 1) - whole).abs().max())
    assert gap <= TOL["dense"], gap

    # the reference's own decode against its own windowed forward
    _, rc = _R_PREFILL(rp, {"tokens": jnp.asarray(toks)}, cfg=rcfg)
    rc = RT.pad_cache(rc, min(80 + 8, rcfg.window))  # what its Engine does
    assert rc["k"].shape[2] == 80
    ref = []
    for t in range(8):
        lg, rc = _R_DECODE(rp, rc, jnp.asarray(out[:, t:t + 1]), cfg=rcfg)
        ref.append(np.asarray(lg))
    ref_whole = np.asarray(_r_all_logits(rp, jnp.asarray(seq)))[:, 80:]
    ref_gap = float(np.abs(np.stack(ref, 1) - ref_whole).max())
    assert ref_gap > 100 * TOL["dense"], ref_gap


def test_ring_cache_places_positions_in_their_slots():
    """``ring_cache``: a short prompt is padded to the ring; of a long one
    the last ``kv_len`` positions land at ``p % kv_len``."""
    k = torch.arange(10, dtype=torch.float32).reshape(1, 1, 10, 1, 1)
    cache = {"k": k, "v": -k, "pos": 10}
    short = TT.ring_cache(cache, 16)
    assert short["k"].shape[2] == 16 and torch.equal(short["k"][:, :, :10],
                                                     k)
    ring = TT.ring_cache(cache, 4)
    assert ring["k"].flatten().tolist() == [8.0, 9.0, 6.0, 7.0]
    assert torch.equal(ring["v"], -ring["k"]) and ring["pos"] == 10


def test_decode_refuses_a_cache_past_the_window():
    _, tcfg, _, tp = _params()
    toks = torch.from_numpy(_tokens(1, 70, seed=4))
    _, cache = TT.prefill(tp, {"tokens": toks}, tcfg)
    with pytest.raises(ValueError, match="ring_cache"):
        TT.decode_step(tp, cache, toks[:, :1], tcfg)


def test_cli_legacy_tokens_equal_reference_cli(monkeypatch, capsys):
    """``--engine legacy`` on the smoke config: the port's CLI (the
    reference's weights carried across in place of its own seeded init)
    prints the tokens the reference CLI prints."""
    argv = ["--arch", ARCH, "--smoke", "--engine", "legacy", "--batch", "2",
            "--new-tokens", "8"]
    RSERVE.main(argv)
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("   [")]
    rcfg, tcfg, _, tp = _params()
    monkeypatch.setattr(TSERVE, "_init_params", lambda cfg, seed, dev: tp)
    out = TSERVE.main(argv + ["--device", "cpu"])
    got = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("   [")]
    assert len(want) == 2 and got == want
    assert out.shape == (2, 8)
