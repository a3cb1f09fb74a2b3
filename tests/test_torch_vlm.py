"""The port's vlm family (llava: precomputed patch embeddings prepended to
the text through ``mm_proj``) against the reference, dense and compressed.

Model: the llava-next-34b smoke config in float32 (2 layers, d_model 64,
4/2 heads of 16, d_ff 128, vocab 256, 8 patches), with the reference's own
``init_params`` carried across through numpy; the patch embeddings are
drawn from a numpy seed.

Tolerances are ``test_torch_ssm.py``'s: 1e-4 in dense mode, 1e-5 in QAT;
greedy tokens by the margin rule. Compressed serving (every projection
and the head packed at 16x16, ``mm_proj`` kept in float) is held bit for
bit between the loop and scan runtimes, and its artifacts cross both ways
with the reference's tokens.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.launch import serve as RSERVE  # noqa: E402
from repro.models import registry as RR  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.serve import deployed as RDP  # noqa: E402
from repro.serve import stacked as RST  # noqa: E402
from repro.serve.engine import Engine as REngine  # noqa: E402
from repro.serve.engine import ServeConfig as RServeConfig  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import serve as TSERVE  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import BatchServer, Engine, ServeConfig  # noqa: E402
from repro_torch.serve import deployed as TDP  # noqa: E402
from repro_torch.serve import stacked as TST  # noqa: E402

ARCH = "llava-next-34b"
TOL = {"dense": 1e-4, "qat": 1e-5}
TILE = (16, 16)
_PARAMS = {}
_R_PREFILL = jax.jit(RT.prefill, static_argnames=("cfg",))
_R_DECODE = jax.jit(RT.decode_step, static_argnames=("cfg",))


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


def _batch(b, s, seed=0, n_patches=8):
    """(reference batch, port batch): tokens and stub patch embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (b, s)).astype(np.int32)
    patches = (rng.standard_normal((b, n_patches, 64)) * 0.02).astype(
        np.float32)
    return ({"tokens": jnp.asarray(toks),
             "patch_embeds": jnp.asarray(patches)},
            {"tokens": torch.from_numpy(toks),
             "patch_embeds": torch.from_numpy(patches)})


class _RecordingEngine(REngine):
    """The reference Engine keeping the logits it samples from."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.logits = []

    def _sample(self, logits, key):
        self.logits.append(np.asarray(logits))
        return super()._sample(logits, key)


def _assert_tokens_by_margin(got, want, logits, tol):
    top2 = np.sort(np.stack(logits, 1), axis=-1)[..., -2:]
    margins = top2[..., 1] - top2[..., 0]
    for row in range(want.shape[0]):
        diff = np.nonzero(got[row] != want[row])[0]
        if diff.size:  # the first divergence must sit on a near-tie
            assert margins[row, diff[0]] <= tol, (row, got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mm_proj_embedding_matches_reference(dtype):
    """The patches through ``mm_proj``, prepended to the token embeddings:
    within 1e-5 in f32 (bf16: the same rounding, within its ulp)."""
    rcfg, tcfg, rp, tp = _params()
    rcfg, tcfg = (RR.get_smoke_config(ARCH, dtype=dtype),
                  TR.get_smoke_config(ARCH, dtype=dtype))
    rb, tb = _batch(2, 5, seed=1)
    want = RT._embed_inputs(rp, rb, rcfg)
    got = TT._embed_inputs(tp, tb, tcfg)
    assert tuple(got.shape) == tuple(want.shape) == (2, 13, 64)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    _close(got.float(), want.astype(jnp.float32),
           1e-5 if dtype == "float32" else 2 ** -8)


def test_init_params_match_reference_tree():
    rcfg, tcfg, rp, _ = _params()
    tp = TT.init_params(tcfg, torch.Generator().manual_seed(0),
                        device="cpu")
    flat_r = {jax.tree_util.keystr(p): v for p, v in
              jax.tree_util.tree_leaves_with_path(rp)}
    flat_t = {jax.tree_util.keystr(p): v for p, v in
              jax.tree_util.tree_leaves_with_path(tp)}
    assert sorted(flat_r) == sorted(flat_t) and "['mm_proj']" in flat_t
    for k, v in flat_r.items():
        assert tuple(v.shape) == tuple(flat_t[k].shape), k
        assert str(v.dtype) == str(flat_t[k].dtype).split(".")[-1], k


def test_train_loss_matches_reference():
    """The text-only loss behind the prepended patches."""
    rcfg, tcfg, rp, tp = _params()
    rb, tb = _batch(2, 10, seed=2)
    _close(TT.train_loss(tp, tb, tcfg), RT.train_loss(rp, rb, rcfg),
           TOL["dense"])


@pytest.mark.parametrize("mode", ["dense", "qat"])
def test_prefill_and_decode_logits_match_reference(mode):
    """``pos`` counts the patches; logits and K/V within TOL through the
    prefill and 4 decode steps."""
    rcfg, tcfg, rp, tp = _params(mode)
    rb, tb = _batch(2, 12, seed=3)
    want, rc = _R_PREFILL(rp, rb, cfg=rcfg)
    got, tc = TT.prefill(tp, tb, tcfg)
    _close(got, want, TOL[mode])
    assert tc["pos"] == int(rc["pos"]) == 20
    rc, tc = RT.pad_cache(rc, 24), TT.pad_cache(tc, 24)
    nxt = np.random.default_rng(4).integers(0, 256, (2, 4)).astype(np.int32)
    for t in range(4):
        want, rc = _R_DECODE(rp, rc, jnp.asarray(nxt[:, t:t + 1]), cfg=rcfg)
        got, tc = TT.decode_step(tp, tc, torch.from_numpy(nxt[:, t:t + 1]),
                                 tcfg)
        _close(got, want, TOL[mode])
        for k in ("k", "v"):
            _close(tc[k], rc[k], TOL[mode])


@pytest.mark.parametrize("mode", ["dense", "qat"])
def test_engine_tokens_match_reference(mode):
    rcfg, tcfg, rp, tp = _params(mode)
    rb, tb = _batch(2, 12, seed=5)
    ref = _RecordingEngine(rcfg, rp)
    want = ref.generate(rb, 12)
    got = Engine(tcfg, tp).generate(tb, 12)
    assert got.shape == (2, 12) and got.dtype == np.int32
    _assert_tokens_by_margin(got, want, ref.logits, TOL[mode])


@pytest.fixture(scope="module")
def compressed():
    """The reference's compressed smoke llava (f32, 16x16, uniform) and
    its Engine tokens on its loop runtime, and the port's copy of the
    packing."""
    rcfg, tcfg, rp, _ = _params()
    rsp = RDP.compress(rcfg, rp, target_sparsity=0.5, tile=TILE,
                       uniform=True)
    rb, tb = _batch(2, 10, seed=6)
    want = REngine(rcfg, rsp, RServeConfig(max_new_tokens=8),
                   fns=RDP.model_fns(rcfg)).generate(rb)
    return rcfg, tcfg, rsp, rb, tb, np.asarray(want)


def test_compressed_loop_equals_scan_and_reference(compressed, tmp_path):
    """A reference-written f32 artifact holding ``mm_proj`` boots in the
    port; Engine on the loop runtime (``deployed.model_fns``) and on the
    scan runtime (``stacked.model_fns``) give the same tokens bit for bit,
    and the reference's."""
    rcfg, tcfg, rsp, _, tb, want = compressed
    path = str(tmp_path / "ref")
    RDP.save_artifact(path, rsp, rcfg, extra={"compressed": True})
    tsp, extra = TDP.load_artifact(path, arch=rcfg.name, tile=TILE,
                                   device="cpu")
    assert extra["family"] == "vlm"
    np.testing.assert_array_equal(tsp.mm_proj.numpy(),
                                  np.asarray(rsp.mm_proj))
    assert isinstance(tsp.mm_proj, torch.Tensor)  # kept in float
    scfg = ServeConfig(max_new_tokens=8)
    loop = Engine(tcfg, tsp, scfg, fns=TDP.model_fns(tcfg)).generate(tb)
    sxp = TST.stack(tsp)
    assert sxp.mm_proj is tsp.mm_proj
    scan = Engine(tcfg, sxp, scfg, fns=TST.model_fns(tcfg)).generate(tb)
    np.testing.assert_array_equal(loop, scan)
    np.testing.assert_array_equal(loop, want)


def test_port_artifact_boots_in_the_reference(compressed, tmp_path):
    """The port compresses the same weights, saves the artifact with
    ``mm_proj``; the reference boots it and serves the same tokens on its
    loop and scan runtimes."""
    rcfg, tcfg, _, rb, _, want = compressed
    _, _, _, tp = _params()
    tsp = TDP.compress(tcfg, tp, target_sparsity=0.5, tile=TILE,
                       uniform=True)
    path = str(tmp_path / "port")
    TDP.save_artifact(path, tsp, tcfg, extra={"compressed": True})
    back, extra = RDP.load_artifact(path, arch=rcfg.name, tile=TILE)
    assert extra["family"] == "vlm" and back.mm_proj is not None
    got = REngine(rcfg, back, RServeConfig(max_new_tokens=8),
                  fns=RDP.model_fns(rcfg)).generate(rb)
    np.testing.assert_array_equal(np.asarray(got), want)
    got = REngine(rcfg, RST.stack(back), RServeConfig(max_new_tokens=8),
                  fns=RST.model_fns(rcfg)).generate(rb)
    np.testing.assert_array_equal(np.asarray(got), want)


def test_batch_server_refuses_vlm(compressed):
    """As the reference's: its requests carry no patch embeddings."""
    _, tcfg, _, _, _, _ = compressed
    _, _, _, tp = _params()
    with pytest.raises(NotImplementedError, match="patch embeddings"):
        BatchServer(tcfg, TDP.from_params(tcfg, tp), device="cpu")


@pytest.mark.parametrize("extra", [[], ["--compressed", "--tile", "16x16",
                                        "--runtime", "scan"]],
                         ids=["dense", "compressed-scan"])
def test_cli_legacy_tokens_equal_reference_cli(monkeypatch, capsys, extra):
    """``--engine legacy`` on the smoke config: the stub patches come from
    the CLI's numpy stream after the tokens, so the port's CLI (the
    reference's weights carried across in place of its own seeded init)
    prints the reference CLI's tokens, dense and compressed."""
    argv = ["--arch", ARCH, "--smoke", "--engine", "legacy", "--batch", "2",
            "--new-tokens", "6", *extra]
    RSERVE.main(argv)
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("   [")]
    _, _, _, tp = _params()
    monkeypatch.setattr(TSERVE, "_init_params", lambda cfg, seed, dev: tp)
    out = TSERVE.main(argv + ["--device", "cpu"])
    got = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("   [")]
    assert len(want) == 2 and got == want
    assert out.shape == (2, 6)
