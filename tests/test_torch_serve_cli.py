"""The port's serving CLI (``repro_torch.launch.serve``) booting an
artifact that the reference wrote, against the reference's own tokens.

The reference packs the smoke yi-6b in f32 (``compress(tile=(16, 16))``,
as its CLI does with ``--tile``) and saves it; its tokens come from one
``BatchServer(engine="loop")`` run over the CLI's trace and one ``Engine``
over ``deployed.model_fns`` for the legacy path (the reference holds loop =
scan = static itself, with its Pallas kernels in interpret mode). The
port's ``main`` boots that artifact on the CPU with every runtime and
engine and must give the same greedy tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.launch import serve as RSERVE
from repro.models import registry as RR
from repro.serve import deployed as RDP
from repro.serve.engine import Engine as REngine
from repro.serve.engine import ServeConfig as RServeConfig
from repro.serve.server import BatchConfig as RBatchConfig
from repro.serve.server import BatchServer as RBatchServer
from repro_torch.launch import serve as TSERVE
from repro_torch.models import registry as TR

# the CLI's defaults (--prompt-len 16, --slots 4, --block-size 8,
# --kv-blocks 64, --seed 0) with a short trace
N_REQ, N_NEW, BATCH = 4, 8, 2


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """(artifact path, reference batch tokens, reference legacy tokens)."""
    cfg = RR.get_smoke_config("yi-6b", dtype="float32")
    params = RR.model_fns(cfg).init_params(cfg, jax.random.PRNGKey(0))
    sp = RDP.compress(cfg, params, target_sparsity=0.5, tile=(16, 16))
    path = str(tmp_path_factory.mktemp("artifact"))
    RDP.save_artifact(path, sp, cfg, extra={"compressed": True})
    trace = RSERVE.synthetic_trace(cfg, N_REQ, 16, N_NEW, seed=0)
    rep = RBatchServer(cfg, sp, RServeConfig(seed=0),
                       RBatchConfig(n_slots=4, block_size=8, n_blocks=64),
                       engine="loop").run(trace)
    rng = np.random.default_rng(0)
    toks = jnp.asarray(rng.integers(0, cfg.vocab, (BATCH, 16)), jnp.int32)
    legacy = REngine(cfg, sp, RServeConfig(max_new_tokens=N_NEW),
                     fns=RDP.model_fns(cfg)).generate({"tokens": toks})
    return path, rep.outputs, np.asarray(legacy)


def _argv(path, *extra):
    return ["--arch", "yi-6b", "--smoke", "--compressed", "--artifact", path,
            "--requests", str(N_REQ), "--new-tokens", str(N_NEW),
            "--device", "cpu", *extra]


@pytest.mark.parametrize("engine", ["batch", "static"])
@pytest.mark.parametrize("runtime", ["loop", "scan"])
def test_batch_engines_boot_reference_artifact(reference, engine, runtime,
                                               capsys):
    path, want, _ = reference
    rep = TSERVE.main(_argv(path, "--engine", engine, "--runtime", runtime))
    assert "no re-packing" in capsys.readouterr().out
    assert sorted(rep.outputs) == sorted(want)
    for rid, toks in want.items():
        np.testing.assert_array_equal(rep.outputs[rid], toks, err_msg=rid)


@pytest.mark.parametrize("runtime", ["loop", "scan"])
def test_legacy_engine_boots_reference_artifact(reference, runtime):
    path, _, want = reference
    out = TSERVE.main(_argv(path, "--engine", "legacy", "--runtime", runtime,
                            "--batch", str(BATCH)))
    np.testing.assert_array_equal(out, want)


def test_traces_equal_reference():
    rcfg = RR.get_smoke_config("yi-6b")
    tcfg = TR.get_smoke_config("yi-6b")
    pairs = [(RSERVE.synthetic_trace(rcfg, 9, 40, 24, seed=3),
              TSERVE.synthetic_trace(tcfg, 9, 40, 24, seed=3)),
             (RSERVE.prefix_skew_trace(rcfg, 12, 16, 4, 6, seed=1),
              TSERVE.prefix_skew_trace(tcfg, 12, 16, 4, 6, seed=1))]
    for want, got in pairs:
        assert len(got) == len(want)
        for r, t in zip(want, got):
            assert (t.rid, t.max_new_tokens) == (r.rid, r.max_new_tokens)
            np.testing.assert_array_equal(t.prompt, np.asarray(r.prompt))


def test_pack_save_then_boot_gives_the_same_tokens(tmp_path, capsys):
    """Without an artifact the CLI packs from its own seeded init and saves;
    the next run boots it and serves the same tokens; the prefix-cache
    parity audit holds."""
    argv = ["--arch", "yi-6b", "--smoke", "--compressed", "--tile", "16x16",
            "--artifact", str(tmp_path), "--requests", "3", "--new-tokens",
            "4", "--device", "cpu"]
    first = TSERVE.main(argv)
    assert "packed + saved" in capsys.readouterr().out
    second = TSERVE.main(argv + ["--runtime", "scan", "--shared-prefix", "8",
                                 "--prefix-parity-check"])
    out = capsys.readouterr().out
    assert "no re-packing" in out and '"tokens_match_unshared": true' in out
    third = TSERVE.main(argv + ["--runtime", "scan"])
    for rid, toks in first.outputs.items():
        np.testing.assert_array_equal(third.outputs[rid], toks)
    assert second.prefix["hits"] >= 1


def test_ssm_family_falls_back_to_engine(capsys):
    out = TSERVE.main(["--arch", "mamba2-780m", "--smoke", "--batch", "2",
                       "--prompt-len", "8", "--new-tokens", "3", "--device",
                       "cpu"])
    assert out.shape == (2, 3)
    assert "falling back to the legacy Engine" in capsys.readouterr().out


def test_compressed_without_tile_exits_with_message():
    with pytest.raises(SystemExit, match="--tile BKxBN"):
        TSERVE.main(["--arch", "yi-6b", "--smoke", "--compressed",
                     "--device", "cpu"])


@pytest.mark.parametrize("flag", [["--spec", "k=4"], ["--mesh", "macro=2"],
                                  ["--gateway", "t.json"], ["--autotune", "2"],
                                  ["--parity-check"]])
def test_unported_flag_exits_2(flag):
    with pytest.raises(SystemExit) as e:
        TSERVE.main(["--arch", "yi-6b", "--smoke", "--device", "cpu", *flag])
    assert e.value.code == 2


def test_default_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        TSERVE.main(["--arch", "yi-6b", "--smoke"])
