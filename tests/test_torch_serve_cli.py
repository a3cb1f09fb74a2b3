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
import json

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
from repro_torch.serve import deployed as TDP

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


@pytest.fixture(scope="module")
def schedule_reference(tmp_path_factory):
    """The reference's documented compressed form: the smoke yi-6b packed
    with ``default_schedule``'s per-projection tiles (no ``--tile``),
    saved, and its tokens over the CLI's trace."""
    cfg = RR.get_smoke_config("yi-6b", dtype="float32")
    params = RR.model_fns(cfg).init_params(cfg, jax.random.PRNGKey(0))
    sched = RDP.default_schedule(cfg)
    sp = RDP.compress(cfg, params, target_sparsity=0.5, schedule=sched)
    path = str(tmp_path_factory.mktemp("schedule-artifact"))
    RDP.save_artifact(path, sp, cfg, extra={"compressed": True})
    trace = RSERVE.synthetic_trace(cfg, N_REQ, 16, N_NEW, seed=0)
    rep = RBatchServer(cfg, sp, RServeConfig(seed=0),
                       RBatchConfig(n_slots=4, block_size=8, n_blocks=64),
                       engine="loop").run(trace)
    tiles = {name: dw.tile for name, dw in sp.deployed().items()}
    return path, rep.outputs, tiles


def test_compressed_without_tile_packs_the_reference_schedule(
        schedule_reference, tmp_path, capsys):
    """``--compressed`` with no ``--tile`` runs ``default_schedule`` and
    packs every projection (the head by the fallback) with the reference's
    tile for it."""
    _, _, want = schedule_reference
    rep = TSERVE.main(["--arch", "yi-6b", "--smoke", "--compressed",
                       "--artifact", str(tmp_path), "--requests", "2",
                       "--new-tokens", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "schedule: searched 14 projections" in out
    assert rep.n_requests == 2
    sp, _, _ = TDP.load_artifact_tiers(str(tmp_path), device="cpu")
    assert {name: dw.tile for name, dw in sp.deployed().items()} == want


@pytest.mark.parametrize("runtime", ["loop", "scan"])
def test_boot_reference_schedule_artifact_gives_its_tokens(
        schedule_reference, runtime, capsys):
    path, want, tiles = schedule_reference
    rep = TSERVE.main(_argv(path, "--runtime", runtime))
    assert "no re-packing" in capsys.readouterr().out
    assert sorted(rep.outputs) == sorted(want)
    for rid, toks in want.items():
        np.testing.assert_array_equal(rep.outputs[rid], toks, err_msg=rid)


def test_autotune_packs_persists_and_boot_hits_the_cache(tmp_path, capsys,
                                                         monkeypatch):
    """``--autotune 2`` on a fresh pack times the reference's top-2
    simulated tiles (on the CPU: the plain version), packs uniform with the
    winner and stores the cache; a boot reports a hit and never re-times."""
    from repro.sched import autotune as RAT
    from repro_torch.sched import autotune as TAT
    argv = ["--arch", "yi-6b", "--smoke", "--compressed", "--autotune", "2",
            "--artifact", str(tmp_path), "--requests", "2", "--new-tokens",
            "3", "--device", "cpu", "--runtime", "scan"]
    first = TSERVE.main(argv)
    out = capsys.readouterr().out
    sim = RAT.autotune(RR.get_smoke_config("yi-6b", dtype="float32"),
                       top_n=2, target_sparsity=0.5,
                       allow_measure=False).simulated_tile
    assert f"(simulated pick {sim[0]}x{sim[1]})" in out
    assert "on torch-cpu" in out and out.count("autotune:   tile") == 2
    extra = TDP.load_artifact_extra(str(tmp_path))
    cache = TAT.AutotuneCache.from_json(extra["autotune"])
    key = TAT.autotune_key(TR.get_smoke_config("yi-6b"), "torch-cpu")
    best = tuple(cache.get(key)["best_tile"])
    assert tuple(extra["autotune_tile"]) == best
    sp, _, _ = TDP.load_artifact_tiers(str(tmp_path), device="cpu")
    assert len(TDP.packed_tiles(sp)) == 1  # uniform
    monkeypatch.setattr(TAT, "measure_tile", lambda *a, **k: pytest.fail(
        "a boot re-timed"))
    second = TSERVE.main(argv)
    out = capsys.readouterr().out
    assert f"autotune: cache hit ({best[0]}x{best[1]}, measured on " \
        "torch-cpu)" in out and "no re-packing" in out
    for rid, toks in first.outputs.items():
        np.testing.assert_array_equal(second.outputs[rid], toks)


def test_autotune_boot_of_an_untuned_artifact_says_so(reference, capsys):
    path, _, _ = reference
    TSERVE.main(_argv(path, "--autotune", "2", "--requests", "1",
                      "--new-tokens", "2"))
    assert "artifact carries no autotune cache" in capsys.readouterr().out


def _decision(out):
    line = next(ln for ln in out.splitlines()
                if ln.startswith("spec auto: {"))
    return json.loads(line[len("spec auto: "):])


def test_spec_auto_uncalibrated_declines_and_serves_scan(tmp_path, capsys):
    """Uncalibrated at smoke size the reference's decision is "declined"
    (scan wins); the run then serves the scan engine, with the tokens of a
    plain scan run."""
    from repro.sched import search_spec
    argv = ["--arch", "yi-6b", "--smoke", "--compressed", "--tile", "16x16",
            "--artifact", str(tmp_path), "--requests", "3", "--new-tokens",
            "4", "--device", "cpu"]
    plain = TSERVE.main(argv + ["--runtime", "scan"])
    capsys.readouterr()
    auto = TSERVE.main(argv + ["--spec", "auto"])
    out = capsys.readouterr().out
    want = search_spec(RR.get_smoke_config("yi-6b", dtype="float32"),
                       target_sparsity=0.5, arch="yi-6b-smoke").decision
    assert _decision(out) == want and want["verdict"] == "declined"
    assert "runtime: scan" in out and auto.spec is None
    for rid, toks in plain.outputs.items():
        np.testing.assert_array_equal(auto.outputs[rid], toks)


def test_spec_run_persists_acceptance_and_auto_reads_it(tmp_path, capsys):
    """An explicit reprune run folds its measured acceptance into the
    manifest; a following ``--spec auto`` loads it, prices the reprune
    candidates with it (``calibrated``) and prints the reference's
    decision for that calibration."""
    from repro.sched.search import SpecCalibration as RCal
    from repro.sched.search import search_spec
    argv = ["--arch", "yi-6b", "--smoke", "--compressed", "--tile", "16x16",
            "--artifact", str(tmp_path), "--requests", "3", "--new-tokens",
            "4", "--device", "cpu"]
    rep = TSERVE.main(argv + ["--spec", "k=2,draft_sparsity=0.9"])
    assert "persisted to the artifact manifest" in capsys.readouterr().out
    stored = TDP.load_artifact_extra(str(tmp_path))["spec_calibration"]
    assert len(stored["rows"]) == 1
    row = stored["rows"][0]
    assert (row["family"], row["gap"]) == ("reprune", pytest.approx(0.4))
    assert row["accept"] == rep.spec["acceptance_rate"]
    TSERVE.main(argv + ["--spec", "auto"])
    out = capsys.readouterr().out
    assert "loaded acceptance calibration (1 measured row(s))" in out
    res = search_spec(RR.get_smoke_config("yi-6b", dtype="float32"),
                      target_sparsity=0.5, arch="yi-6b-smoke",
                      calibration=RCal.from_json(stored))
    assert _decision(out) == res.decision
    assert {r["accept_source"] for r in res.table
            if r["family"] == "reprune"} == {"calibrated"}


@pytest.mark.parametrize("flag", [["--profile", "p"], ["--mesh", "macro=2"],
                                  ["--gateway", "t.json"],
                                  ["--parity-check"]])
def test_unported_flag_exits_2(flag):
    with pytest.raises(SystemExit) as e:
        TSERVE.main(["--arch", "yi-6b", "--smoke", "--device", "cpu", *flag])
    assert e.value.code == 2


def test_default_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        TSERVE.main(["--arch", "yi-6b", "--smoke"])
