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
import os
import re

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


@pytest.mark.parametrize("tile", [["--tile", "16x16"], []],
                         ids=["tile", "schedule"])
def test_moe_reference_cli_artifact_serves_its_tokens(tmp_path, capsys,
                                                      tile):
    """The reference CLI packs the phi3.5-moe smoke config (with a tile,
    and with its schedule search's tiles) into an artifact and prints its
    first tokens; the port's CLI boots that artifact on both runtimes and
    serves the same tokens."""
    argv = ["--arch", "phi3.5-moe-42b-a6.6b", "--smoke", "--compressed",
            *tile, "--artifact", str(tmp_path), "--requests", str(N_REQ),
            "--new-tokens", str(N_NEW)]
    RSERVE.main(argv)
    out = capsys.readouterr().out
    want = {m.group(1): json.loads(m.group(2))
            for m in re.finditer(r"^  (\S+): (\[.*\])$", out, re.M)}
    assert len(want) == 3
    for runtime in ("loop", "scan"):
        rep = TSERVE.main(argv + ["--device", "cpu", "--runtime", runtime])
        assert "no re-packing" in capsys.readouterr().out
        for rid, toks in want.items():
            np.testing.assert_array_equal(rep.outputs[rid], toks,
                                          err_msg=rid)


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


def _runtime_line(out):
    return next(ln for ln in out.splitlines() if ln.startswith("runtime:"))


def test_spec_auto_uncalibrated_declines_and_serves_scan(tmp_path, capsys):
    """Uncalibrated at smoke size the reference's decision is "declined"
    (scan wins); with ``--runtime scan`` the run then serves the scan
    engine, as the reference serves ``--runtime``, with the tokens of a
    plain scan run."""
    from repro.sched import search_spec
    argv = ["--arch", "yi-6b", "--smoke", "--compressed", "--tile", "16x16",
            "--artifact", str(tmp_path), "--requests", "3", "--new-tokens",
            "4", "--device", "cpu", "--runtime", "scan"]
    plain = TSERVE.main(argv)
    capsys.readouterr()
    auto = TSERVE.main(argv + ["--spec", "auto"])
    out = capsys.readouterr().out
    want = search_spec(RR.get_smoke_config("yi-6b", dtype="float32"),
                       target_sparsity=0.5, arch="yi-6b-smoke").decision
    assert _decision(out) == want and want["verdict"] == "declined"
    assert _runtime_line(out).startswith("runtime: scan (")
    assert auto.spec is None
    for rid, toks in plain.outputs.items():
        np.testing.assert_array_equal(auto.outputs[rid], toks)


def test_spec_auto_declined_serves_the_default_runtime_as_the_reference(
        reference, capsys):
    """Without ``--runtime`` a declined ``--spec auto`` serves the loop
    runtime, as the reference's CLI does on the same artifact: the same
    ``runtime:`` line and the reference's loop tokens."""
    path, ref_tokens, _ = reference
    argv = _argv(path, "--spec", "auto")
    RSERVE.main([a for a in argv if a not in ("--device", "cpu")])
    ref_out = capsys.readouterr().out
    auto = TSERVE.main(argv)
    out = capsys.readouterr().out
    assert _decision(out) == _decision(ref_out)
    assert _decision(out)["verdict"] == "declined"
    assert _runtime_line(out) == _runtime_line(ref_out) == \
        "runtime: loop (python loop over per-layer weights)"
    assert auto.spec is None
    for rid, toks in ref_tokens.items():
        np.testing.assert_array_equal(auto.outputs[rid], np.asarray(toks))


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


def _tenants_json(tmp_path, **gateway):
    """Two tenants of the smoke yi-6b, packed at 16x16 from seeds 0 and 1,
    priorities 1 and 0, three requests each."""
    spec = {"tenants": [
        {"name": "acme", "arch": "yi-6b", "seed": 0, "compressed": True,
         "tile": "16x16", "priority": 1, "requests": 3},
        {"name": "bolt", "arch": "yi-6b", "seed": 1, "compressed": True,
         "tile": "16x16", "priority": 0, "requests": 3}],
        "gateway": gateway}
    path = tmp_path / "tenants.json"
    path.write_text(json.dumps(spec))
    return str(path)


GATEWAY = ["--smoke", "--new-tokens", "4", "--device", "cpu"]
SERVE = ["--arch", "yi-6b", "--smoke", "--compressed", "--tile", "16x16",
         "--requests", "3", "--new-tokens", "4", "--device", "cpu"]


def _flag_profile(tmp_path):
    out = str(tmp_path / "prof")
    return SERVE + ["--runtime", "scan", "--profile", out], out


def _flag_max_pending(tmp_path):
    return ["--gateway", _tenants_json(tmp_path), "--max-pending", "4",
            *GATEWAY], None


def _flag_gateway(tmp_path):
    return ["--gateway", _tenants_json(tmp_path), *GATEWAY], None


def _flag_parity_check(tmp_path):
    return SERVE + ["--spec", "draft=layerskip,keep=0.5,k=2",
                    "--parity-check"], None


@pytest.mark.parametrize("flag", [_flag_profile, _flag_max_pending,
                                  _flag_gateway, _flag_parity_check],
                         ids=["profile", "max-pending", "gateway",
                              "parity-check"])
def test_reference_flag_runs(flag, tmp_path, capsys):
    """Each of the reference's flags that argparse refused before the
    gateway slice, through ``main`` on the CPU, does what the reference's
    does: --profile writes a torch.profiler Chrome trace, --max-pending
    sheds the lowest priority (counted), --gateway serves both tenants,
    --parity-check audits the spec run against target-only scan."""
    argv, prof = flag(tmp_path)
    rep = TSERVE.main(argv)
    out = capsys.readouterr().out
    if flag is _flag_profile:
        assert f"profile: torch.profiler trace -> {prof}" in out
        with open(os.path.join(prof, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
        # the measured run's operators (on the card, its kernels too)
        assert any(str(e.get("name", "")).startswith("aten::")
                   for e in events)
    elif flag is _flag_max_pending:
        sheds = re.findall(r"gateway: shed rid=(\S+) tenant=(\S+) "
                           r"priority=(\d+) reason=(\S+)", out)
        assert len(sheds) == 2 == rep.admission["n_shed"]
        assert {(t, p, r) for _, t, p, r in sheds} == {
            ("bolt", "0", "queue_overflow")}
        assert len(rep.per_tenant["acme"].outputs) == 3
    elif flag is _flag_gateway:
        assert sorted(rep.per_tenant) == ["acme", "bolt"]
        assert all(len(r.outputs) == 3 for r in rep.per_tenant.values())
        assert '"n_shed": 0' in out
    else:
        assert '"tokens_match_target": true' in out


def test_gateway_parity_check_two_tenants(tmp_path, capsys):
    """--gateway with --gateway-parity-check: both tenants' tokens equal a
    dedicated scan server's; --arch is not needed with --gateway (and is
    without it)."""
    rep = TSERVE.main(["--gateway", _tenants_json(tmp_path),
                       "--gateway-parity-check", *GATEWAY])
    out = capsys.readouterr().out
    for name in ("acme", "bolt"):
        assert f"gateway: tenant={name} tokens_match_dedicated=True" in out
    assert rep.tenant_meta["acme"]["compiles"] == 1
    with pytest.raises(SystemExit) as e:
        TSERVE.main(["--smoke", "--device", "cpu"])
    assert e.value.code == 2


def test_gateway_prefill_chunk(tmp_path, capsys):
    """--prefill-chunk 4 (and the tenants.json knob) serves the same tokens
    as the unchunked gateway, and the parity audit holds."""
    path = _tenants_json(tmp_path)
    whole = TSERVE.main(["--gateway", path, *GATEWAY])
    chunked = TSERVE.main(["--gateway", path, "--prefill-chunk", "4",
                           "--gateway-parity-check", *GATEWAY])
    assert capsys.readouterr().out.count("tokens_match_dedicated=True") == 2
    knob = TSERVE.main(["--gateway", _tenants_json(tmp_path,
                                                   prefill_chunk=4),
                        *GATEWAY])
    for name in ("acme", "bolt"):
        for rid, toks in whole.per_tenant[name].outputs.items():
            np.testing.assert_array_equal(
                chunked.per_tenant[name].outputs[rid], toks)
            np.testing.assert_array_equal(
                knob.per_tenant[name].outputs[rid], toks)


def test_default_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        TSERVE.main(["--arch", "yi-6b", "--smoke"])
