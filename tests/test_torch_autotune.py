"""The port's measured-latency tile autotuner (``sched/autotune.py``)
against the reference's, in one process, on the CPU at smoke size.

The workload signature, the shortlist and the simulated pick are numpy on
both sides and must be equal; the cache's JSON reads both ways. The
backend is part of the cache key, and the port's (``torch-cuda`` /
``torch-cpu``) never equals the reference's (``jax.default_backend()``),
so an entry the reference wrote is a MISS here. On the CPU
``measure_tile`` times the kernel's plain version (no launch is counted);
the ``cuda`` case times the kernel itself on the card and skips without
one. The reference (and so JAX) is imported only by the tests that
compare against it.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.core import perf_model as TPM
from repro_torch.kernels import cim_bsr_matmul as K
from repro_torch.kernels.timing import DispatchTimer
from repro_torch.models import registry as TR
from repro_torch.sched import autotune as TAT
from repro_torch.serve import deployed as TDP

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

SMALL = dict(prefill_rows=8, decode_rows=2, repeats=1)


@pytest.fixture(scope="module")
def cfg():
    return TR.get_smoke_config("yi-6b", dtype="float32")


@pytest.fixture(scope="module")
def R():
    """(reference autotune module, reference smoke config)."""
    import jax  # noqa: F401
    from repro.models import registry as RR
    from repro.sched import autotune as RAT
    return RAT, RR.get_smoke_config("yi-6b", dtype="float32")


@pytest.fixture(scope="module")
def tuned(cfg):
    """One autotune pass on the CPU (the plain version timed)."""
    cache = TAT.AutotuneCache()
    res = TAT.autotune(cfg, top_n=3, target_sparsity=0.5, cache=cache,
                       device="cpu", **SMALL)
    return res, cache


def test_projection_shapes_and_key_match(R, cfg):
    RAT, rcfg = R
    assert TAT.projection_shapes(cfg) == RAT.projection_shapes(rcfg)
    from repro.models import registry as RR
    assert TAT.projection_shapes(TR.get_config("yi-6b")) == \
        RAT.projection_shapes(RR.get_config("yi-6b"))
    for b in ("cpu", "tpu", "torch-cuda"):
        assert TAT.autotune_key(cfg, b) == RAT.autotune_key(rcfg, b)
    assert TAT.autotune_key(cfg, TAT.backend_name("cpu")).split("|")[1] == \
        "torch-cpu"
    # the reference's own key (its default backend) is never the port's
    assert RAT.autotune_key(rcfg) != TAT.autotune_key(cfg, "torch-cpu")
    assert RAT.autotune_key(rcfg) != TAT.autotune_key(cfg, "torch-cuda")


def test_backend_defaults_to_the_gpu(cfg, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        TAT.autotune_key(cfg)
    with pytest.raises(RuntimeError, match="GPU"):
        TAT.autotune(cfg, allow_measure=False)
    with pytest.raises(RuntimeError, match="GPU"):
        TAT.measure_tile([(64, 64, 1)], (16, 16), 0.5)


@pytest.mark.parametrize("top_n", [1, 3])
def test_offline_autotune_gives_the_reference_simulated_tile(R, cfg, top_n):
    RAT, rcfg = R
    t = TAT.autotune(cfg, top_n=top_n, allow_measure=False, device="cpu")
    r = RAT.autotune(rcfg, top_n=top_n, allow_measure=False)
    assert t.best_tile == t.simulated_tile == r.simulated_tile == r.best_tile
    assert t.table == [] and not t.cache_hit
    assert t.backend == "torch-cpu" and t.key.split("|")[1] == "torch-cpu"


def test_measured_shortlist_matches_reference(R, cfg, tuned):
    """The port times the reference's shortlist, in its order, with the
    reference's simulated numbers; the winner is never slower than the
    simulated pick on the timed workload."""
    RAT, rcfg = R
    res, _ = tuned
    ref_search = RAT.search_mapping(
        RAT.lm_graph(rcfg, seq_len=128, sparsity_gs=0.5), w_bits=rcfg.w_bits,
        a_bits=rcfg.a_bits, groups=(8, 16, 32), alphas=(8, 16, 32),
        uniform=True)
    ranked = sorted(ref_search.table, key=lambda r: r.fps, reverse=True)
    want = []
    for r in ranked:
        if r.candidate.tile not in [w[0] for w in want]:
            want.append((r.candidate.tile, round(r.fps, 2),
                         round(r.cycles, 1)))
    assert [(tuple(row["tile"]), row["sim_fps"], row["sim_cycles"])
            for row in res.table] == want[:3]
    assert res.simulated_tile == ref_search.best.candidate.tile
    by_tile = {tuple(r["tile"]): r["total_s"] for r in res.table}
    assert by_tile[res.best_tile] <= by_tile[res.simulated_tile]
    assert res.backend == "torch-cpu" and not res.cache_hit
    for row in res.table:
        assert row["backend"] == "torch-cpu"
        assert row["total_s"] == pytest.approx(row["prefill_s"]
                                               + row["decode_s"])


def test_measure_tile_runs_the_plain_version_on_cpu(R, cfg):
    """No kernel launch on the CPU; one fenced record per repeat and phase
    and shape; the samples' phase cycles equal the reference's."""
    RAT, rcfg = R
    shapes = TAT.projection_shapes(cfg)
    timer = DispatchTimer(enabled=True)
    K.reset_launches()
    row = TAT.measure_tile(shapes, (16, 32), 0.5, timer=timer, device="cpu",
                           prefill_rows=8, decode_rows=2, repeats=2)
    assert K.LAUNCHES == 0
    assert len(timer.records) == 2 * 2 * len(shapes)
    assert {r.backend for r in timer.records} == {"cpu"}
    assert {r.name for r in timer.records} == {"autotune.prefill",
                                               "autotune.decode"}
    assert row["tile"] == [16, 32] and row["backend"] == "torch-cpu"
    ref = RAT.measure_tile(RAT.projection_shapes(rcfg), (16, 32), 0.5,
                           prefill_rows=8, decode_rows=2, repeats=1)
    assert [(s["shape"], s["phases"]) for s in row["samples"]] == [
        (s["shape"], s["phases"]) for s in ref["samples"]]
    assert all(s["measured_s"] > 0 for s in row["samples"])


def test_measure_tile_packs_the_reference_weights(R, cfg):
    """The synthetic weights: the same numpy draws, the port's
    prune_mask_2d, the same packing as the reference's."""
    import jax.numpy as jnp
    from repro.core.sparsity import prune_mask_2d as r_prune
    from repro.kernels import ops as r_ops
    from repro_torch.core.sparsity import prune_mask_2d as t_prune
    from repro_torch.kernels import ops as t_ops
    rng_t, rng_r = np.random.default_rng(0), np.random.default_rng(0)
    for d_in, d_out in ((64, 96), (96, 64)):
        w = rng_t.standard_normal((d_in, d_out)).astype(np.float32) * 0.05
        wr = rng_r.standard_normal((d_in, d_out)).astype(np.float32) * 0.05
        tw = torch.from_numpy(w) * t_prune(torch.from_numpy(w), 16, 32, 0.5)
        rw = wr * np.asarray(r_prune(jnp.asarray(wr), 16, 32, 0.5))
        tp = t_ops.pack_for_kernel(tw, bits=8, bk=16, bn=32)
        rp = r_ops.pack_for_kernel(rw, bits=8, bk=16, bn=32)
        for k in ("blocks", "scales", "row_idx", "nnz"):
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(rp[k]))


def test_refit_from_table_matches_reference_on_the_same_samples(R, tuned):
    RAT, _ = R
    res, _ = tuned
    t = TAT.refit_from_table(res.table)
    r = RAT.refit_from_table(res.table)
    assert t.to_json() == r.to_json()
    assert t.n_samples == sum(len(row["samples"]) for row in res.table)


def test_cache_json_both_ways_and_reference_entries_miss(R, cfg, tuned):
    RAT, rcfg = R
    res, cache = tuned
    blob = json.loads(json.dumps(cache.to_json()))
    rc = RAT.AutotuneCache.from_json(blob)
    assert rc.to_json() == cache.to_json()
    # a reference-written entry, under the reference's own key
    rc.put(RAT.autotune_key(rcfg), RAT.AutotuneResult(
        (8, 8), (8, 8), [], False, RAT.autotune_key(rcfg), "cpu"))
    back = TAT.AutotuneCache.from_json(json.loads(json.dumps(rc.to_json())))
    assert back.to_json() == rc.to_json()
    only_ref = TAT.AutotuneCache.from_json(json.loads(json.dumps(
        {"schema": 1, "entries": {RAT.autotune_key(rcfg):
                                  rc.get(RAT.autotune_key(rcfg))}})))
    for dev in ("cpu",):
        key = TAT.autotune_key(cfg, TAT.backend_name(dev))
        assert only_ref.get(key) is None
        hit = back.get(key)
        assert hit is not None and tuple(hit["best_tile"]) == res.best_tile
    assert res.to_json()["table"] and "samples" not in res.to_json()["table"][0]
    for bad in ([], {"schema": 2, "entries": {}},
                {"schema": 1, "entries": []},
                {"schema": 1, "entries": {"k": {"best_tile": [0, 8]}}}):
        with pytest.raises(ValueError):
            TAT.AutotuneCache.from_json(bad)


def test_cache_hit_skips_timing_and_miss_measures(cfg, tuned, monkeypatch):
    res, cache = tuned
    calls = []
    monkeypatch.setattr(TAT, "measure_tile",
                        lambda *a, **k: calls.append(1) or {})
    hit = TAT.autotune(cfg, top_n=3, target_sparsity=0.5, cache=cache,
                       device="cpu")
    assert hit.cache_hit and hit.best_tile == res.best_tile
    assert hit.table == [] and calls == []
    miss = TAT.autotune(cfg, top_n=3, target_sparsity=0.5,
                        cache=TAT.AutotuneCache(), allow_measure=False,
                        device="cpu")
    assert not miss.cache_hit and miss.best_tile == res.simulated_tile
    assert calls == []


def test_cache_round_trips_through_the_artifact(tmp_path, cfg, tuned):
    from repro_torch.models.transformer import init_params
    res, cache = tuned
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    sp = TDP.compress(cfg, params, target_sparsity=0.5, tile=res.best_tile,
                      uniform=True)
    TDP.save_artifact(str(tmp_path), sp, cfg,
                      extra={"autotune": cache.to_json(),
                             "autotune_tile": list(res.best_tile)})
    extra = TDP.load_artifact_extra(str(tmp_path))
    back = TAT.AutotuneCache.from_json(extra["autotune"])
    assert back.get(res.key)["best_tile"] == list(res.best_tile)
    assert tuple(extra["autotune_tile"]) == res.best_tile


def test_measured_samples_feed_the_refit(tuned):
    res, _ = tuned
    fit = TAT.refit_from_table(res.table)
    assert fit.n_samples == sum(len(r["samples"]) for r in res.table)
    assert np.isfinite(fit.residual) and fit.hw.cim_freq > 0
    ph = res.table[0]["samples"][0]["phases"]
    assert fit.predict_seconds(ph) == pytest.approx(
        TPM.phase_features(ph)[0] * fit.seconds_per_cycle["mac"]
        + ph["reload"] * fit.seconds_per_cycle["reload"]
        + ph["ctrl"] * fit.seconds_per_cycle["ctrl"])


@pytest.mark.cuda
def test_measure_tile_times_the_kernel_on_gpu():
    """On the card every timed call is a kernel launch (none falls back to
    the plain version), at an aligned and at a masked (bn = 8) tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    shapes = [(4096, 512, 1), (11008, 4096, 1)]
    for tile, path in (((32, 32), "aligned"), ((16, 8), "masked")):
        K.reset_launches()
        timer = DispatchTimer(enabled=True)
        row = TAT.measure_tile(shapes, tile, 0.6, timer=timer, repeats=2)
        # per shape and phase: one warm call and two timed ones
        assert K.LAUNCHES == 2 * 2 * 3
        assert K.LAUNCHES_BY_ENTRY["bsr_matmul_stacked"] == K.LAUNCHES
        assert sum(v for k, v in K.LAUNCHES_BY_PATH.items()
                   if k.endswith(path)) == K.LAUNCHES
        assert row["backend"] == "torch-cuda"
        assert {r.backend for r in timer.records} == {"cuda"}
        assert row["total_s"] > 0
