"""The port's MARS schedule search (``core/perf_model``, ``sched/``,
``obs/gap``, ``serve.deployed.default_schedule``/``compress(schedule=)``)
against the reference's, in one process.

The analytic model, the graphs, the allocator, the event simulator, the
mapping and speculative searches and the pricer are numpy on both sides,
so their results must be EQUAL, not close. Execution (``execute_layer``,
``verify_layer``) runs the port's plain versions on the CPU against the
reference's Pallas kernels in interpret mode, within 1e-5 of max |ref| in
f32; the port's own packing of the same float weights meets the bar of
``tests/test_torch_deploy.py`` (row_idx, nnz and scales equal, int8 levels
equal but for +-1 at eq. 8 half-levels). The ``cuda`` cases run the
block-sparse kernel on the card and skip without one; the reference (and
so JAX) is imported only by the tests that compare against it.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.core import mapping as TM
from repro_torch.core import perf_model as TPM
from repro_torch.models import registry as TR
from repro_torch.obs import gap as TGAP
from repro_torch import sched as TS
from repro_torch.sched import executor as TEX
from repro_torch.serve import deployed as TDP

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


@pytest.fixture(scope="module")
def R():
    """The reference's modules, imported on first use."""
    import jax  # noqa: F401  (the reference's numpy modules import it)
    from repro.core import deploy as D
    from repro.core import mapping as M
    from repro.core import perf_model as PM
    from repro.models import registry as RR
    from repro.obs import gap as GAP
    from repro import sched as S
    from repro.sched import executor as EX
    from repro.sched import pricing as PR
    from repro.serve import deployed as DP
    return dict(D=D, M=M, PM=PM, RR=RR, GAP=GAP, S=S, EX=EX, PR=PR, DP=DP)


def _dc(obj):
    """A dataclass (possibly nested, e.g. NetworkPerf) as plain data, so
    the reference's and the port's instances compare by value."""
    return dataclasses.asdict(obj)


def _graph_rows(g):
    return [(k, n.name, _dc(n.layer), tuple(n.deps), n.kind,
             None if n.weight is None else n.weight.tolist())
            for k, n in g.nodes.items()]


def _sim_rows(res):
    """Every field of a SimResult (cycles, fps, per-layer timings, the event
    list, hw, bits, busy total) and its summary."""
    return _dc(res), res.summary()


def _smoke(dtype="float32"):
    return TR.get_smoke_config("yi-6b", dtype=dtype)


# ---------------------------------------------------------------------------
# core: mapping (MARS part) and perf_model
# ---------------------------------------------------------------------------


def test_mapping_constants_and_index_codes_match(R):
    M = R["M"]
    for name in ("MACRO_BITS", "PARTITIONS", "WLGROUPS", "GROUP",
                 "MACROS_PER_CORE", "CORES"):
        assert getattr(TM, name) == getattr(M, name), name
    for code in (0, 1, 0x7FFF, 0x8000 | (17 << 9) | (5 << 5) | 9):
        assert TM.decode_index(code) == M.decode_index(code)
    assert TM.encode_index(1, 17, 5, 9) == M.encode_index(1, 17, 5, 9)


@pytest.mark.parametrize("alpha", [8, 16, 32])
def test_pack_groupsets_matches_reference(R, alpha):
    rng = np.random.default_rng(alpha)
    w = rng.standard_normal((72, 100)).astype(np.float32)
    w[rng.random(w.shape) < 0.3] = 0.0
    w[:32, 16:48] = 0.0  # whole zero group-sets
    t, r = TM.pack_groupsets(w, alpha=alpha), R["M"].pack_groupsets(
        w, alpha=alpha)
    for f in ("blocks", "codes", "spatial_pos", "channel_pos"):
        np.testing.assert_array_equal(getattr(t, f), getattr(r, f), f)
    for f in ("n_total_groupsets", "capacity_groupsets", "reloads", "nnz",
              "index_bits", "weight_bits_8b"):
        assert getattr(t, f) == getattr(r, f), f
    np.testing.assert_array_equal(
        TM.unpack_groupsets(t, 72, 100, alpha=alpha), w)


@pytest.mark.parametrize("net", ["vgg16", "resnet18"])
@pytest.mark.parametrize("bits", [(8, 4), (8, 8), (4, 4)])
def test_summarize_and_phase_cycles_match(R, net, bits):
    PM = R["PM"]
    w_bits, a_bits = bits
    tl = getattr(TPM, f"{net}_cifar_layers")()
    rl = getattr(PM, f"{net}_cifar_layers")()
    assert [_dc(l) for l in tl] == [_dc(l) for l in rl]
    hw = dict(group=32, alpha=8)
    for thw, rhw in ((TPM.DEFAULT_HW, PM.DEFAULT_HW),
                     (dataclasses.replace(TPM.DEFAULT_HW, **hw),
                      dataclasses.replace(PM.DEFAULT_HW, **hw))):
        assert _dc(TPM.summarize(tl, w_bits, a_bits, hw=thw)) == _dc(
            PM.summarize(rl, w_bits, a_bits, hw=rhw))
        for sparse in (True, False):
            assert TPM.network_phase_breakdown(
                tl, w_bits, a_bits, sparse, thw) == PM.network_phase_breakdown(
                rl, w_bits, a_bits, sparse, rhw)
            for t, r in zip(tl, rl):
                assert TPM.layer_phase_cycles(
                    t, w_bits, a_bits, sparse, thw) == PM.layer_phase_cycles(
                    r, w_bits, a_bits, sparse, rhw)


def test_fit_cycle_constants_matches(R):
    PM = R["PM"]
    rng = np.random.default_rng(3)
    layers = TPM.vgg16_cifar_layers()
    samples = []
    for l in layers:
        ph = TPM.layer_phase_cycles(l)
        secs = (max(ph["compute"], ph["fm"]) * 2e-8 + ph["reload"] * 5e-9
                + ph["ctrl"] * 1e-7) * float(rng.uniform(0.9, 1.1))
        samples.append((ph, secs))
    for sub in (samples, samples[:2], [(dict(compute=5.0), 1e-6)] * 4):
        t, r = TPM.fit_cycle_constants(sub), PM.fit_cycle_constants(sub)
        assert t.to_json() == r.to_json()
        assert _dc(t.hw) == _dc(r.hw)
        assert t.predict_seconds(samples[0][0]) == r.predict_seconds(
            samples[0][0])
    with pytest.raises(ValueError):
        TPM.fit_cycle_constants([(dict(compute=1.0), float("nan"))])


def test_speculative_model_and_allgather_match(R):
    PM = R["PM"]
    for k in (1, 2, 4, 8):
        for a in (-0.1, 0.0, 0.3, 0.85, 1.0, 1.2):
            assert TPM.expected_spec_tokens(k, a) == PM.expected_spec_tokens(
                k, a)
            for steps in (None, k):
                assert TPM.speculative_summary(
                    1234.5, 9876.0, k, a, steps) == PM.speculative_summary(
                    1234.5, 9876.0, k, a, steps)
    for n_bytes, n_dev in ((0, 4), (1 << 20, 1), (1 << 20, 2), (3e6, 4)):
        assert TPM.DEFAULT_HW.allgather_cycles(
            n_bytes, n_dev) == PM.DEFAULT_HW.allgather_cycles(n_bytes, n_dev)


# ---------------------------------------------------------------------------
# sched: graphs, allocation, simulation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["vgg16", "resnet18", "lm-smoke", "lm-full",
                                   "lm-full-cut"])
def test_graphs_match_node_for_node(R, which):
    S = R["S"]
    if which.startswith("lm"):
        smoke = which == "lm-smoke"
        t_cfg = _smoke() if smoke else TR.get_config("yi-6b")
        r_cfg = (R["RR"].get_smoke_config("yi-6b", dtype="float32") if smoke
                 else R["RR"].get_config("yi-6b"))
        kw = dict(seq_len=64, sparsity_gs=0.6,
                  n_layers=4 if which.endswith("cut") else None)
        tg, rg = TS.lm_graph(t_cfg, **kw), S.lm_graph(r_cfg, **kw)
    else:
        tg, rg = getattr(TS, f"{which}_graph")(), getattr(S,
                                                         f"{which}_graph")()
    assert _graph_rows(tg) == _graph_rows(rg)
    assert tg.topo_order() == rg.topo_order()
    assert tg.total_macs == rg.total_macs


def test_graph_errors_and_attach_weights_match(R):
    S = R["S"]
    t_cfg, r_cfg = _smoke(), R["RR"].get_smoke_config("yi-6b",
                                                      dtype="float32")
    tg, rg = TS.lm_graph(t_cfg, seq_len=8), S.lm_graph(r_cfg, seq_len=8)
    rng = np.random.default_rng(0)
    l = tg.nodes["blk0_wq"].layer
    w = rng.standard_normal((l.cin, l.cout)).astype(np.float32)
    w[:, : l.cout // 2] = 0.0
    TS.attach_weights(tg, {"blk0_wq": w})
    S.attach_weights(rg, {"blk0_wq": w})
    assert _graph_rows(tg) == _graph_rows(rg)
    for g, a in ((16, 16), (8, 32)):
        np.testing.assert_array_equal(
            tg.nodes["blk0_wq"].kernel_group_counts(g, a),
            rg.nodes["blk0_wq"].kernel_group_counts(g, a))
    with pytest.raises(ValueError, match="expected"):
        TS.attach_weights(tg, {"blk0_wq": w[:, :-1]})
    with pytest.raises(ValueError, match="unknown node"):
        TS.LayerGraph({"a": TS.LayerNode("a", l, deps=("b",))})
    with pytest.raises(ValueError, match="cycle"):
        TS.LayerGraph({"a": TS.LayerNode("a", l, deps=("b",)),
                       "b": TS.LayerNode("b", l, deps=("a",))}).topo_order()


def _alloc_rows(a):
    return _dc(a), a.reload_waves, a.placed, a.imbalance, a.macro_occupancy


@pytest.mark.parametrize("sparsity", [0.0, 0.5, 0.95])
@pytest.mark.parametrize("group,alpha", [(16, 16), (8, 32), (32, 8)])
def test_allocators_match(R, sparsity, group, alpha):
    S = R["S"]
    tl = TPM.ConvLayer(3, 3, 256, 256, 8, 8, sparsity)
    rl = R["PM"].ConvLayer(3, 3, 256, 256, 8, 8, sparsity)
    tn, rn = TS.LayerNode("x", tl), S.LayerNode("x", rl)
    for dense in (False, True):
        t = TS.allocate_node(tn, group=group, alpha=alpha, dense=dense)
        r = S.allocate_node(rn, group=group, alpha=alpha, dense=dense)
        assert _alloc_rows(t) == _alloc_rows(r)
        assert TS.verify_conservation(t) and S.verify_conservation(r)
    counts = np.random.default_rng(group).integers(0, 40, 24)
    assert _alloc_rows(TS.allocate_counts(counts, w_bits=4)) == _alloc_rows(
        S.allocate_counts(counts, w_bits=4))
    rng = np.random.default_rng(alpha)
    w = rng.standard_normal((96, 64)).astype(np.float32)
    w[rng.random((96, 64)) < sparsity] = 0.0
    tp, rp = TM.pack_groupsets(w, alpha=16), R["M"].pack_groupsets(w,
                                                                   alpha=16)
    assert _alloc_rows(TS.allocate_packing(tp, name="p")) == _alloc_rows(
        S.allocate_packing(rp, name="p"))


@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_device_assignment_matches(R, n_devices, seed):
    counts = np.random.default_rng(seed).integers(0, 50, 32)
    np.testing.assert_array_equal(
        TS.device_assignment(counts, n_devices),
        R["S"].device_assignment(counts, n_devices))
    with pytest.raises(ValueError, match="evenly"):
        TS.device_assignment(counts[:30], 4)


@pytest.mark.parametrize("which", ["vgg16", "resnet18", "lm-smoke"])
@pytest.mark.parametrize("kw", [dict(), dict(pipeline=False),
                                dict(dense=True, a_bits=8),
                                dict(group=32, alpha=8, w_bits=4, a_bits=4)])
def test_simulate_matches(R, which, kw):
    S = R["S"]
    if which == "lm-smoke":
        tg = TS.lm_graph(_smoke(), seq_len=32, sparsity_gs=0.6)
        rg = S.lm_graph(R["RR"].get_smoke_config("yi-6b", dtype="float32"),
                        seq_len=32, sparsity_gs=0.6)
    else:
        tg, rg = getattr(TS, f"{which}_graph")(), getattr(S,
                                                         f"{which}_graph")()
    t, r = TS.simulate(tg, **kw), S.simulate(rg, **kw)
    assert _sim_rows(t) == _sim_rows(r)
    assert t.core_utilization == r.core_utilization
    lean = TS.simulate(tg, keep_events=False, **kw)
    assert lean.events == [] and lean.cycles == t.cycles


def _rand_layers(PM, rng):
    """tests/test_sched.py's generator: one draw per field, in its order."""
    out = []
    for _ in range(int(rng.integers(2, 9))):
        k = int(rng.choice([1, 3]))
        out.append(PM.ConvLayer(k, k, int(rng.choice([32, 64, 128, 256])),
                                int(rng.choice([128, 256, 512])),
                                int(rng.choice([4, 8, 16, 32])),
                                int(rng.choice([4, 8, 16, 32])),
                                float(rng.uniform(0.0, 0.75))))
    return out


@pytest.mark.parametrize("seed", range(0, 22, 3))
def test_randomized_networks_simulate_equal(R, seed):
    """The reference's randomized chains (dense and sparse) and diamond DAGs
    (``tests/test_sched.py``): the same cycles, fps, timings and events,
    and the same chain cross-validation."""
    S, PM = R["S"], R["PM"]
    rng = np.random.default_rng(seed)
    a_bits = int(rng.choice([4, 8]))
    tls = _rand_layers(TPM, np.random.default_rng(seed + 100))
    rls = _rand_layers(PM, np.random.default_rng(seed + 100))
    for dense in (True, False):
        t = TS.simulate(TS.graph_from_layers(tls), w_bits=8, a_bits=a_bits,
                        dense=dense, pipeline=False)
        r = S.simulate(S.graph_from_layers(rls), w_bits=8, a_bits=a_bits,
                       dense=dense, pipeline=False)
        assert _sim_rows(t) == _sim_rows(r)
        assert TS.cross_validate(tls, w_bits=8, a_bits=a_bits,
                                 dense=dense) == S.cross_validate(
            rls, w_bits=8, a_bits=a_bits, dense=dense)

    def diamond(mod, ls):
        nodes = {"l0": mod.LayerNode("l0", ls[0])}
        prev = "l0"
        for i, l in enumerate(ls[1:-2], 1):
            nodes[f"l{i}"] = mod.LayerNode(f"l{i}", l, deps=(prev,))
            prev = f"l{i}"
        nodes["skip"] = mod.LayerNode("skip", ls[-2], deps=("l0",))
        nodes["join"] = mod.LayerNode("join", ls[-1], deps=(prev, "skip"))
        return mod.LayerGraph(nodes)

    if len(tls) >= 4:
        for pipeline in (False, True):
            t = TS.simulate(diamond(TS, tls), a_bits=a_bits, dense=True,
                            pipeline=pipeline)
            r = S.simulate(diamond(S, rls), a_bits=a_bits, dense=True,
                           pipeline=pipeline)
            assert _sim_rows(t) == _sim_rows(r)


# ---------------------------------------------------------------------------
# sched: searches, schedules, pricing
# ---------------------------------------------------------------------------


def _table(res):
    return [(_dc(c), c.row())
            for c in res.table]


@pytest.mark.parametrize("uniform", [False, True])
def test_search_mapping_and_greedy_match(R, uniform):
    S = R["S"]
    tg = TS.lm_graph(_smoke(), seq_len=32, sparsity_gs=0.6)
    rg = S.lm_graph(R["RR"].get_smoke_config("yi-6b", dtype="float32"),
                    seq_len=32, sparsity_gs=0.6)
    kw = dict(groups=(8, 16, 32, 64), alphas=(8, 16, 32, 64),
              uniform=uniform)
    t, r = TS.search_mapping(tg, **kw), S.search_mapping(rg, **kw)
    assert _table(t) == _table(r)
    assert t.best.candidate.tile == r.best.candidate.tile
    assert t.speedup_vs_default == r.speedup_vs_default
    tv, rv = TS.vgg16_graph(), S.vgg16_graph()
    t, r = TS.greedy_search(tv), S.greedy_search(rv)
    assert _table(t) == _table(r)
    assert _dc(t.best.candidate) == _dc(r.best.candidate)


def test_build_schedule_matches(R):
    S = R["S"]
    tg, rg = TS.resnet18_graph(), S.resnet18_graph()
    ts = TS.schedule_from_search(tg, TS.search_mapping(tg))
    rs = S.schedule_from_search(rg, S.search_mapping(rg))
    assert ts.to_json() == rs.to_json()
    cand = TS.MappingCandidate(group=8, alpha=32, pipeline=False)
    rcand = S.MappingCandidate(group=8, alpha=32, pipeline=False)
    assert TS.build_schedule(tg, cand).to_json() == S.build_schedule(
        rg, rcand).to_json()
    assert TS.build_schedule(tg, cand).uniform_tile == (8, 32)


SPEC_GRIDS = [dict(), dict(ks=(2, 4), draft_sparsities=(0.85,),
                           keeps=(0.5, 0.75))]


@pytest.mark.parametrize("grid", range(len(SPEC_GRIDS)))
@pytest.mark.parametrize("calibrated", [False, True])
def test_search_spec_matches(R, grid, calibrated):
    from repro.sched.search import SpecCalibration as RCal
    t_cfg = _smoke()
    r_cfg = R["RR"].get_smoke_config("yi-6b", dtype="float32")
    tcal = rcal = None
    if calibrated:
        tcal = TS.SpecCalibration()
        tcal.add(t_cfg.name, "layerskip", 0.5, 0.7, weight=120.0)
        tcal.add(t_cfg.name, "reprune", 0.4, 0.05, weight=30.0)
        rcal = RCal.from_json(tcal.to_json())
    kw = dict(target_sparsity=0.6, arch=t_cfg.name, **SPEC_GRIDS[grid])
    t = TS.search_spec(t_cfg, calibration=tcal, **kw)
    r = R["S"].search_spec(r_cfg, calibration=rcal, **kw)
    assert t.table == r.table and t.best == r.best
    assert t.decision == r.decision


def test_spec_calibration_json_both_ways(R):
    from repro.sched.search import SpecCalibration as RCal
    t = TS.SpecCalibration()
    t.add("yi-6b", "layerskip", 0.5, 0.7, weight=120.0)
    t.add("yi-6b", "reprune", 0.3, 0.4, weight=8.0)
    r = RCal.from_json(json.loads(json.dumps(t.to_json())))
    assert r.to_json() == t.to_json()
    r.add("yi-6b", "layerskip", 0.25, 0.9, weight=80.0)
    back = TS.SpecCalibration.from_json(json.loads(json.dumps(r.to_json())))
    assert back.to_json() == r.to_json()
    for gap in (0.1, 0.25, 0.4, 0.5, 0.9):
        assert back.accept_model("yi-6b", "layerskip")(gap) == \
            r.accept_model("yi-6b", "layerskip")(gap)
    for bad in ({"schema": 99, "rows": []}, {"schema": 1,
                                             "rows": [{"arch": "a"}]}):
        with pytest.raises(ValueError):
            TS.SpecCalibration.from_json(bad)


def test_pricer_matches(R):
    PR = R["PR"]
    t_cfg = _smoke()
    r_cfg = R["RR"].get_smoke_config("yi-6b", dtype="float32")
    refit = {"mac": 2e-9, "reload": 1e-9, "ctrl": 4e-9}
    for kw in (dict(), dict(refit=refit)):
        tp, rp = TS.Pricer(**kw), PR.Pricer(**kw)
        assert tp.calibrated == rp.calibrated
        for n_dev in (1, 4):
            t = tp.price_request(t_cfg, 37, 9, 0.6, n_devices=n_dev)
            r = rp.price_request(r_cfg, 37, 9, 0.6, n_devices=n_dev)
            assert _dc(t) == _dc(r) and t.to_json() == r.to_json()
            assert _dc(tp.step_price(t_cfg, 5, 0.5, n_dev)) == _dc(
                rp.step_price(r_cfg, 5, 0.5, n_dev))
    with pytest.raises(ValueError):
        TS.Pricer(refit={"mac": 0.0})


# ---------------------------------------------------------------------------
# serving: default_schedule, compress(schedule=), execution
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("uniform", [False, True])
def test_default_schedule_matches(R, uniform):
    t = TDP.default_schedule(_smoke(), uniform=uniform)
    r = R["DP"].default_schedule(
        R["RR"].get_smoke_config("yi-6b", dtype="float32"), uniform=uniform)
    assert t.to_json() == r.to_json()
    assert {s.name: s.tile for s in t.layers} == {
        s.name: s.tile for s in r.layers}


KEYS = ("blocks", "scales", "row_idx", "nnz")


def _levels(p, dw) -> np.ndarray:
    a = {k: np.asarray(p[k]) for k in KEYS}
    bk, bn = a["blocks"].shape[2:]
    return TM.bsr_to_dense(TM.BsrWeight(a["blocks"], a["row_idx"], a["nnz"],
                                        bk, bn, dw.d_in, dw.d_out))


def _pre_rounding(R, w, cim, ts, bk, bn) -> np.ndarray:
    """The reference's eq. 8 input times (2^(b-1)-1)."""
    import jax.numpy as jnp
    from repro.core import quant as RQ
    from repro.core import sparsity as RS
    w = jnp.asarray(w)
    mask = RS.prune_mask_2d(w, bk, bn, ts)
    w_bar = RQ.fuse_bn_scale(RQ.tanh_normalize(w * mask,
                                               cim.quant.group_size),
                             None, None)
    return np.asarray(w_bar * (2.0 ** (cim.quant.w_bits - 1) - 1.0)
                      ).astype(np.float64)


@pytest.mark.parametrize("uniform", [False, True])
def test_compress_with_schedule_matches_reference(R, uniform):
    """The same float weights packed with the same schedule: every
    projection's tile (the head's fallback included), row_idx, nnz and
    scales equal; int8 levels equal but for +-1 at eq. 8 half-levels."""
    import jax
    from repro_torch import convert
    RR, RDP = R["RR"], R["DP"]
    rcfg = RR.get_smoke_config("yi-6b", dtype="float32")
    tcfg = _smoke()
    params = RR.model_fns(rcfg).init_params(rcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        tcfg, device="cpu")
    ts = 0.6
    rsp = RDP.compress(rcfg, params, target_sparsity=ts,
                       schedule=RDP.default_schedule(rcfg), uniform=uniform)
    tsp = TDP.compress(tcfg, tparams, target_sparsity=ts,
                       schedule=TDP.default_schedule(tcfg), uniform=uniform)
    rdep, tdep = rsp.deployed(), tsp.deployed()
    assert sorted(rdep) == sorted(tdep) and "head" in tdep
    n_levels, diffs = 0, []
    for name, rdw in rdep.items():
        tdw = tdep[name]
        assert (tdw.d_in, tdw.d_out, tdw.tile) == (rdw.d_in, rdw.d_out,
                                                    rdw.tile), name
        rp, tp = rdw.packed[0], tdw.packed[0]
        for k in ("row_idx", "nnz", "scales"):
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(rp[k]),
                                          err_msg=f"{name}.{k}")
        rb, tb = np.asarray(rp["blocks"]), tp["blocks"].numpy()
        n_levels += rb.size
        if (rb != tb).any():
            layer = None if name == "head" else int(name[3:name.index("_")])
            w = (params["head"] if layer is None
                 else params["layers"][name[name.index("_") + 1:]][layer])
            pre = _pre_rounding(R, w, rcfg.cim, ts, *rdw.tile)
            lr, lt = _levels(rp, rdw), _levels(tp, tdw)
            diffs += [(int(lr[i, j]) - int(lt[i, j]),
                       abs(pre[i, j] - np.floor(pre[i, j]) - 0.5))
                      for i, j in zip(*np.nonzero(lr != lt))]
    assert len(diffs) <= max(1, n_levels // 100_000), diffs
    for d, off_half in diffs:
        assert abs(d) == 1 and off_half <= 1e-4, (d, off_half)
    # the head is not a node of lm_graph: it takes the fallback tile
    assert tdep["head"].tile == TDP.packed_tiles(tsp)[0] or not uniform


def test_bm_for_rows_and_reference_matmul_match(R):
    from repro_torch.core import deploy as TD
    for rows in (1, 4, 8, 9, 32, 33, 100, 128, 129, 4096):
        assert TD.bm_for_rows(rows) == R["D"].bm_for_rows(rows)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 64)).astype(np.float32)
    w = rng.standard_normal((64, 48)).astype(np.float32) * 0.1
    cim = _smoke().cim
    rcim = R["RR"].get_smoke_config("yi-6b", dtype="float32").cim
    want = np.asarray(R["D"].reference_matmul(x, w, rcim, 0.5, bk=16, bn=16))
    got = TD.reference_matmul(torch.from_numpy(x), torch.from_numpy(w), cim,
                              0.5, bk=16, bn=16).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _layer_case(R, name, rows, seed):
    """One smoke projection's LayerSchedule (both sides), a float weight
    and activations of that shape."""
    t_sched = {s.name: s for s in TDP.default_schedule(_smoke()).layers}
    r_sched = {s.name: s for s in R["DP"].default_schedule(
        R["RR"].get_smoke_config("yi-6b", dtype="float32")).layers}
    ts, rs = t_sched[name], r_sched[name]
    l = TS.lm_graph(_smoke()).nodes[name].layer
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((l.cin, l.cout)).astype(np.float32) * 0.05
    x = rng.standard_normal((rows, l.cin)).astype(np.float32) * 0.5
    return ts, rs, x, w


@pytest.mark.parametrize("name,rows", [("blk0_wq", 5), ("blk1_wk", 1),
                                       ("blk0_w_down", 32)])
def test_execute_and_verify_layer_match_reference(R, name, rows):
    ts, rs, x, w = _layer_case(R, name, rows, seed=len(name) + rows)
    cim = _smoke().cim
    rcim = R["RR"].get_smoke_config("yi-6b", dtype="float32").cim
    want = np.asarray(R["EX"].execute_layer(x, w, rs, rcim, 0.5,
                                            interpret=True))
    got = TS.execute_layer(torch.from_numpy(x), torch.from_numpy(w), ts,
                           cim, 0.5)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * scale)
    err = TS.verify_layer(torch.from_numpy(x), torch.from_numpy(w), ts, cim,
                          0.5)
    assert err <= 1e-5 * scale
    assert TEX.deploy_layer(torch.from_numpy(w), ts, cim).tile == \
        R["EX"].deploy_layer(w, rs, rcim).tile
    outs = TS.execute_network({name: torch.from_numpy(x)},
                              {name: torch.from_numpy(w), "nope": None},
                              TDP.default_schedule(_smoke()), cim)
    assert list(outs) == [name]


def test_verify_layer_raises_past_tolerance(R):
    ts, _, x, w = _layer_case(R, "blk0_wo", 4, seed=1)
    with pytest.raises(AssertionError, match="diverged"):
        TS.verify_layer(torch.from_numpy(x), torch.from_numpy(w), ts,
                        _smoke().cim, 0.5, atol=-1.0)


# ---------------------------------------------------------------------------
# obs/gap
# ---------------------------------------------------------------------------


def test_gap_helpers_match(R):
    GAP = R["GAP"]
    for s in ([0.2, 0.1, float("inf")], [0.0, 3.0], [5e-12]):
        assert TGAP.clamp_measured(s) == GAP.clamp_measured(s)
    with pytest.raises(ValueError, match="no usable"):
        TGAP.clamp_measured([float("nan"), -1.0])
    kw = dict(predicted_phases={"compute": 3.0, "reload": 1.0,
                                "fm": float("inf")},
              measured_phases={"prefill": 0.2, "decode": 0.6}, tag="x")
    assert TGAP.gap_report(2e-3, 5e-2, **kw) == GAP.gap_report(2e-3, 5e-2,
                                                               **kw)
    for bad in ((0.0, 1.0), (1.0, float("nan"))):
        with pytest.raises(ValueError):
            TGAP.gap_report(*bad)
    snap = {"histograms": {
        "serve_phase_s{phase=decode}": {"sum": 0.5},
        "serve_phase_s{phase=prefill,x=1}": {"sum": 0.25},
        "serve_phase_s{nophase=1}": {"sum": 9.0},
        "other{phase=decode}": {"sum": 9.0},
        "serve_phase_s{phase=bad}": {"sum": "x"}}}
    assert TGAP.measured_phase_shares(snap) == GAP.measured_phase_shares(snap)


@pytest.mark.parametrize("n_devices", [1, 4])
def test_predicted_serve_step_and_serve_gap_match(R, n_devices):
    GAP = R["GAP"]
    t_cfg = _smoke()
    r_cfg = R["RR"].get_smoke_config("yi-6b", dtype="float32")
    assert TGAP.predicted_serve_step(
        t_cfg, 0.6, seq_len=3, n_devices=n_devices) == \
        GAP.predicted_serve_step(r_cfg, 0.6, seq_len=3, n_devices=n_devices)
    phases = {"decode": 0.01, "prefill": 0.004}
    assert TGAP.serve_gap(t_cfg, 0.02, 0.6, phases,
                          n_devices=n_devices) == GAP.serve_gap(
        r_cfg, 0.02, 0.6, phases, n_devices=n_devices)


def test_kernel_gap_matches_reference_but_the_clock(R):
    """The plain version on the CPU, timed: every predicted field equal to
    the reference's, the measured one finite and positive."""
    kw = dict(tile=(16, 16), sparsity=0.5, repeats=2)
    t = TGAP.kernel_gap(8, 64, 96, device="cpu", **kw)
    r = R["GAP"].kernel_gap(8, 64, 96, **kw)
    assert t["backend"] == "cpu"
    for k in ("predicted_s", "predicted_cycles", "predicted_phase_shares",
              "shape", "tile", "sparsity"):
        assert t[k] == r[k], k
    assert 0 < t["measured_s"] < 60 and t["sim_vs_measured"] > 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_kernel_gap_and_execute_layer_on_gpu():
    """kernel_gap times the kernel itself (its launch count moves) and a
    CUDA execute_layer runs the kernels, within 1e-5 of max |ref| of the
    dense oracle on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.kernels import cim_bsr_matmul as K
    from repro_torch.kernels import fake_quant as FQ
    K.reset_launches()
    row = TGAP.kernel_gap(4, 4096, 11008, (64, 64), 0.6, repeats=3)
    assert row["backend"] == "cuda" and K.LAUNCHES == 4
    assert row["measured_s"] > 0
    sched = {s.name: s for s in TDP.default_schedule(_smoke()).layers}
    rng = np.random.default_rng(0)
    cim = _smoke().cim
    for name in ("blk0_wq", "blk0_wk", "blk0_w_down"):
        l = TS.lm_graph(_smoke()).nodes[name].layer
        w = torch.from_numpy(rng.standard_normal((l.cin, l.cout)).astype(
            np.float32) * 0.05).cuda()
        x = torch.from_numpy(rng.standard_normal((6, l.cin)).astype(
            np.float32)).cuda()
        K.reset_launches()
        n_fq = FQ.LAUNCHES
        y = TS.execute_layer(x, w, sched[name], cim, 0.5)
        torch.cuda.synchronize()
        assert y.is_cuda and K.LAUNCHES == 1 and FQ.LAUNCHES == n_fq + 1
        want = TEX.D.reference_matmul(x, w, cim, 0.5,
                                      *TEX._deploy_tile(sched[name], l.cin,
                                                        l.cout))
        scale = float(want.abs().max())
        TS.verify_layer(x, w, sched[name], cim, 0.5, atol=1e-5 * scale)
