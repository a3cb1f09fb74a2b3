"""The port's self-speculative decoding (``serve/spec.py``, the spec
engine of ``BatchServer`` and the CLI's ``--spec``) against the reference.

Model: the smoke yi-6b in float32 (2 layers, d_model 64), with the
reference's own parameters and its own packing (``compress(uniform=True,
tile=(16, 16), target_sparsity=0.6)``), carried across exactly by
``convert``. The bars:

* the draft tier's integer artifacts (int8 blocks, ``row_idx``, ``nnz``,
  scales) and the layer-skip masks equal the reference's exactly;
* logits and K/V agree within ``tests/test_kernels.py``'s f32 tolerance
  (1e-5): the two frameworks order f32 sums differently;
* greedy tokens and proposals equal the reference's;
* inside the port the spec engine's tokens equal the scan engine's, and a
  masked decode step with every mask on equals the paged one, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as RSERVE
from repro.models import registry as RR
from repro.serve import deployed as RDP
from repro.serve import spec as RSP
from repro.serve import stacked as RST
from repro.serve.batching import Request as RRequest
from repro.serve.engine import ServeConfig as RServeConfig
from repro.serve.server import BatchConfig as RBatchConfig
from repro.serve.server import BatchServer as RBatchServer
from repro_torch import convert
from repro_torch.launch import serve as TSERVE
from repro_torch.models import registry as TR
from repro_torch.serve import (BatchConfig, BatchServer, PagedKVCache,
                               Request, ServeConfig)
from repro_torch.serve import deployed as TDP
from repro_torch.serve import spec as TSP
from repro_torch.serve import stacked as TST

TOL = 1e-5  # tests/test_kernels.py's f32 tolerance
DRAFT_SPARSITY = 0.9
BCFG = dict(n_slots=3, block_size=8, n_blocks=64)


def _export(sp) -> dict:
    """A reference ServingParams as numpy and plain Python."""
    def leaf(v):
        if hasattr(v, "packed"):
            return {"packed": [{k: np.asarray(a) for k, a in p.items()}
                               for p in v.packed],
                    "d_in": v.d_in, "d_out": v.d_out, "bits": v.bits}
        return None if v is None else np.asarray(v)

    return {"embed": leaf(sp.embed), "final_ln": leaf(sp.final_ln),
            "layers": [{k: leaf(v) for k, v in p.items()} for p in sp.layers],
            "head": leaf(sp.head), "head_t": leaf(sp.head_t)}


@pytest.fixture(scope="module")
def models():
    """(rcfg, tcfg, reference target, port target, reference draft, port
    draft); the port's draft is built by the port from its own copy."""
    rcfg = RR.get_smoke_config("yi-6b", dtype="float32")
    tcfg = TR.get_smoke_config("yi-6b", dtype="float32")
    params = RR.model_fns(rcfg).init_params(rcfg, jax.random.PRNGKey(0))
    rsp = RDP.compress(rcfg, params, target_sparsity=0.6, tile=(16, 16),
                       uniform=True)
    tsp = convert.serving_params_from_numpy(_export(rsp), tcfg, device="cpu")
    rdraft = RSP.draft_serving(rcfg, rsp, DRAFT_SPARSITY)
    tdraft = TSP.draft_serving(tcfg, tsp, DRAFT_SPARSITY)
    return rcfg, tcfg, rsp, tsp, rdraft, tdraft


def _trace(n=5, seed=7):
    """(rid, prompt, max_new) triples: prompts of 3-22 tokens, r0, r2 and
    r4 share a 16-token (two-block) prefix, so later ones take the
    prefix-cache suffix pass."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 256, 16)
    out = []
    for i in range(n):
        tail = rng.integers(0, 256, 3 + i)
        p = np.concatenate([shared, tail]) if i % 2 == 0 else tail
        out.append((f"r{i}", p.astype(np.int32), 7 + 2 * (i % 3)))
    return out


def _port_trace():
    return [Request(r, p, n) for r, p, n in _trace()]


def _ref_trace():
    return [RRequest(r, p, n) for r, p, n in _trace()]


_REF_RUNS = {}


def _reference_run(models, engine, family=None, k=4, prefix=True, eos=-1):
    """The reference's tokens and spec telemetry, cached per case."""
    key = (engine, family, k, prefix, eos)
    if key not in _REF_RUNS:
        rcfg, _, rsp, _, rdraft, _ = models
        kw = {}
        if engine == "spec":
            kw = {"spec": RSP.SpecConfig(k=k, draft=family,
                                         draft_sparsity=DRAFT_SPARSITY),
                  "draft": rdraft if family == "reprune" else None}
        rep = RBatchServer(rcfg, rsp, RServeConfig(eos_id=eos),
                           RBatchConfig(prefix_cache=prefix, **BCFG),
                           engine=engine, **kw).run(_ref_trace())
        _REF_RUNS[key] = rep
    return _REF_RUNS[key]


def _port_run(models, engine, family=None, k=4, prefix=True, eos=-1,
              **extra):
    _, tcfg, _, tsp, _, tdraft = models
    kw = {}
    if engine == "spec":
        kw = {"spec": TSP.SpecConfig(k=k, draft=family,
                                     draft_sparsity=DRAFT_SPARSITY),
              "draft": tdraft if family == "reprune" else None}
    return BatchServer(tcfg, tsp, ServeConfig(eos_id=eos),
                       BatchConfig(prefix_cache=prefix, **BCFG),
                       engine=engine, device="cpu", **kw, **extra
                       ).run(_port_trace())


def _deployed_pairs(rsp, tsp):
    rdep, tdep = rsp.deployed(), tsp.deployed()
    assert sorted(rdep) == sorted(tdep)
    return [(name, rdep[name], tdep[name]) for name in sorted(rdep)]


# ---------------------------------------------------------------------------
# Draft tier construction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("draft_sparsity", [0.75, DRAFT_SPARSITY])
def test_draft_serving_integer_artifacts_equal_reference(models,
                                                         draft_sparsity):
    """int8 blocks, row_idx, nnz and scales of every re-pruned projection
    equal the reference's exactly, and each is sparser than the target
    with the same tile; the dense leaves are the target's own tensors."""
    rcfg, tcfg, rsp, tsp, _, _ = models
    rdraft = RSP.draft_serving(rcfg, rsp, draft_sparsity)
    tdraft = TSP.draft_serving(tcfg, tsp, draft_sparsity)
    for name, rdw, tdw in _deployed_pairs(rdraft, tdraft):
        assert (tdw.d_in, tdw.d_out, tdw.bits, tdw.tile) == (
            rdw.d_in, rdw.d_out, rdw.bits, rdw.tile), name
        assert tdw.tile == tsp.deployed()[name].tile
        for rp, tp in zip(rdw.packed, tdw.packed):
            for key in ("blocks", "row_idx", "nnz", "scales"):
                want = np.asarray(rp[key])
                got = tp[key].numpy()
                assert got.dtype == want.dtype, (name, key)
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{name} {key}")
        assert tdw.density <= tsp.deployed()[name].density
    assert tdraft.embed is tsp.embed and tdraft.final_ln is tsp.final_ln
    assert tdraft.layers[0]["ln1"] is tsp.layers[0]["ln1"]


def test_draft_surviving_blocks_keep_the_target_levels(models):
    """The draft differs from the target only in which blocks exist: every
    surviving (row, column) block holds the target's int8 levels."""
    _, _, _, tsp, _, tdraft = models
    for name, tdw in tdraft.deployed().items():
        target = tsp.deployed()[name]
        for dp, tp in zip(tdw.packed, target.packed):
            for g in range(dp["nnz"].shape[0]):
                rows_t = {int(r): s for s, r in
                          enumerate(tp["row_idx"][g, :int(tp["nnz"][g])])}
                for s in range(int(dp["nnz"][g])):
                    r = int(dp["row_idx"][g, s])
                    assert torch.equal(dp["blocks"][g, s],
                                       tp["blocks"][g, rows_t[r]]), name


def test_draft_of_a_dense_target_is_packed_and_stacks(models):
    """Raw (dense-serving) projections go through ``deploy_weight`` at the
    draft sparsity with one network-wide tile, so the draft stacks."""
    _, tcfg, _, tsp, _, _ = models
    gen = torch.Generator().manual_seed(0)
    params = TR.model_fns(tcfg).init_params(tcfg, gen, device="cpu")
    dense = TDP.from_params(tcfg, params)
    draft = TSP.draft_serving(tcfg, dense, 0.5, tile=(16, 16))
    dep = draft.deployed()
    assert len(dep) == 7 * tcfg.n_layers + (dense.head is not None)
    assert {dw.tile for dw in dep.values()} == {(16, 16)}
    TSP.SpecParams.build(dense, draft)  # one envelope per projection


# ---------------------------------------------------------------------------
# Layer-skip family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier", ["target", "draft"])
def test_sublayer_importance_and_masks_equal_reference(models, tier):
    _, _, rsp, tsp, rdraft, tdraft = models
    rsx = RST.stack(rsp if tier == "target" else rdraft)
    tsx = TST.stack(tsp if tier == "target" else tdraft)
    want = RSP.sublayer_importance(rsx)
    got = TSP.sublayer_importance(tsx)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for keep in (0.25, 0.5, 0.75, 1.0):
        for imp in (got, None):
            rimp = want if imp is not None else None
            assert TSP.layerskip_masks(2, keep, imp) == \
                RSP.layerskip_masks(2, keep, rimp), keep
            masks = TSP.layerskip_masks(2, keep, imp)
            assert TSP.kept_fraction(*masks) == RSP.kept_fraction(*masks)


@pytest.mark.parametrize("n_layers", [1, 3, 8])
def test_layerskip_masks_positional_prior_equals_reference(n_layers):
    rng = np.random.default_rng(n_layers)
    imp = (rng.integers(0, 3, n_layers).astype(float),
           rng.integers(0, 3, n_layers).astype(float))
    for keep in (0.1, 0.3, 0.5, 0.9, 1.0):
        for score in (None, imp):
            assert TSP.layerskip_masks(n_layers, keep, score) == \
                RSP.layerskip_masks(n_layers, keep, score)


def _views(models, seed=1, b=3, sv=24):
    rcfg = models[0]
    rng = np.random.default_rng(seed)
    shape = (rcfg.n_layers, b, sv, rcfg.n_kv_heads, rcfg.dh)
    vk = rng.standard_normal(shape).astype(np.float32)
    vv = rng.standard_normal(shape).astype(np.float32)
    pos = np.array([4, 11, 17], np.int32)[:b]
    toks = rng.integers(0, 256, (b, 1)).astype(np.int32)
    return vk, vv, pos, toks


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("masks", [((1, 1), (1, 1)), ((0, 1), (1, 1)),
                                   ((1, 1), (0, 1)), ((0, 1), (1, 0)),
                                   ((1, 0), (0, 0))])
def test_decode_step_masked_matches_reference(models, masks):
    """The port's masked step against the reference's ``lax.cond`` form
    (logits and the K/V rows, zero for a skipped attention); with every
    mask on it is ``decode_step_paged`` bit for bit."""
    rcfg, tcfg, rsp, tsp, _, _ = models
    vk, vv, pos, toks = _views(models)
    attn_on, mlp_on = masks
    want = RST.decode_step_masked(
        RST.stack(rsp), jnp.asarray(vk), jnp.asarray(vv), jnp.asarray(pos),
        jnp.asarray(toks), rcfg, jnp.asarray(attn_on, jnp.float32),
        jnp.asarray(mlp_on, jnp.float32))
    tsx = TST.stack(tsp)
    got = TST.decode_step_masked(tsx, _t(vk), _t(vv), _t(pos), _t(toks),
                                 tcfg, attn_on, mlp_on)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL)
    for li, on in enumerate(attn_on):
        if not on:
            assert not got[1][li].any() and not got[2][li].any()
    if all(attn_on) and all(mlp_on):
        paged = TST.decode_step_paged(tsx, _t(vk), _t(vv), _t(pos), _t(toks),
                                      tcfg)
        for a, b in zip(got, paged):
            assert torch.equal(a, b)


def test_verify_step_equals_sequential_decode_bit_for_bit(models):
    """T tokens through one verify pass give each position exactly the
    logits and K/V of T one-token steps over views of another length:
    the property greedy acceptance stands on."""
    _, tcfg, _, tsp, _, _ = models
    tsx = TST.stack(tsp)
    vk, vv, pos, _ = _views(models, seed=3, sv=32)
    toks = np.random.default_rng(4).integers(0, 256, (3, 5)).astype(np.int32)
    logits, ks, vs = TST.verify_step(tsx, _t(vk), _t(vv), _t(pos), _t(toks),
                                     tcfg)
    k_seq, v_seq = _t(vk[:, :, :24]), _t(vv[:, :, :24])
    rows = torch.arange(3)
    for t in range(5):
        lg, kn, vn = TST.decode_step_paged(
            tsx, k_seq, v_seq, _t(pos) + t, _t(toks[:, t:t + 1]), tcfg)
        assert torch.equal(lg, logits[:, t]), t
        assert torch.equal(kn, ks[:, :, t]) and torch.equal(vn, vs[:, :, t])
        k_seq[:, rows, _t(pos).long() + t] = kn
        v_seq[:, rows, _t(pos).long() + t] = vn


@pytest.mark.parametrize("family", ["reprune", "layerskip"])
@pytest.mark.parametrize("k", [1, 4])
def test_draft_propose_equals_reference(models, family, k):
    rcfg, tcfg, rsp, tsp, rdraft, tdraft = models
    vk, vv, pos, toks = _views(models, seed=5, sv=32)
    if family == "reprune":
        rp, rk, rv = RSP.draft_propose(RST.stack(rdraft), jnp.asarray(vk),
                                       jnp.asarray(vv), jnp.asarray(pos),
                                       jnp.asarray(toks), rcfg, k)
        tp, tk, tv = TSP.draft_propose(TST.stack(tdraft), _t(vk), _t(vv),
                                       _t(pos), _t(toks), tcfg, k)
        assert tuple(tk.shape) == tuple(rk.shape)
        np.testing.assert_allclose(tk.numpy(), np.asarray(rk), atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(rv), atol=TOL,
                                   rtol=TOL)
    else:
        masks = TSP.layerskip_masks(2, 0.5, TSP.sublayer_importance(
            TST.stack(tsp)))
        rp = RSP.draft_propose_layerskip(
            RST.stack(rsp), jnp.asarray(vk), jnp.asarray(vv),
            jnp.asarray(pos), jnp.asarray(toks), rcfg, k,
            jnp.asarray(masks[0], jnp.float32),
            jnp.asarray(masks[1], jnp.float32))
        tp = TSP.draft_propose_layerskip(TST.stack(tsp), _t(vk), _t(vv),
                                         _t(pos), _t(toks), tcfg, k, *masks)
    assert tp.dtype == torch.int32 and tuple(tp.shape) == (3, k)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(rp))


# ---------------------------------------------------------------------------
# Acceptance and telemetry
# ---------------------------------------------------------------------------


def test_accept_greedy_equals_reference():
    rng = np.random.default_rng(0)
    for _ in range(200):
        k = int(rng.integers(1, 6))
        props = rng.integers(0, 3, k)
        targets = rng.integers(0, 3, k)
        assert TSP.accept_greedy(props, targets) == \
            RSP.accept_greedy(props, targets)


@pytest.mark.parametrize("k_max", [1, 4, 8])
def test_adaptive_k_sequence_equals_reference(k_max):
    """A scripted acceptance stream (dead, then perfect, then borderline)
    drives both trackers through collapse, the doubling ladder and the
    hysteresis band: the k sequences and counters are equal."""
    rng = np.random.default_rng(k_max)
    got, want = TSP.AdaptiveK(k_max=k_max), RSP.AdaptiveK(k_max=k_max)
    ks_got, ks_want = [], []
    script = ([0.0] * 8 + [1.0] * 8 + list(rng.uniform(0.1, 0.7, 30)))
    for rate in script:
        n = got.k
        a = int(round(rate * n))
        ks_got.append(got.observe(n, a))
        ks_want.append(want.observe(want.k, int(round(rate * want.k))))
    assert ks_got == ks_want
    assert (got.collapses, got.expands) == (want.collapses, want.expands)
    assert got.acc == want.acc


def test_spec_stats_json_equals_reference():
    got = TSP.SpecStats(4, 0.9, family="layerskip", keep=0.5)
    want = RSP.SpecStats(4, 0.9, family="layerskip", keep=0.5)
    for st in (got, want):
        for n_acc, n_emit in ((4, 5), (0, 1), (2, 3), (2, 2)):
            st.record(4, n_acc, n_emit)
        st.round_s += [0.010, 0.012, 0.011]
        st.draft_s += [0.004, 0.005, 0.004]
        st.verify_s += [0.005, 0.006, 0.006]
        st.k_collapses, st.k_expands = 1, 2
    g, w = got.to_json(), want.to_json()
    assert g.pop("round_k") == []
    assert g == w


def test_spec_config_validation_equals_reference():
    for kw in ({"k": 0}, {"draft_sparsity": 1.0}, {"draft": "other"},
               {"keep": 0.0}, {"ewma": 0.0},
               {"collapse_below": 0.7, "expand_above": 0.6}):
        with pytest.raises(ValueError) as got:
            TSP.SpecConfig(**kw)
        with pytest.raises(ValueError) as want:
            RSP.SpecConfig(**kw)
        assert str(got.value) == str(want.value)
    assert TSP.SpecConfig(draft="layerskip", keep=0.3).knob == 0.3
    assert TSP.SpecConfig().knob == 0.9


# ---------------------------------------------------------------------------
# The spec engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prefix", [True, False])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("family", ["reprune", "layerskip"])
def test_spec_tokens_equal_scan_and_reference(models, family, k, prefix):
    """The spec engine's greedy tokens equal the port's scan engine's bit
    for bit and the reference's spec engine's, for both draft families,
    with the prefix cache on and off; its round counts equal the
    reference's (same proposals, same acceptances)."""
    scan = _port_run(models, "scan", prefix=prefix)
    got = _port_run(models, "spec", family, k, prefix=prefix)
    want = _reference_run(models, "spec", family, k, prefix=prefix)
    assert sorted(got.outputs) == sorted(want.outputs) == sorted(scan.outputs)
    for rid, toks in want.outputs.items():
        np.testing.assert_array_equal(got.outputs[rid], scan.outputs[rid],
                                      err_msg=f"{rid} spec != scan")
        np.testing.assert_array_equal(got.outputs[rid], np.asarray(toks),
                                      err_msg=f"{rid} != reference")
    for key in ("n_rounds", "slot_rounds", "proposed", "accepted",
                "accepted_len_hist", "spec_k_collapses", "spec_k_expands"):
        assert got.spec[key] == want.spec[key], key
    assert len(got.spec["round_k"]) == got.spec["n_rounds"]
    assert max(got.spec["round_k"]) <= k
    if prefix:
        assert got.prefix["hits"] >= 1


@pytest.mark.parametrize("family", ["reprune", "layerskip"])
def test_spec_with_fixed_k_equals_reference(models, family):
    """``adaptive_k=False``: every round drafts spec.k tokens; tokens and
    round counts equal the reference's, and every round's k is spec.k."""
    rcfg, tcfg, rsp, tsp, rdraft, tdraft = models
    got = BatchServer(tcfg, tsp, ServeConfig(), BatchConfig(**BCFG),
                      engine="spec", device="cpu",
                      draft=tdraft if family == "reprune" else None,
                      spec=TSP.SpecConfig(k=2, draft=family,
                                          adaptive_k=False)
                      ).run(_port_trace())
    want = RBatchServer(rcfg, rsp, RServeConfig(), RBatchConfig(**BCFG),
                        engine="spec",
                        draft=rdraft if family == "reprune" else None,
                        spec=RSP.SpecConfig(k=2, draft=family,
                                            adaptive_k=False)
                        ).run(_ref_trace())
    for rid, toks in want.outputs.items():
        np.testing.assert_array_equal(got.outputs[rid], np.asarray(toks),
                                      err_msg=rid)
    assert set(got.spec["round_k"]) == {2}
    for key in ("n_rounds", "proposed", "accepted", "accepted_len_hist"):
        assert got.spec[key] == want.spec[key], key


def test_spec_kv_tiers(models):
    """Reprune keeps two KV tiers behind one block layout, layerskip
    one; scan none extra."""
    assert _port_run(models, "spec", "reprune").kv_stats["kv_tiers"] == 2
    assert _port_run(models, "spec", "layerskip").kv_stats["kv_tiers"] == 1
    assert _port_run(models, "scan").kv_stats["kv_tiers"] == 1


@pytest.mark.parametrize("family", ["reprune", "layerskip"])
def test_spec_eos_inside_an_accepted_run(models, family):
    """EOS cuts the emitted run where sequential decode stops: the spec
    engine with an EOS id equals the scan engine with it."""
    scan = _port_run(models, "scan")
    toks = scan.outputs["r0"]
    eos = int(toks[len(toks) // 2])
    want = _port_run(models, "scan", eos=eos)
    got = _port_run(models, "spec", family, 4, eos=eos)
    assert any(len(o) < len(scan.outputs[r]) for r, o in want.outputs.items())
    for rid, toks in want.outputs.items():
        np.testing.assert_array_equal(got.outputs[rid], toks, err_msg=rid)
        assert eos not in toks[:-1]


@pytest.mark.parametrize("case", ["reprune_without_draft",
                                  "layerskip_with_draft", "temperature",
                                  "draft_without_spec_engine",
                                  "unknown_engine", "mesh"])
def test_spec_server_guards(models, case):
    _, tcfg, _, tsp, _, tdraft = models
    kw = {"reprune_without_draft": dict(engine="spec"),
          "layerskip_with_draft": dict(
              engine="spec", draft=tdraft,
              spec=TSP.SpecConfig(draft="layerskip")),
          "temperature": dict(engine="spec", draft=tdraft,
                              scfg=ServeConfig(temperature=0.7)),
          "draft_without_spec_engine": dict(engine="scan", draft=tdraft),
          "unknown_engine": dict(engine="jit"),
          "mesh": dict(engine="scan", mesh=object())}[case]
    err = NotImplementedError if case == "mesh" else ValueError
    with pytest.raises(err):
        BatchServer(tcfg, tsp, device="cpu", **kw)


def test_spec_reserves_the_lookahead(models):
    """A verify writes k positions past the committed stream, so the spec
    engine reserves them: a pool that fits the request only without the
    lookahead is refused at admission."""
    _, tcfg, _, tsp, _, _ = models
    req = [Request("r", np.arange(10, dtype=np.int32), 6)]  # 16 = 2 blocks
    bcfg = BatchConfig(n_slots=1, block_size=8, n_blocks=3)
    BatchServer(tcfg, tsp, bcfg=bcfg, engine="scan", device="cpu").run(req)
    srv = BatchServer(tcfg, tsp, bcfg=bcfg, engine="spec", device="cpu",
                      spec=TSP.SpecConfig(draft="layerskip", k=2))
    with pytest.raises(ValueError, match="needs 3 blocks"):
        srv.run(req)


def test_write_run_partial_commit_is_a_rollback(models):
    """Committing e of k+1 candidate entries writes exactly those
    positions of the requested tier; the rejected tail never reaches the
    pool and the other tier is untouched."""
    _, tcfg, _, _, _, _ = models
    kv = PagedKVCache(tcfg, 1, 8, 4, device="cpu", tiers=2)
    kv.ensure(0, 8)
    shape = (tcfg.n_layers, 5, tcfg.n_kv_heads, tcfg.dh)
    run = torch.arange(np.prod(shape), dtype=torch.float32).reshape(shape)
    kv.write_run(0, 3, run[:, :2], run[:, :2] + 1, tier=0)
    vk, vv = kv.gather(2, tier=0)
    assert torch.equal(vk[:, 0, 3:5], run[:, :2])
    assert torch.equal(vv[:, 0, 3:5], run[:, :2] + 1)
    assert not vk[:, 0, 5:].any() and not vk[:, 0, :3].any()
    dk, _ = kv.gather(2, tier=1)
    assert not dk.any()


# ---------------------------------------------------------------------------
# Two-tier artifacts and the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_two_tier_artifact_round_trip(models, tmp_path, writer):
    """A two-tier artifact written by either side boots on the other with
    both tiers' integers intact, and serves the spec tokens of the side
    that wrote it."""
    rcfg, tcfg, rsp, tsp, rdraft, tdraft = models
    path = str(tmp_path / "art")
    if writer == "reference":
        RDP.save_artifact(path, rsp, rcfg, draft=rdraft,
                          extra={"draft_sparsity": DRAFT_SPARSITY})
        sp, draft, extra = TDP.load_artifact_tiers(path, device="cpu")
        assert draft is not None and extra["two_tier"]
        for (_, rdw, tdw) in _deployed_pairs(rdraft, draft):
            for rp, tp in zip(rdw.packed, tdw.packed):
                for key in ("blocks", "row_idx", "nnz", "scales"):
                    np.testing.assert_array_equal(tp[key].numpy(),
                                                  np.asarray(rp[key]))
        assert draft.embed is sp.embed  # shared leaves: one tensor
        rep = BatchServer(tcfg, sp, ServeConfig(), BatchConfig(**BCFG),
                          engine="spec", device="cpu", draft=draft,
                          spec=TSP.SpecConfig(k=4)).run(_port_trace())
        want = _reference_run(models, "spec", "reprune", 4).outputs
    else:
        TDP.save_artifact(path, tsp, tcfg, draft=tdraft,
                          extra={"draft_sparsity": DRAFT_SPARSITY})
        sp, draft, extra = RDP.load_artifact_tiers(path)
        assert draft is not None and extra["two_tier"]
        for (_, tdw, rdw) in _deployed_pairs(tdraft, draft):
            for tp, rp in zip(tdw.packed, rdw.packed):
                for key in ("blocks", "row_idx", "nnz", "scales"):
                    np.testing.assert_array_equal(np.asarray(rp[key]),
                                                  tp[key].numpy())
        rep = RBatchServer(rcfg, sp, RServeConfig(), RBatchConfig(**BCFG),
                           engine="spec", draft=draft,
                           spec=RSP.SpecConfig(k=4)).run(_ref_trace())
        want = _port_run(models, "spec", "reprune", 4).outputs
    for rid, toks in want.items():
        np.testing.assert_array_equal(np.asarray(rep.outputs[rid]),
                                      np.asarray(toks), err_msg=rid)


N_REQ, N_NEW = 4, 8


@pytest.fixture(scope="module")
def cli_reference(models, tmp_path_factory):
    """A reference-written two-tier artifact and the reference's spec
    tokens of both families over the CLI's trace."""
    rcfg, _, rsp, _, rdraft, _ = models
    path = str(tmp_path_factory.mktemp("two_tier"))
    RDP.save_artifact(path, rsp, rcfg, draft=rdraft,
                      extra={"compressed": True,
                             "draft_sparsity": DRAFT_SPARSITY})
    trace = RSERVE.synthetic_trace(rcfg, N_REQ, 16, N_NEW, seed=0)
    bcfg = RBatchConfig(n_slots=4, block_size=8, n_blocks=64)
    want = {}
    for family, draft in (("reprune", rdraft), ("layerskip", None)):
        spec = RSP.SpecConfig(k=4, draft=family,
                              draft_sparsity=DRAFT_SPARSITY)
        want[family] = RBatchServer(rcfg, rsp, RServeConfig(seed=0), bcfg,
                                    engine="spec", draft=draft,
                                    spec=spec).run(trace).outputs
    return path, want


@pytest.mark.parametrize("spec", ["k=4,draft_sparsity=0.9",
                                  "draft=layerskip,keep=0.5,k=4"])
def test_cli_spec_boots_reference_two_tier_artifact(cli_reference, spec,
                                                    capsys):
    path, want = cli_reference
    family = "layerskip" if "layerskip" in spec else "reprune"
    rep = TSERVE.main(["--arch", "yi-6b", "--smoke", "--compressed",
                       "--artifact", path, "--requests", str(N_REQ),
                       "--new-tokens", str(N_NEW), "--device", "cpu",
                       "--spec", spec])
    out = capsys.readouterr().out
    assert "no re-packing" in out and "runtime: spec" in out
    assert rep.spec["family"] == family
    for rid, toks in want[family].items():
        np.testing.assert_array_equal(rep.outputs[rid], np.asarray(toks),
                                      err_msg=rid)


def test_cli_spec_packs_two_tiers_then_boots_them(tmp_path, capsys):
    """Without an artifact ``--spec`` packs both tiers and saves them
    together; the next run boots both (no packing) with the same tokens;
    a layerskip run needs no draft tier; a stored draft is served as
    stored even when another sparsity is asked for."""
    argv = ["--arch", "yi-6b", "--smoke", "--compressed", "--tile", "16x16",
            "--artifact", str(tmp_path), "--requests", "3", "--new-tokens",
            "5", "--device", "cpu"]
    first = TSERVE.main(argv + ["--spec", "k=2,draft_sparsity=0.8"])
    assert "packed + saved" in capsys.readouterr().out
    extra = TDP.load_artifact_extra(str(tmp_path))
    assert extra["two_tier"] and extra["draft_sparsity"] == 0.8
    second = TSERVE.main(argv + ["--spec", "k=2,draft_sparsity=0.7"])
    out = capsys.readouterr().out
    assert "no re-packing" in out and "serving it as stored" in out
    assert second.spec["draft_sparsity"] == 0.8
    scan = TSERVE.main(argv + ["--runtime", "scan"])
    skip = TSERVE.main(argv + ["--spec", "draft=layerskip,keep=0.5,k=2"])
    for rid, toks in scan.outputs.items():
        for rep in (first, second, skip):
            np.testing.assert_array_equal(rep.outputs[rid], toks)


def test_cli_upgrades_a_single_tier_artifact(tmp_path, capsys):
    argv = ["--arch", "yi-6b", "--smoke", "--compressed", "--tile", "16x16",
            "--artifact", str(tmp_path), "--requests", "2", "--new-tokens",
            "3", "--device", "cpu"]
    TSERVE.main(argv)
    assert "two_tier" not in TDP.load_artifact_extra(str(tmp_path))
    rep = TSERVE.main(argv + ["--spec", "k=2"])
    assert "upgraded to two-tier" in capsys.readouterr().out
    extra = TDP.load_artifact_extra(str(tmp_path))
    assert extra["two_tier"] and extra["compressed"]
    assert rep.spec["n_rounds"] > 0


@pytest.mark.parametrize("arg,msg", [("k=x", "--spec expects"),
                                     ("depth=3", "--spec expects"),
                                     ("k=0", "k must be >= 1")])
def test_cli_spec_argument_errors(arg, msg):
    with pytest.raises(SystemExit, match=msg):
        TSERVE.main(["--arch", "yi-6b", "--smoke", "--device", "cpu",
                     "--spec", arg])
