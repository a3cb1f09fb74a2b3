"""The port's multi-tenant gateway (``repro_torch.gateway``) on the CPU.

Two halves. The first runs ``tests/test_gateway.py``'s contracts on the
port, test for test (same names, same traces, same knobs; the port's own
seeded weights):

  * ISOLATION: every tenant's greedy tokens through the shared-pool
    gateway equal a dedicated single-tenant BatchServer's over the same
    requests, and one tenant's prefix trie never matches another's
    prompts;
  * HOT-SWAP: a matching envelope swaps in place with ZERO runtime builds
    (the tenant's build counter), a mismatched one is staged, a KV
    geometry mismatch is refused;
  * OVERLOAD: a bounded queue / backlog sheds strictly lowest priority
    first, counted, while the high-priority tenant meets its SLO;
  * RequestQueue priority/deadline semantics, artifact manifest checks and
    tenant-labelled metrics.

The second holds the port against the reference in one process: the same
weights (carried across by ``repro_torch.convert``) give the same tokens
through both gateways, unchunked and chunked; the admission controller
gives the same verdict, reason and backlog over the same priced sequence;
the bounded queue pops and sheds in the same order. The plain block-sparse
and attention versions take their sums in orders fixed per row, so the
port's tokens are compared bit for bit.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.gateway import (AdmissionController, Gateway, GatewayConfig,
                                 SwapEvent, TenantRegistry, TenantRuntime,
                                 TenantSLO, envelope_signature)
from repro_torch.models import registry
from repro_torch.obs import MetricsRegistry, ScopedMetrics
from repro_torch.sched.pricing import Pricer
from repro_torch.serve import (BatchConfig, BatchServer, Request,
                               RequestQueue, ServeConfig)
from repro_torch.serve import deployed as DP


def _init(cfg, seed):
    return registry.model_fns(cfg).init_params(
        cfg, torch.Generator().manual_seed(seed), device="cpu")


@pytest.fixture(scope="module")
def model():
    cfg = registry.get_smoke_config("yi-6b", dtype="float32")
    return cfg, DP.from_params(cfg, _init(cfg, 0)), \
        DP.from_params(cfg, _init(cfg, 1))


def _trace(cfg, tenant, n=4, seed=3, priority=0, max_prompt=12, max_new=7,
           Req=Request):
    rng = np.random.default_rng(seed)
    return [Req(f"{tenant}-r{i}",
                rng.integers(0, cfg.vocab, int(rng.integers(3, max_prompt))),
                int(rng.integers(2, max_new)), tenant=tenant,
                priority=priority)
            for i in range(n)]


def _gateway(tenants, **gcfg):
    return Gateway(tenants, GatewayConfig(**gcfg), device="cpu")


def _tenant(name, cfg, sp, **kw):
    return TenantRuntime(name, cfg, sp, **kw)


def _dedicated(cfg, sp, reqs, n_slots=3, block_size=4, n_blocks=48):
    srv = BatchServer(cfg, sp, ServeConfig(),
                      BatchConfig(n_slots=n_slots, block_size=block_size,
                                  n_blocks=n_blocks),
                      engine="scan", device="cpu")
    return srv.run([Request(r.rid, r.prompt, r.max_new_tokens)
                    for r in reqs])


# ---------------------------------------------------------------------------
# isolation: per-tenant parity + trie separation
# ---------------------------------------------------------------------------


def test_two_tenant_tokens_match_dedicated_servers(model):
    cfg, spA, spB = model
    reqsA = _trace(cfg, "acme", seed=3)
    reqsB = _trace(cfg, "bolt", seed=4)
    gw = _gateway([_tenant("acme", cfg, spA), _tenant("bolt", cfg, spB)],
                  n_slots=3, block_size=4, n_blocks=48)
    rep = gw.run(reqsA + reqsB)
    for name, sp, reqs in (("acme", spA, reqsA), ("bolt", spB, reqsB)):
        want = _dedicated(cfg, sp, reqs)
        got = rep.per_tenant[name].outputs
        assert set(got) == {r.rid for r in reqs}
        for r in reqs:
            np.testing.assert_array_equal(
                got[r.rid], want.outputs[r.rid],
                err_msg=f"{r.rid}: gateway diverged from dedicated server")
    # the report groups by tenant and labels each sub-report
    j = rep.to_json()
    assert set(j["tenants"]) == {"acme", "bolt"}
    assert j["tenants"]["acme"]["tenant"] == "acme"


def test_chunked_prefill_tokens_match_dedicated(model):
    """Disaggregated prefill (a fixed chunk budget interleaved with decode)
    changes no token."""
    cfg, spA, _ = model
    rng = np.random.default_rng(11)
    reqs = [Request(f"c{i}", rng.integers(0, cfg.vocab,
                                          int(rng.integers(9, 22))),
                    int(rng.integers(2, 6)), tenant="acme")
            for i in range(5)]
    gw = _gateway([_tenant("acme", cfg, spA)], n_slots=2, block_size=4,
                  n_blocks=64, prefill_chunk=4)
    rep = gw.run(reqs)
    want = _dedicated(cfg, spA, reqs, n_slots=2, n_blocks=64)
    for r in reqs:
        np.testing.assert_array_equal(rep.per_tenant["acme"].outputs[r.rid],
                                      want.outputs[r.rid], err_msg=r.rid)


def test_chunked_prefill_stops_at_max_new(model):
    """A request whose prefill completes inside a chunk budget and that
    wants one token (or hits EOS there) finishes without a decode round:
    the reference's gateway decodes one token too many there (its
    ``tokens_match_dedicated`` turns false); the port's equals the
    dedicated server's."""
    cfg, spA, _ = model
    rng = np.random.default_rng(5)
    reqs = [Request(f"m{i}", rng.integers(0, cfg.vocab, 7 + 3 * i), n,
                    tenant="acme") for i, n in enumerate((1, 3, 1, 2))]
    for chunk in (4, 16):
        rep = _gateway([_tenant("acme", cfg, spA)], n_slots=2, block_size=4,
                       n_blocks=64, prefill_chunk=chunk).run(reqs)
        want = _dedicated(cfg, spA, reqs, n_slots=2, n_blocks=64)
        for r in reqs:
            got = rep.per_tenant["acme"].outputs[r.rid]
            assert len(got) == r.max_new_tokens
            np.testing.assert_array_equal(got, want.outputs[r.rid])
    eos = int(want.outputs["m1"][1])  # m1 stops at its second token
    scfg = ServeConfig(eos_id=eos)
    rep = Gateway([_tenant("acme", cfg, spA)],
                  GatewayConfig(n_slots=2, block_size=4, n_blocks=64,
                                prefill_chunk=4), scfg, device="cpu").run(reqs)
    ded = BatchServer(cfg, spA, scfg, BatchConfig(n_slots=2, block_size=4,
                                                  n_blocks=64),
                      engine="scan", device="cpu").run(
        [Request(r.rid, r.prompt, r.max_new_tokens) for r in reqs])
    for r in reqs:
        np.testing.assert_array_equal(rep.per_tenant["acme"].outputs[r.rid],
                                      ded.outputs[r.rid])


def test_prefix_trie_never_crosses_tenants(model):
    """Two tenants serve the IDENTICAL prompt set: with per-tenant tries
    each tenant's first admission is a trie miss (a shared trie would hit
    the other tenant's cached blocks and serve tenant B's prompt through
    tenant A's KV)."""
    cfg, spA, spB = model
    rng = np.random.default_rng(7)
    shared_prompt = rng.integers(0, cfg.vocab, 12).astype(np.int32)
    reqs = []
    for tenant in ("acme", "bolt"):
        for i in range(2):  # the second request may hit its OWN trie
            suffix = rng.integers(0, cfg.vocab, 3).astype(np.int32)
            reqs.append(Request(f"{tenant}-p{i}",
                                np.concatenate([shared_prompt, suffix]),
                                3, tenant=tenant))
    gw = _gateway([_tenant("acme", cfg, spA), _tenant("bolt", cfg, spB)],
                  n_slots=1, block_size=4, n_blocks=64)
    rep = gw.run(reqs)
    for name, sp in (("acme", spA), ("bolt", spB)):
        mine = [r for r in reqs if r.tenant == name]
        want = _dedicated(cfg, sp, mine, n_slots=1, n_blocks=64)
        for r in mine:
            np.testing.assert_array_equal(
                rep.per_tenant[name].outputs[r.rid], want.outputs[r.rid],
                err_msg=f"{r.rid}: cross-tenant prefix contamination")
        pfx = rep.per_tenant[name].prefix
        # each tenant hits only its OWN earlier insertion
        assert pfx["lookups"] == 2
        assert pfx["hits"] <= 1


def test_unknown_tenant_rejected(model):
    cfg, spA, _ = model
    gw = _gateway([_tenant("acme", cfg, spA)])
    with pytest.raises(ValueError, match="unknown tenant"):
        gw.run([Request("x", np.arange(4), 2, tenant="ghost")])


def test_gateway_is_greedy_only(model):
    cfg, spA, _ = model
    with pytest.raises(ValueError, match="greedy"):
        Gateway([_tenant("acme", cfg, spA)],
                scfg=ServeConfig(temperature=0.7), device="cpu")


# ---------------------------------------------------------------------------
# hot-swap
# ---------------------------------------------------------------------------


def test_hot_swap_inplace_zero_recompiles(model):
    """Mid-run swap to a same-envelope packing: serving continues, the
    swap lands, and the tenant's build counter records ZERO rebuilds
    after it."""
    cfg, spA, spB = model
    reqs = _trace(cfg, "acme", n=6, seed=9, max_new=8)
    t = _tenant("acme", cfg, spA)
    gw = _gateway([t], n_slots=2, block_size=4, n_blocks=48)
    rep = gw.run(reqs, swaps=[SwapEvent(at_step=3, tenant="acme", sp=spB)])
    assert len(rep.swaps) == 1
    assert rep.swaps[0]["mode"] == "inplace"
    assert rep.swaps[0]["recompiles_after_swap"] == 0
    assert t.sp is spB  # the swap actually landed
    assert set(rep.per_tenant["acme"].outputs) == {r.rid for r in reqs}


def test_hot_swap_drops_the_tenants_cached_prefixes(model):
    """A request admitted after a swap never adopts prefix blocks computed
    with the old weights: the swapped tenant's trie is cleared (the
    reference keeps it), so its tokens equal a dedicated server's on the
    new weights."""
    cfg, spA, spB = model
    rng = np.random.default_rng(19)
    shared = rng.integers(0, cfg.vocab, 12)
    reqs = [Request(f"s{i}", np.concatenate([shared, rng.integers(
        0, cfg.vocab, 3)]), 6, tenant="acme") for i in range(2)]
    gw = _gateway([_tenant("acme", cfg, spA)], n_slots=1, block_size=4,
                  n_blocks=48)
    rep = gw.run(reqs, swaps=[SwapEvent(at_step=2, tenant="acme", sp=spB)])
    assert rep.swaps[0]["prefix_blocks_dropped"] == 3
    assert rep.per_tenant["acme"].prefix["hits"] == 0
    want = _dedicated(cfg, spB, reqs[1:], n_slots=1)
    np.testing.assert_array_equal(rep.per_tenant["acme"].outputs["s1"],
                                  want.outputs["s1"])


def test_hot_swap_mismatched_envelope_is_staged(model):
    """A packing with another stacked envelope (compressed BSR vs dense)
    rebuilds on the staged path and says so."""
    qcfg = registry.get_smoke_config("yi-6b", dtype="float32",
                                     cim_mode="qat")
    params = _init(qcfg, 2)
    spc = DP.compress(qcfg, params, target_sparsity=0.0, tile=(16, 16),
                      uniform=True)
    t = _tenant("acme", qcfg, DP.from_params(qcfg, params))
    rep = t.hot_swap(spc)
    assert rep["mode"] == "staged"
    assert rep["tile"] == [16, 16]
    assert t.compiles.n == 2  # the boot and the staged rebuild


def test_hot_swap_kv_geometry_mismatch_rejected(model):
    cfg, spA, _ = model
    other = dataclasses.replace(cfg, n_layers=cfg.n_layers + 1)
    t = _tenant("acme", cfg, spA)
    with pytest.raises(ValueError, match="KV geometry"):
        t.hot_swap(spA, cfg_new=other)


def test_registry_rejects_mixed_kv_geometry(model):
    cfg, spA, _ = model
    other = dataclasses.replace(cfg, n_layers=cfg.n_layers + 1)
    spO = DP.from_params(other, _init(other, 0))
    with pytest.raises(ValueError, match="geometries"):
        TenantRegistry([_tenant("a", cfg, spA), _tenant("b", other, spO)])


# ---------------------------------------------------------------------------
# overload: priority sheds + SLO protection
# ---------------------------------------------------------------------------


def test_overflow_sheds_strictly_lowest_priority_first(model):
    """A queue bounded below the offered load: every shed victim has the
    lowest priority present, the high-priority tenant is fully served, and
    its TTFT p50 stays within its (generous) SLO."""
    cfg, spA, spB = model
    hi = _trace(cfg, "hi", n=5, seed=1, priority=2, max_new=5)
    lo = _trace(cfg, "lo", n=5, seed=2, priority=0, max_new=5)
    gw = _gateway([_tenant("hi", cfg, spA, priority=2,
                           slo=TenantSLO(ttft_ms=120000)),
                   _tenant("lo", cfg, spB, priority=0)],
                  n_slots=2, block_size=4, n_blocks=48, max_pending=6)
    rep = gw.run(hi + lo)
    assert rep.shed, "a bounded queue under 10 requests must shed"
    assert all(ev["priority"] == 0 for ev in rep.shed), rep.shed
    assert all(ev["reason"] == "queue_overflow" for ev in rep.shed)
    assert set(rep.per_tenant["hi"].outputs) == {r.rid for r in hi}
    meta = rep.tenant_meta["hi"]
    assert meta["slo_attainment"]["ttft_p50_ms"] <= 120000
    assert meta["slo_attainment"]["ttft"] == 1.0
    # sheds are counted, never silent
    assert rep.admission["n_shed"] == len(rep.shed)


def test_deadline_shed_and_backlog_shed(model):
    """An unmeetable deadline sheds at once; a zero backlog budget sheds by
    the overload rule - both with reasons, both priced first."""
    cfg, spA, _ = model
    t = _tenant("acme", cfg, spA)
    ctrl = AdmissionController(pricer=Pricer())
    dead = Request("late", np.arange(6), 4, tenant="acme", deadline=1e-12)
    price = ctrl.price(t, dead)
    assert price.total_s > 0
    assert ctrl.decide(t, dead, now=1.0, price=price) == ("shed", "deadline")
    tight = AdmissionController(pricer=Pricer(), max_backlog_s=0.0)
    ok = Request("r", np.arange(6), 4, tenant="acme")
    p2 = tight.price(t, ok)
    assert tight.decide(t, ok, now=0.0, price=p2) == ("shed", "overload")


def test_quota_defers_then_serves(model):
    """A tiny token-rate quota DEFERS (never sheds) the over-quota tail;
    everything still completes once the window refills."""
    cfg, spA, _ = model
    reqs = _trace(cfg, "acme", n=3, seed=5, max_new=4)
    gw = _gateway([_tenant("acme", cfg, spA,
                           slo=TenantSLO(token_rate=30.0))],
                  n_slots=2, block_size=4, n_blocks=48)
    rep = gw.run(reqs)
    assert set(rep.per_tenant["acme"].outputs) == {r.rid for r in reqs}
    assert rep.admission["n_shed"] == 0


# ---------------------------------------------------------------------------
# RequestQueue priority/deadline semantics
# ---------------------------------------------------------------------------


def test_queue_pops_priority_then_fifo():
    reqs = [Request("a", np.arange(3), 1, priority=0),
            Request("b", np.arange(3), 1, priority=2),
            Request("c", np.arange(3), 1, priority=2),
            Request("d", np.arange(3), 1, priority=1)]
    q = RequestQueue(reqs)
    assert [q.pop_ready(0.0).rid for _ in range(4)] == ["b", "c", "d", "a"]


def test_queue_requeue_goes_to_front_of_class():
    reqs = [Request("a", np.arange(3), 1, priority=1),
            Request("b", np.arange(3), 1, priority=1)]
    q = RequestQueue(reqs)
    first = q.pop_ready(0.0)
    q.requeue(first)
    assert q.pop_ready(0.0).rid == "a"  # the deferred head stays the head


def test_queue_overflow_evicts_lowest_priority_newest():
    q = RequestQueue(max_pending=2)
    assert q.push(Request("a", np.arange(3), 1, priority=1)) is None
    assert q.push(Request("b", np.arange(3), 1, priority=0)) is None
    shed = q.push(Request("c", np.arange(3), 1, priority=2))
    assert shed is not None and shed.rid == "b"  # lowest priority loses
    assert q.n_shed == 1
    # an incoming request BELOW everything queued sheds itself
    shed2 = q.push(Request("d", np.arange(3), 1, priority=-1))
    assert shed2 is not None and shed2.rid == "d"
    assert len(q) == 2


def test_request_deadline_validation():
    with pytest.raises(ValueError, match="deadline"):
        Request("r", np.arange(3), 1, arrival=5.0, deadline=1.0)


# ---------------------------------------------------------------------------
# artifact validation + scoped metrics satellites
# ---------------------------------------------------------------------------


def test_load_artifact_rejects_wrong_arch(tmp_path, model):
    cfg, spA, _ = model
    root = str(tmp_path / "art")
    DP.save_artifact(root, spA, cfg)
    with pytest.raises(ValueError, match="expected.*found|arch"):
        DP.load_artifact_tiers(root, arch="llama-7b", device="cpu")


def test_load_artifact_rejects_wrong_tile(tmp_path):
    qcfg = registry.get_smoke_config("yi-6b", dtype="float32",
                                     cim_mode="qat")
    spc = DP.compress(qcfg, _init(qcfg, 0), target_sparsity=0.0,
                      tile=(16, 16), uniform=True)
    root = str(tmp_path / "art")
    DP.save_artifact(root, spc, qcfg)
    meta = DP.load_artifact_extra(root)
    assert meta["schema"] == DP.ARTIFACT_SCHEMA
    assert meta["tiles"] == [[16, 16]]
    with pytest.raises(ValueError, match=r"8.*8|tile"):
        DP.load_artifact_tiers(root, tile=(8, 8), device="cpu")
    # matching expectations load fine
    sp2, _, _ = DP.load_artifact_tiers(root, arch=qcfg.name, tile=(16, 16),
                                       device="cpu")
    assert sp2 is not None


def test_validate_artifact_refuses_newer_schema(tmp_path, model):
    cfg, spA, _ = model
    root = str(tmp_path / "art")
    DP.save_artifact(root, spA, cfg)
    mpath = tmp_path / "art" / "step_00000000" / "manifest.json"
    meta = json.loads(mpath.read_text())
    meta["extra"]["schema"] = DP.ARTIFACT_SCHEMA + 1
    mpath.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="schema"):
        DP.load_artifact_tiers(root, device="cpu")


def test_scoped_metrics_inject_tenant_label():
    reg = MetricsRegistry()
    sm = ScopedMetrics(reg, tenant="acme")
    sm.counter("requests_finished").inc()
    sm.counter("gateway_shed_total", reason="deadline").inc(2)
    snap = reg.snapshot()
    assert snap["counters"]["requests_finished{tenant=acme}"] == 1
    assert snap["counters"][
        "gateway_shed_total{reason=deadline,tenant=acme}"] == 2


def test_gateway_reports_tenant_labeled_metrics(model):
    cfg, spA, _ = model
    reqs = _trace(cfg, "acme", n=2, seed=13, max_new=3)
    reg = MetricsRegistry()
    gw = Gateway([_tenant("acme", cfg, spA)],
                 GatewayConfig(n_slots=2, block_size=4, n_blocks=48),
                 metrics=reg, device="cpu")
    gw.run(reqs)
    snap = reg.snapshot()
    assert snap["counters"]["requests_finished{tenant=acme}"] == 2
    assert snap["counters"]["decode_steps{tenant=acme}"] >= 1


# ---------------------------------------------------------------------------
# the port's own contracts: envelope signature, devices
# ---------------------------------------------------------------------------


def test_envelope_signature_sees_tile_bits_and_shapes():
    """Equal for two packings of one envelope (other weights, same masks),
    different for another tile, other bits or another layer count; the
    in-place swap then builds nothing and keeps the caller's packing
    untouched."""
    qcfg = registry.get_smoke_config("yi-6b", dtype="float32",
                                     cim_mode="qat")
    params = _init(qcfg, 3)
    neg = {**params, "layers": {k: -v for k, v in params["layers"].items()},
           "head": -params["head"]}

    def pack(p, tile=(16, 16), **kw):
        return DP.compress(dataclasses.replace(qcfg, **kw), p,
                           target_sparsity=0.5, tile=tile, uniform=True)

    from repro_torch.serve import stacked
    sig = lambda sp: envelope_signature(stacked.stack(sp))
    a, b = pack(params), pack(neg)
    assert sig(a) == sig(b)
    assert sig(a) != sig(pack(params, tile=(8, 16)))
    assert sig(a) != sig(DP.from_params(qcfg, params))
    t = _tenant("acme", qcfg, a)
    before = [v.clone() for v in t.params.packed["wq"].blocks]
    rep = t.hot_swap(b)
    assert rep["mode"] == "inplace" and t.compiles.n == 1 and t.sp is b
    for x, y in zip(before, stacked.stack(a).packed["wq"].blocks):
        assert torch.equal(x, y)  # the old packing was not written into


def test_prefill_device_refused_past_the_visible_devices(model):
    cfg, spA, _ = model
    t = _tenant("acme", cfg, spA)
    Gateway([t], GatewayConfig(prefill_device=0), device="cpu")
    with pytest.raises(ValueError, match="prefill_device=1"):
        Gateway([t], GatewayConfig(prefill_device=1), device="cpu")


def test_gateway_defaults_to_the_card(model, monkeypatch):
    """No quiet CPU fallback: a gateway asked for the card (the default)
    raises without one, and CPU params behind a cuda gateway are
    refused."""
    cfg, spA, _ = model
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        Gateway([_tenant("acme", cfg, spA)])
    monkeypatch.setattr("torch.cuda.is_available", lambda: True)
    with pytest.raises(ValueError, match="live on cpu"):
        Gateway([_tenant("acme", cfg, spA)])


@pytest.mark.cuda
def test_gateway_on_gpu():
    """Smoke yi-6b compressed (QAT, 16x16) on the card: two tenants'
    tokens equal dedicated scan servers', unchunked; the block-sparse and
    attention kernels launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.kernels import cim_bsr_matmul as TK
    qcfg = registry.get_smoke_config("yi-6b", dtype="float32",
                                     cim_mode="qat")
    sps = []
    for seed in (0, 1):
        p = registry.model_fns(qcfg).init_params(
            qcfg, torch.Generator(device="cuda").manual_seed(seed),
            device="cuda")
        sps.append(DP.compress(qcfg, p, target_sparsity=0.5, tile=(16, 16),
                               uniform=True))
    reqs = {n: _trace(qcfg, n, seed=s) for n, s in (("acme", 3),
                                                     ("bolt", 4))}
    before = TK.LAUNCHES
    rep = Gateway([TenantRuntime("acme", qcfg, sps[0]),
                   TenantRuntime("bolt", qcfg, sps[1])],
                  GatewayConfig(n_slots=3, block_size=4, n_blocks=48)).run(
        reqs["acme"] + reqs["bolt"])
    assert TK.LAUNCHES > before
    for sp, name in zip(sps, ("acme", "bolt")):
        want = BatchServer(qcfg, sp, ServeConfig(),
                           BatchConfig(n_slots=3, block_size=4, n_blocks=48),
                           engine="scan").run(
            [Request(r.rid, r.prompt, r.max_new_tokens)
             for r in reqs[name]])
        for r in reqs[name]:
            np.testing.assert_array_equal(rep.per_tenant[name].outputs[r.rid],
                                          want.outputs[r.rid])


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def both():
    """(reference cfg, port cfg, [(reference sp, port sp)] for seeds 0 and
    1): the reference's own weights, carried across."""
    import jax
    from repro.models import registry as RR
    from repro.serve import deployed as RDP
    rcfg = RR.get_smoke_config("yi-6b", dtype="float32")
    tcfg = registry.get_smoke_config("yi-6b", dtype="float32")
    pairs = []
    for seed in (0, 1):
        rp = RR.model_fns(rcfg).init_params(rcfg, jax.random.PRNGKey(seed))
        tp = convert.params_from_numpy(jax.tree.map(np.asarray, rp), tcfg,
                                       device="cpu")
        pairs.append((RDP.from_params(rcfg, rp), DP.from_params(tcfg, tp)))
    return rcfg, tcfg, pairs


@pytest.mark.parametrize("chunk", [0, 4], ids=["unchunked", "chunked"])
def test_two_tenant_gateway_tokens_equal_reference(both, chunk):
    """Both gateways over the same two tenants and requests (a queue
    bounded below the load, so the reference's sheds are the port's too):
    equal tokens per tenant and equal shed events."""
    from repro.gateway import Gateway as RGateway
    from repro.gateway import GatewayConfig as RGatewayConfig
    from repro.gateway import TenantRuntime as RTenantRuntime
    from repro.serve import Request as RRequest
    rcfg, tcfg, pairs = both
    knobs = dict(n_slots=3, block_size=4, n_blocks=64, prefill_chunk=chunk,
                 max_pending=7)
    spec = (("acme", 3, 1, 20), ("bolt", 4, 0, 12))
    rreqs, treqs = [], []
    for name, seed, prio, longest in spec:
        rreqs += _trace(rcfg, name, n=4, seed=seed, priority=prio,
                        max_prompt=longest, Req=RRequest)
        treqs += _trace(tcfg, name, n=4, seed=seed, priority=prio,
                        max_prompt=longest)
    rgw = RGateway([RTenantRuntime(n, rcfg, r, priority=p)
                    for (n, _, p, _), (r, _) in zip(spec, pairs)],
                   RGatewayConfig(**knobs))
    tgw = _gateway([_tenant(n, tcfg, t, priority=p)
                    for (n, _, p, _), (_, t) in zip(spec, pairs)], **knobs)
    want, got = rgw.run(rreqs), tgw.run(treqs)
    strip = lambda evs: [{k: e[k] for k in ("rid", "tenant", "priority",
                                             "reason")} for e in evs]
    assert strip(got.shed) == strip(want.shed) and got.shed
    for name, _, _, _ in spec:
        w, g = want.per_tenant[name], got.per_tenant[name]
        assert sorted(g.outputs) == sorted(w.outputs)
        for rid, toks in w.outputs.items():
            np.testing.assert_array_equal(g.outputs[rid], np.asarray(toks),
                                          err_msg=f"{name} {rid}")
        assert g.prefix == w.prefix


def test_admission_verdicts_equal_reference(both):
    """A seeded sequence of requests - deadlines near their price, a
    token-rate quota on one tenant, a backlog ceiling, releases - through
    both controllers at the same clock: the same price, verdict, reason and
    backlog after every step, and the same stats."""
    from repro.gateway import AdmissionController as RController
    from repro.gateway import TenantRuntime as RTenantRuntime
    from repro.gateway import TenantSLO as RSLO
    from repro.sched.pricing import Pricer as RPricer
    from repro.serve import Request as RRequest
    rcfg, tcfg, pairs = both
    (rspA, tspA), (rspB, tspB) = pairs
    rt = [RTenantRuntime("acme", rcfg, rspA, sparsity=0.5,
                         slo=RSLO(token_rate=40.0)),
          RTenantRuntime("bolt", rcfg, rspB)]
    tt = [_tenant("acme", tcfg, tspA, sparsity=0.5,
                  slo=TenantSLO(token_rate=40.0)),
          _tenant("bolt", tcfg, tspB)]
    unit = Pricer().price_request(tcfg, 16, 8, 0.0).total_s
    rc = RController(pricer=RPricer(), max_backlog_s=3 * unit)
    tc = AdmissionController(pricer=Pricer(), max_backlog_s=3 * unit)
    rng = np.random.default_rng(17)
    now, live, verdicts = 0.0, [], set()
    for i in range(60):
        k = int(rng.integers(0, 2))
        plen, new = int(rng.integers(2, 40)), int(rng.integers(1, 12))
        prompt = rng.integers(0, tcfg.vocab, plen)
        deadline = (None if rng.random() < 0.5
                    else now + float(rng.uniform(0.2, 3.0)) * unit)
        kw = dict(tenant=tt[k].name, arrival=now, deadline=deadline)
        rr = RRequest(f"q{i}", prompt, new, **kw)
        tr = Request(f"q{i}", prompt, new, **kw)
        rp, tp = rc.price(rt[k], rr), tc.price(tt[k], tr)
        assert tp.to_json() == rp.to_json() and tp.total_s == rp.total_s
        v = tc.decide(tt[k], tr, now, tp)
        assert v == rc.decide(rt[k], rr, now, rp), i
        verdicts.add(v)
        if v[0] == "admit":
            rc.commit(rt[k], rr, rp)
            tc.commit(tt[k], tr, tp)
            live.append((rp, tp))
        elif v[0] == "shed":
            rc.record_shed(rr, v[1], now)
            tc.record_shed(tr, v[1], now)
        else:
            rc.record_defer()
            tc.record_defer()
        if live and rng.random() < 0.4:
            r_, t_ = live.pop(int(rng.integers(0, len(live))))
            rc.release(r_)
            tc.release(t_)
        assert tc.backlog_s == rc.backlog_s
        now += float(rng.uniform(0.0, 0.5)) * unit
    assert tc.stats() == rc.stats()
    assert [e.to_json() for e in tc.shed_events] == \
        [e.to_json() for e in rc.shed_events]
    assert {v[1] for v in verdicts} == {"ok", "deadline", "quota",
                                        "overload"}


def test_request_queue_order_equals_reference():
    """A seeded random sequence of push (with arrivals and priorities),
    requeue and pop over bounded queues: the same pops, the same sheds."""
    from repro.serve import Request as RRequest
    from repro.serve import RequestQueue as RQueue
    rng = np.random.default_rng(23)
    rq, tq = RQueue(max_pending=5), RequestQueue(max_pending=5)
    popped, log = [], []
    for i in range(300):
        op = rng.random()
        now = float(i) * 0.1
        if op < 0.55:
            kw = dict(arrival=now + float(rng.uniform(0.0, 1.0)),
                      priority=int(rng.integers(-1, 3)))
            r = rq.push(RRequest(f"q{i}", np.arange(3), 1, **kw))
            t = tq.push(Request(f"q{i}", np.arange(3), 1, **kw))
            log.append(("push", r and r.rid, t and t.rid))
        elif op < 0.7 and popped:
            rid = popped.pop(int(rng.integers(0, len(popped))))
            rq.requeue(rid[0])
            tq.requeue(rid[1])
            log.append(("requeue", rid[0].rid, rid[1].rid))
        else:
            r, t = rq.pop_ready(now), tq.pop_ready(now)
            log.append(("pop", r and r.rid, t and t.rid))
            if r is not None and t is not None:
                popped.append((r, t))
        assert len(rq) == len(tq) and rq.next_arrival() == tq.next_arrival()
    assert all(e[1] == e[2] for e in log), [e for e in log if e[1] != e[2]]
    assert tq.n_shed == rq.n_shed > 0
    assert sum(e[0] == "pop" and e[1] is not None for e in log) > 20
