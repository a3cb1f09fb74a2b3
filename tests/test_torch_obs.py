"""The port's observability (``repro_torch.obs`` and
``repro_torch.kernels.timing``) against the reference's.

The port's trace and metrics files must pass the REFERENCE's validators
(``repro.obs.validate_chrome_trace``/``validate_metrics_snapshot``), the
validators must agree on malformed input, an instrumented ``BatchServer``
must emit the reference's phase names and counters and the same tokens as
an uninstrumented one, and a disabled ``DispatchTimer`` must never fence.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro import obs as RO
from repro.kernels import timing as RTIM
from repro.models import registry as RR
from repro.serve import deployed as RDP
from repro_torch import convert, obs as TO
from repro_torch.kernels import timing as TTIM
from repro_torch.launch import serve as TSERVE
from repro_torch.models import registry as TR
from repro_torch.serve import BatchConfig, BatchServer, Request, ServeConfig
from repro_torch.serve import spec as TSP

# the phases and counters the reference's BatchServer records
STEP_PHASES = {"prefill", "step.gather", "step.dispatch", "step.writeback",
               "step.sample", "step.admit", "decode_step"}
SPEC_PHASES = {"prefill", "step.admit", "decode_step", "spec.draft",
               "spec.verify", "spec.commit"}
COUNTERS = {"prefix_lookups", "prefix_hits", "prefix_tokens_reused",
            "requests_finished", "decode_steps"}
GAUGES = {"prefix_trie_blocks", "slots_active", "kv_blocks_in_use",
          "kv_utilization"}


@pytest.fixture(scope="module")
def served():
    """The smoke yi-6b in f32, the reference's packing carried across."""
    rcfg = RR.get_smoke_config("yi-6b", dtype="float32")
    tcfg = TR.get_smoke_config("yi-6b", dtype="float32")
    params = RR.model_fns(rcfg).init_params(rcfg, jax.random.PRNGKey(0))
    rsp = RDP.compress(rcfg, params, target_sparsity=0.6, tile=(16, 16),
                       uniform=True)

    def leaf(v):
        if hasattr(v, "packed"):
            return {"packed": [{k: np.asarray(a) for k, a in p.items()}
                               for p in v.packed],
                    "d_in": v.d_in, "d_out": v.d_out, "bits": v.bits}
        return None if v is None else np.asarray(v)

    tree = {"embed": leaf(rsp.embed), "final_ln": leaf(rsp.final_ln),
            "layers": [{k: leaf(v) for k, v in p.items()}
                       for p in rsp.layers],
            "head": leaf(rsp.head), "head_t": leaf(rsp.head_t)}
    return tcfg, convert.serving_params_from_numpy(tree, tcfg, device="cpu")


def _trace():
    rng = np.random.default_rng(3)
    shared = rng.integers(0, 256, 16)
    return [Request(f"r{i}", (np.concatenate([shared, rng.integers(
        0, 256, 2 + i)]) if i % 2 == 0 else rng.integers(0, 256, 4 + i)
    ).astype(np.int32), 5 + i) for i in range(4)]


def _run(served, engine, tracer=None, metrics=None, family="layerskip"):
    tcfg, tsp = served
    kw = {}
    if engine == "spec":
        kw = {"spec": TSP.SpecConfig(k=3, draft=family),
              "draft": (TSP.draft_serving(tcfg, tsp, 0.9)
                        if family == "reprune" else None)}
    return BatchServer(tcfg, tsp, ServeConfig(),
                       BatchConfig(n_slots=2, block_size=8, n_blocks=48),
                       engine=engine, device="cpu", tracer=tracer,
                       metrics=metrics, **kw).run(_trace())


@pytest.mark.parametrize("engine", ["loop", "scan", "spec"])
def test_instrumented_server_same_tokens_and_reference_schema(served,
                                                              engine):
    """Tracing and metrics change no token; the Chrome trace and the
    snapshot pass the reference's validators and the port's; the phases,
    counters and gauges are the reference's names."""
    plain = _run(served, engine)
    tracer, metrics = TO.Tracer(), TO.MetricsRegistry()
    rep = _run(served, engine, tracer, metrics)
    for rid, toks in plain.outputs.items():
        np.testing.assert_array_equal(rep.outputs[rid], toks, err_msg=rid)
    assert plain.metrics is None and rep.metrics is not None
    chrome = json.loads(json.dumps(tracer.to_chrome()))
    n = RO.validate_chrome_trace(chrome)
    assert n == TO.validate_chrome_trace(chrome) > 0
    snap = json.loads(json.dumps(rep.metrics))
    assert RO.validate_metrics_snapshot(snap) == \
        TO.validate_metrics_snapshot(snap) > 0
    spans = {e["name"] for e in chrome["traceEvents"] if e["ph"] == "X"}
    want = SPEC_PHASES if engine == "spec" else STEP_PHASES
    assert want <= spans, want - spans
    assert {f"req:r{i}" for i in range(4)} <= spans
    assert COUNTERS <= set(snap["counters"])
    assert GAUGES <= set(snap["gauges"])
    assert snap["counters"]["requests_finished"] == 4
    assert snap["counters"]["prefix_hits"] >= 1
    phases = {k for k in snap["histograms"] if k.startswith("serve_phase_s")}
    assert {f"serve_phase_s{{phase={p}}}" for p in want} <= phases
    if engine == "spec":  # the spec round is timed by its phases
        assert {"spec_accepted_tokens", "spec_rejected_tokens"} <= set(
            snap["counters"])
        assert rep.spec is not None and "spec" in rep.to_json()
        assert "kernel_dispatch" not in snap
    else:
        assert {r["name"] for r in snap["kernel_dispatch"]} == {
            f"decode.{engine}"}
        assert all(r["backend"] == "cpu" for r in snap["kernel_dispatch"])


def test_uninstrumented_server_uses_the_null_sinks(served):
    tcfg, tsp = served
    srv = BatchServer(tcfg, tsp, device="cpu", engine="scan")
    assert srv.tracer is TO.NULL_TRACER and srv.metrics is TO.NULL_METRICS
    assert not srv.timer.enabled
    assert TO.phase_scope(srv.tracer, srv.metrics, "x") is \
        TO.phase_scope(srv.tracer, srv.metrics, "y")


def test_disabled_timer_never_fences(monkeypatch):
    """A disabled timer forwards the call untouched: no fence, no clock,
    no record."""
    calls = []
    monkeypatch.setattr(TTIM, "_fence", lambda out: calls.append(out))
    monkeypatch.setattr(TTIM.time, "perf_counter",
                        lambda: calls.append("clock") or 0.0)
    timer = TTIM.DispatchTimer(enabled=False)
    x = torch.ones(3)
    out = timer.timed("k", (3,), None, torch.mul, x, 2.0)
    assert torch.equal(out, 2 * x) and calls == [] and timer.records == []
    assert not TTIM.TIMER.enabled


def test_enabled_timer_fences_and_records_like_the_reference(monkeypatch):
    fenced = []
    real = TTIM._fence
    monkeypatch.setattr(TTIM, "_fence",
                        lambda out: fenced.append(out) or real(out))
    reg, rreg = TO.MetricsRegistry(), RO.MetricsRegistry()
    timer = TTIM.DispatchTimer(metrics=reg)
    rtimer = RTIM.DispatchTimer(metrics=rreg)
    out = timer.timed("bsr", (4, 64), (16, 16), torch.add, torch.ones(2), 1)
    assert torch.equal(out, torch.full((2,), 2.0)) and len(fenced) == 1
    (rec,) = timer.records
    assert (rec.name, rec.shape, rec.tile, rec.backend) == (
        "bsr", (4, 64), (16, 16), "cpu")
    rtimer.record("bsr", rec.seconds, shape=(4, 64), tile=(16, 16),
                  backend="cpu")
    assert timer.summary() == rtimer.summary()
    assert sorted(reg.snapshot()["histograms"]) == \
        sorted(rreg.snapshot()["histograms"])
    timer.clear()
    assert timer.records == [] and timer.summary() == []


def test_fence_synchronizes_only_cuda_outputs(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: synced.append(device))
    TTIM._fence((torch.ones(1), [torch.zeros(2)]))
    TTIM._fence(None)
    assert synced == []
    assert TTIM._backend({"a": torch.ones(1)}) == "cpu"


def test_metrics_registry_equals_reference():
    """The same calls give the same snapshot: counters, gauges, labeled
    keys, exact-value histogram percentiles, scoped labels."""
    regs = (TO.MetricsRegistry(), RO.MetricsRegistry())
    rng = np.random.default_rng(0)
    vals = rng.exponential(1.0, 37).tolist()
    for reg, scoped in ((regs[0], TO.ScopedMetrics(regs[0], tenant="a")),
                        (regs[1], RO.ScopedMetrics(regs[1], tenant="a"))):
        reg.counter("tok").inc()
        reg.counter("tok").inc(4)
        reg.gauge("util", pool="kv").set(0.25)
        for v in vals:
            reg.histogram("lat", phase="x").observe(v)
        reg.histogram("empty")
        scoped.counter("tok", slot=1).inc(2)
        scoped.counter("tok", tenant="b").inc()
    assert regs[0].snapshot() == regs[1].snapshot()
    for reg in regs:
        reg.clear()
    assert regs[0].snapshot() == regs[1].snapshot()
    assert TO.NULL_METRICS.snapshot() == {} and not TO.NULL_METRICS.recording
    assert TO.ScopedMetrics(TO.NULL_METRICS, t="x").recording is False


def test_tracer_events_equal_reference_shape():
    """Spans, instants, counters, retroactive spans on named tracks and
    the metadata events, as the reference lays them out."""
    out = []
    for mod in (TO, RO):
        tr = mod.Tracer(process_name="p")
        with tr.span("outer", a=1):
            with tr.span("inner"):
                pass
        tr.instant("tick", n=2)
        tr.counter("serve", slots=3)
        tr.complete("req:r0", 0.0, 0.5, track="slot0", rid="r0")
        chrome = tr.to_chrome()
        out.append([(e["name"], e["ph"], e["tid"], e.get("args"))
                    for e in chrome["traceEvents"]])
        tr.clear()
        assert len(tr.to_chrome()["traceEvents"]) == 3  # metadata stays
    assert out[0] == out[1]
    assert TO.NULL_TRACER.to_chrome() == RO.NULL_TRACER.to_chrome()


@pytest.mark.parametrize("bad", [
    [], {"traceEvents": {}}, {"traceEvents": [1]},
    {"traceEvents": [{"name": "a", "ph": "X", "pid": 1}]},
    {"traceEvents": [{"name": "a", "ph": "Q", "pid": 1, "tid": 0}]},
    {"traceEvents": [{"name": "a", "ph": "X", "pid": 1, "tid": 0,
                      "ts": 0, "dur": -1}]},
    {"traceEvents": [{"name": "a", "ph": "C", "pid": 1, "tid": 0,
                      "ts": 0, "args": {"x": "y"}}]},
    {"traceEvents": [{"name": "a", "ph": "i", "pid": 1, "tid": 0}]}])
def test_trace_validator_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError) as got:
        TO.validate_chrome_trace(bad)
    with pytest.raises(ValueError) as want:
        RO.validate_chrome_trace(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("bad", [
    [], {"counters": {}, "gauges": {}}, {"counters": [], "gauges": {},
                                         "histograms": {}},
    {"counters": {"a": "x"}, "gauges": {}, "histograms": {}},
    {"counters": {}, "gauges": {}, "histograms": {"h": {}}},
    {"counters": {}, "gauges": {}, "histograms": {"h": {"count": 2}}}])
def test_metrics_validator_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError) as got:
        TO.validate_metrics_snapshot(bad)
    with pytest.raises(ValueError) as want:
        RO.validate_metrics_snapshot(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec", ["", "draft=layerskip,keep=0.5,k=2"])
def test_cli_trace_and_metrics_out_validate(tmp_path, capsys, spec):
    """``--trace-out``/``--metrics-out`` write the measured run's files;
    both pass the reference's validators, and the port's ``main``
    validators accept them; the tokens equal an uninstrumented run's."""
    trace, snap = str(tmp_path / "t.json"), str(tmp_path / "m.json")
    argv = ["--arch", "yi-6b", "--smoke", "--compressed", "--tile", "16x16",
            "--requests", "3", "--new-tokens", "4", "--device", "cpu",
            "--runtime", "scan"] + (["--spec", spec] if spec else [])
    plain = TSERVE.main(argv)
    rep = TSERVE.main(argv + ["--trace-out", trace, "--metrics-out", snap])
    for rid, toks in plain.outputs.items():
        np.testing.assert_array_equal(rep.outputs[rid], toks)
    assert RO.validate_chrome_trace_file(trace) > 0
    with open(snap) as f:
        assert RO.validate_metrics_snapshot(json.load(f)) > 0
    capsys.readouterr()
    TO.trace.main([trace])
    TO.metrics.main([snap])
    out = capsys.readouterr().out
    assert out.startswith(f"ok {trace}") and f"ok {snap}" in out
    with open(trace) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert ("spec.verify" if spec else "step.dispatch") in names
