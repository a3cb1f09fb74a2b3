"""The port's bench history (``repro_torch.obs.history``): the reference's
own history tests (``tests/test_obs.py``) run on the port with their
in-test rows and reports, and the port's flatteners and regression check
against the reference's on seeded random nested reports."""
import json

import numpy as np
import pytest

from repro_torch.obs import history


def _hist_row(ts, metrics, backend="cpu", arch="smoke"):
    return {"schema": history.SCHEMA_VERSION, "ts": ts, "git_sha": "abc1234",
            "backend": backend, "arch": arch, "metrics": metrics}


def test_history_append_load_round_trip(tmp_path):
    p = tmp_path / "hist.jsonl"
    r1 = history.make_row({"serve.gap": 3.0}, git_sha="s1", backend="cpu",
                          arch="smoke")
    r2 = history.make_row({"serve.gap": 3.1}, git_sha="s2", backend="cpu",
                          arch="smoke")
    history.append_row(str(p), r1)
    history.append_row(str(p), r2)
    rows = history.load_history(str(p))
    assert [r["git_sha"] for r in rows] == ["s1", "s2"]
    assert rows[0]["schema"] == history.SCHEMA_VERSION
    # appending a malformed row is refused before it hits the file
    with pytest.raises(ValueError):
        history.append_row(str(p), {"schema": "x"})
    assert len(history.load_history(str(p))) == 2


def test_history_load_rejects_malformed(tmp_path):
    p = tmp_path / "bad.jsonl"
    # line 1 is a valid row; line 2 is not JSON - the error names the line
    p.write_text(json.dumps(_hist_row("t0", {"m": 1.0})) + "\nnot json\n")
    with pytest.raises(ValueError, match="bad.jsonl:2"):
        history.load_history(str(p))
    # a structurally-bad row (valid JSON) is also rejected with its line
    p.write_text('{"schema": 1}\n')
    with pytest.raises(ValueError, match="bad.jsonl:1"):
        history.load_history(str(p))
    p2 = tmp_path / "bad2.jsonl"
    p2.write_text(json.dumps(_hist_row("t", {"m": "NaN-string"})) + "\n")
    with pytest.raises(ValueError):
        history.load_history(str(p2))


def test_history_check_needs_baseline():
    # a single row has nothing to regress against: green, no findings
    assert history.check_history([_hist_row("t0", {"serve.gap": 3.0})]) == []


def test_history_check_flags_gap_drift_and_throughput_drop():
    rows = [
        _hist_row("t0", {"serve.gap": 3.0, "serve.s.tokens_per_s": 50.0}),
        _hist_row("t1", {"serve.gap": 3.2, "serve.s.tokens_per_s": 52.0}),
        _hist_row("t2", {"serve.gap": 30.0, "serve.s.tokens_per_s": 5.0}),
    ]
    kinds = {f["kind"] for f in history.check_history(rows)}
    assert kinds == {"gap-drift", "throughput-drop"}
    # drift fires in BOTH directions (a 10x better gap is also suspicious)
    rows[2]["metrics"] = {"serve.gap": 0.1, "serve.s.tokens_per_s": 52.0}
    assert [f["kind"] for f in history.check_history(rows)] == ["gap-drift"]
    # within tolerance: green
    rows[2]["metrics"] = {"serve.gap": 3.4, "serve.s.tokens_per_s": 48.0}
    assert history.check_history(rows) == []


def test_history_check_groups_by_backend_and_arch():
    # a cpu baseline must never judge a tpu row
    rows = [
        _hist_row("t0", {"serve.gap": 3.0}, backend="cpu"),
        _hist_row("t1", {"serve.gap": 3.0}, backend="cpu"),
        _hist_row("t2", {"serve.gap": 300.0}, backend="tpu"),
    ]
    assert history.check_history(rows) == []


def test_history_flatten_bench_reports():
    sched = {"vgg16_w8a8": {
        "fps_searched": 100.0,
        "sim_vs_measured": {"sim_vs_measured": 60.0,
                            "post_refit": {"gap": 0.7}}}}
    m = history.flatten_sched(sched)
    assert m == {"sched.vgg16_w8a8.gap": 60.0,
                 "sched.vgg16_w8a8.gap_post_refit": 0.7,
                 "sched.vgg16_w8a8.fps_searched": 100.0}
    serve = {"arch": "yi-6b",
             "sim_vs_measured": {"sim_vs_measured": 3.0},
             "sharded": {"sim_vs_measured": {"sim_vs_measured": 5.0}},
             "scan": {"tokens_per_s": 400.0}}
    s = history.flatten_serve(serve)
    assert s["serve.gap"] == 3.0
    assert s["serve.sharded.gap"] == 5.0
    assert s["serve.scan.tokens_per_s"] == 400.0


def test_history_tracks_spec_acceptance():
    serve = {"arch": "yi-6b",
             "spec": {"tokens_per_s": 300.0},
             "spec_vs_scan": {"acceptance_rate": 0.62,
                              "tokens_per_s_spec": 300.0}}
    s = history.flatten_serve(serve)
    assert s["serve.spec.tokens_per_s"] == 300.0
    assert s["serve.spec_vs_scan.acceptance_rate"] == 0.62
    # acceptance gates like throughput: a large relative drop regresses
    rows = [history.make_row(
        {"serve.spec_vs_scan.acceptance_rate": v}, backend="cpu",
        arch="yi-6b") for v in (0.6, 0.6, 0.1)]
    findings = history.check_history(rows)
    assert [f["metric"] for f in findings] == \
        ["serve.spec_vs_scan.acceptance_rate"]
    assert findings[0]["kind"] == "throughput-drop"
    assert not history.check_history(rows[:2] + [
        history.make_row({"serve.spec_vs_scan.acceptance_rate": 0.55},
                         backend="cpu", arch="yi-6b")])


def test_history_cli_end_to_end(tmp_path, capsys):
    p = tmp_path / "h.jsonl"
    sched_p = tmp_path / "BENCH_sched.json"
    sched_p.write_text(json.dumps({"net_w8a8": {
        "fps_searched": 10.0,
        "sim_vs_measured": {"sim_vs_measured": 50.0,
                            "post_refit": {"gap": 0.9}}}}))
    args = ["append", "--out", str(p), "--sched", str(sched_p),
            "--sha", "deadbee", "--backend", "cpu", "--arch", "bench"]
    history.main(args)  # returns without raising on success
    history.main(args)
    capsys.readouterr()
    history.main(["check", str(p)])
    assert "no regressions" in capsys.readouterr().out
    # inject a regression: check exits 1, --warn-only exits 0
    bad = history.make_row({"sched.net_w8a8.gap": 5000.0,
                            "sched.net_w8a8.fps_searched": 1.0},
                           git_sha="bad", backend="cpu", arch="bench")
    history.append_row(str(p), bad)
    with pytest.raises(SystemExit) as ei:
        history.main(["check", str(p)])
    assert ei.value.code == 1
    capsys.readouterr()
    history.main(["check", str(p), "--warn-only"])  # warn-only: no exit
    assert "REGRESSION" in capsys.readouterr().out
    # malformed history hard-fails with exit 2 even under --warn-only
    badfile = tmp_path / "corrupt.jsonl"
    badfile.write_text("not json\n")
    with pytest.raises(SystemExit) as ei:
        history.main(["check", str(badfile), "--warn-only"])
    assert ei.value.code == 2


def _random_report(rng, depth=0):
    """A nested report: known keys (gap ratios, tokens/s, acceptance,
    gateway tenants) mixed with noise keys, some values of the wrong
    type."""
    def num():
        return float(np.round(rng.uniform(0.01, 500.0), 4))

    out = {}
    for i in range(int(rng.integers(1, 5))):
        pick = rng.random()
        name = f"k{depth}_{i}"
        if pick < 0.2:
            out[name] = {"sim_vs_measured": {"sim_vs_measured": num(),
                                             **({"post_refit": {"gap": num()}}
                                                if rng.random() < 0.5
                                                else {})},
                         **({"fps_searched": num()} if rng.random() < 0.5
                            else {})}
        elif pick < 0.4:
            out[name] = {"tokens_per_s": num()}
        elif pick < 0.5 and depth < 2:
            out[name] = _random_report(rng, depth + 1)
        else:
            out[name] = [num()] if rng.random() < 0.5 else "text"
    if rng.random() < 0.6:
        out["sim_vs_measured"] = {"sim_vs_measured": num()}
    if rng.random() < 0.5:
        out["sharded"] = {"sim_vs_measured": {"sim_vs_measured": num()}}
    if rng.random() < 0.5:
        out["prefix_skew"] = {"hit_rate": num(), "tokens_per_s": num()}
    if rng.random() < 0.5:
        out["spec_vs_scan"] = {"acceptance_rate": num()}
    if rng.random() < 0.6:
        out["gateway_two_tenant"] = {"tenants": {
            t: {"goodput_tokens_per_s": num(),
                **({"slo_attainment": {"ttft": num()}}
                   if rng.random() < 0.6 else {"slo_attainment": None})}
            for t in ("acme", "bolt")[:int(rng.integers(1, 3))]}}
    return out


def test_history_equals_reference_on_random_reports():
    """``flatten_serve``, ``flatten_sched`` and ``check_history`` equal the
    reference's on seeded random nested reports and histories."""
    from repro.obs import history as RH
    rng = np.random.default_rng(31)
    rows = []
    for i in range(40):
        rep = _random_report(rng)
        assert history.flatten_serve(rep) == RH.flatten_serve(rep)
        sched = {k: v for k, v in rep.items() if isinstance(v, dict)}
        assert history.flatten_sched(sched) == RH.flatten_sched(sched)
        metrics = {**RH.flatten_serve(rep), **RH.flatten_sched(sched)}
        if metrics:
            rows.append(RH.make_row(metrics, git_sha=f"s{i}",
                                    backend=["cpu", "gpu"][i % 2],
                                    arch=["a", "b"][(i // 2) % 2],
                                    ts=f"t{i}"))
        for tol in ((4.0, 0.5), (1.5, 0.1)):
            assert history.check_history(rows, *tol) == \
                RH.check_history(rows, *tol)
    assert len(rows) > 20
    assert RH.check_history(rows, 1.5, 0.1)  # the comparison saw findings
    assert history.make_row({"m": 1}, ts="t") == RH.make_row({"m": 1},
                                                             ts="t")
