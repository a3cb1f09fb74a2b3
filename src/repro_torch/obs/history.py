"""Append-only bench history + tolerance-band regression gate.

Every BENCH_*.json the benchmarks emit is a one-shot snapshot; the gap
contract (``repro_torch.obs.gap``) says the tracked signal is DRIFT, which needs
history. This module is that history: one JSONL row per bench run, keyed by
git sha / backend / arch, carrying the flattened regression-trackable
numbers (gap ratios, tokens/s, searched FPS). ``check_history`` compares
the newest row of each (backend, arch) group against the median of its
predecessors inside a tolerance band - gap ratios may drift by at most a
multiplicative factor either way, throughput may drop by at most a
fraction - and the ``python -m repro_torch.obs.history`` CLI turns that into a
CI gate (warn-only on noisy forced-CPU runners; malformed history ALWAYS
fails hard, schema rot is never a warning).

Dependency-free like the rest of the obs core: stdlib only.
"""
from __future__ import annotations

import json
import math
import os
import time
from typing import Any, Dict, List, Optional, Sequence

SCHEMA_VERSION = 1

# Regression tolerances. The gap band is deliberately generous: CI runs
# the kernels' plain versions on shared runners where 2-3x wall-clock noise
# is real; 4x either way is drift no runner explains.
GAP_TOL = 4.0
DROP_TOL = 0.5
MIN_HISTORY = 1  # prior rows required in a group before gating


# ---------------------------------------------------------------------------
# Row construction: flatten BENCH_*.json into regression-trackable metrics
# ---------------------------------------------------------------------------


def flatten_sched(bench: Dict[str, Any]) -> Dict[str, float]:
    """BENCH_sched.json -> {metric: value} (gap ratios + searched FPS)."""
    out: Dict[str, float] = {}
    for key, e in bench.items():
        gap = e.get("sim_vs_measured", {})
        if isinstance(gap, dict) and "sim_vs_measured" in gap:
            out[f"sched.{key}.gap"] = float(gap["sim_vs_measured"])
            post = gap.get("post_refit")
            if isinstance(post, dict) and "gap" in post:
                out[f"sched.{key}.gap_post_refit"] = float(post["gap"])
        if "fps_searched" in e:
            out[f"sched.{key}.fps_searched"] = float(e["fps_searched"])
    return out


def flatten_serve(bench: Dict[str, Any]) -> Dict[str, float]:
    """BENCH_serve.json -> {metric: value} (gap ratio + tokens/s rows)."""
    out: Dict[str, float] = {}
    gap = bench.get("sim_vs_measured")
    if isinstance(gap, dict) and "sim_vs_measured" in gap:
        out["serve.gap"] = float(gap["sim_vs_measured"])
    sharded_gap = bench.get("sharded", {}).get("sim_vs_measured") \
        if isinstance(bench.get("sharded"), dict) else None
    if isinstance(sharded_gap, dict) and "sim_vs_measured" in sharded_gap:
        out["serve.sharded.gap"] = float(sharded_gap["sim_vs_measured"])
    for name, row in bench.items():
        if isinstance(row, dict) and "tokens_per_s" in row:
            out[f"serve.{name}.tokens_per_s"] = float(row["tokens_per_s"])
    pfx = bench.get("prefix_skew")
    if isinstance(pfx, dict) and "hit_rate" in pfx:
        # prefix-cache effectiveness on the skewed trace: a drop means the
        # radix trie stopped matching (or admissions stopped adopting)
        out["serve.prefix_skew.hit_rate"] = float(pfx["hit_rate"])
    spec = bench.get("spec_vs_scan")
    if isinstance(spec, dict) and "acceptance_rate" in spec:
        # draft-vs-target agreement: a drop means the draft family stopped
        # predicting the target (speculation decays toward pure overhead
        # long before tokens/s shows it on a noisy runner)
        out["serve.spec_vs_scan.acceptance_rate"] = \
            float(spec["acceptance_rate"])
    gw = bench.get("gateway_two_tenant")
    if isinstance(gw, dict):
        # per-tenant gateway health: goodput gates like throughput, and
        # SLO attainment dropping means admission stopped protecting the
        # high-priority tenant (visible long before pooled tokens/s moves)
        for tname, trow in sorted((gw.get("tenants") or {}).items()):
            if not isinstance(trow, dict):
                continue
            if "goodput_tokens_per_s" in trow:
                out[f"serve.gateway_two_tenant.{tname}.goodput_tokens_per_s"] \
                    = float(trow["goodput_tokens_per_s"])
            att = trow.get("slo_attainment")
            if isinstance(att, dict) and "ttft" in att:
                out[f"serve.gateway_two_tenant.{tname}.slo_attainment"] = \
                    float(att["ttft"])
    return out


def make_row(metrics: Dict[str, float], git_sha: str = "unknown",
             backend: str = "unknown", arch: str = "unknown",
             ts: Optional[str] = None) -> Dict[str, Any]:
    if ts is None:
        ts = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    return {"schema": SCHEMA_VERSION, "ts": ts, "git_sha": git_sha,
            "backend": backend, "arch": arch,
            "metrics": {k: float(v) for k, v in sorted(metrics.items())}}


def append_row(path: str, row: Dict[str, Any]) -> None:
    validate_row(row, where=f"{path} (new row)")
    with open(path, "a") as f:
        f.write(json.dumps(row, sort_keys=True) + "\n")


# ---------------------------------------------------------------------------
# Loading + validation: malformed history is a HARD failure, always
# ---------------------------------------------------------------------------


def validate_row(row: Any, where: str = "row") -> None:
    if not isinstance(row, dict):
        raise ValueError(f"history: {where}: not an object")
    schema = row.get("schema")
    if not isinstance(schema, int) or schema < 1:
        raise ValueError(f"history: {where}: bad schema {schema!r}")
    if schema > SCHEMA_VERSION:
        raise ValueError(f"history: {where}: schema {schema} is newer than "
                         f"supported {SCHEMA_VERSION}")
    for field in ("ts", "git_sha", "backend", "arch"):
        if not isinstance(row.get(field), str):
            raise ValueError(f"history: {where}: missing/bad field {field!r}")
    metrics = row.get("metrics")
    if not isinstance(metrics, dict):
        raise ValueError(f"history: {where}: metrics is not a mapping")
    for k, v in metrics.items():
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            raise ValueError(f"history: {where}: metric {k!r} non-numeric")


def load_history(path: str) -> List[Dict[str, Any]]:
    rows = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"history: {path}:{i}: not JSON ({e})")
            validate_row(row, where=f"{path}:{i}")
            rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# The regression detector
# ---------------------------------------------------------------------------


def _is_gap(metric: str) -> bool:
    return metric.endswith(".gap") or metric.endswith(".gap_post_refit") \
        or metric == "serve.gap"


def _is_throughput(metric: str) -> bool:
    # acceptance_rate gates like throughput: higher is better, a large
    # relative drop is the regression
    return metric.endswith(".tokens_per_s") \
        or metric.endswith(".fps_searched") \
        or metric.endswith(".acceptance_rate") \
        or metric.endswith(".slo_attainment") \
        or metric.endswith(".goodput_tokens_per_s")


def _median(vals: Sequence[float]) -> float:
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def check_history(rows: Sequence[Dict[str, Any]], gap_tol: float = GAP_TOL,
                  drop_tol: float = DROP_TOL,
                  min_history: int = MIN_HISTORY) -> List[dict]:
    """Tolerance-band regression check: newest row of every (backend, arch)
    group vs the median of its prior rows. Returns finding dicts (empty =
    green). Gap metrics regress when latest/baseline leaves the
    [1/gap_tol, gap_tol] band; throughput metrics regress when the latest
    drops more than ``drop_tol`` below baseline. Groups with fewer than
    ``min_history`` prior rows are skipped (no baseline, no verdict)."""
    groups: Dict[tuple, List[Dict[str, Any]]] = {}
    for r in rows:
        groups.setdefault((r["backend"], r["arch"]), []).append(r)
    findings: List[dict] = []
    for (backend, arch), grp in sorted(groups.items()):
        *prior, latest = grp
        if len(prior) < min_history:
            continue
        for metric, value in latest["metrics"].items():
            base_vals = [
                p["metrics"][metric] for p in prior
                if metric in p["metrics"]
                and math.isfinite(p["metrics"][metric])
                and p["metrics"][metric] > 0]
            if not base_vals or not math.isfinite(value):
                continue
            baseline = _median(base_vals)
            common = {"backend": backend, "arch": arch, "metric": metric,
                      "latest": value, "baseline": baseline,
                      "n_baseline": len(base_vals)}
            if _is_gap(metric) and value > 0:
                ratio = value / baseline
                if ratio > gap_tol or ratio < 1.0 / gap_tol:
                    findings.append({**common, "kind": "gap-drift",
                                     "ratio": round(ratio, 4),
                                     "tol": gap_tol})
            elif _is_throughput(metric):
                if value < baseline * (1.0 - drop_tol):
                    findings.append({**common, "kind": "throughput-drop",
                                     "drop": round(1.0 - value / baseline, 4),
                                     "tol": drop_tol})
    return findings


# ---------------------------------------------------------------------------
# CLI: the CI gate
# ---------------------------------------------------------------------------


def _git_sha() -> str:
    import subprocess

    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=10, check=True).stdout.strip()
    except Exception:
        return "unknown"


def main(argv: Optional[List[str]] = None) -> None:
    """``python -m repro_torch.obs.history append|check ...`` - build
    history rows out of BENCH_*.json files and gate on drift."""
    import argparse

    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs.history")
    sub = ap.add_subparsers(dest="cmd", required=True)
    a = sub.add_parser("append", help="flatten BENCH_*.json into a history row")
    a.add_argument("--out", required=True, help="history JSONL path")
    a.add_argument("--sched", help="BENCH_sched.json path")
    a.add_argument("--serve", help="BENCH_serve.json path")
    a.add_argument("--sha", default=None, help="git sha (default: HEAD)")
    a.add_argument("--backend", default=None,
                   help="backend label (default: torch-cuda when a GPU is "
                        "visible, else torch-cpu)")
    a.add_argument("--arch", default=None,
                   help="arch label (default: the serve report's, or 'bench')")
    c = sub.add_parser("check", help="regression gate over a history file")
    c.add_argument("history", help="history JSONL path")
    c.add_argument("--gap-tol", type=float, default=GAP_TOL)
    c.add_argument("--drop-tol", type=float, default=DROP_TOL)
    c.add_argument("--min-history", type=int, default=MIN_HISTORY)
    c.add_argument("--warn-only", action="store_true",
                   help="report findings without failing (noisy runners); "
                        "malformed history still fails hard")
    args = ap.parse_args(argv)

    if args.cmd == "append":
        metrics: Dict[str, float] = {}
        arch = args.arch
        if args.sched:
            with open(args.sched) as f:
                metrics.update(flatten_sched(json.load(f)))
        if args.serve:
            with open(args.serve) as f:
                serve = json.load(f)
            metrics.update(flatten_serve(serve))
            if arch is None and isinstance(serve.get("arch"), str):
                arch = serve["arch"]
        if not metrics:
            raise SystemExit("history append: no metrics (pass --sched/--serve)")
        backend = args.backend
        if backend is None:
            import torch

            backend = ("torch-cuda" if torch.cuda.is_available()
                       else "torch-cpu")
        row = make_row(metrics, git_sha=args.sha or _git_sha(),
                       backend=backend, arch=arch or "bench")
        append_row(args.out, row)
        print(f"appended {len(metrics)} metrics to {args.out} "
              f"(backend={row['backend']}, arch={row['arch']}, "
              f"sha={row['git_sha'][:12]})")
        return

    # check: malformed history exits 2 regardless of --warn-only
    try:
        rows = load_history(args.history)
    except (ValueError, OSError) as e:
        import sys

        print(f"history: MALFORMED: {e}", file=sys.stderr)
        raise SystemExit(2)
    findings = check_history(rows, gap_tol=args.gap_tol,
                             drop_tol=args.drop_tol,
                             min_history=args.min_history)
    if not findings:
        print(f"ok {args.history}: {len(rows)} rows, no regressions")
        return
    for f in findings:
        print(f"REGRESSION[{f['kind']}] {f['backend']}/{f['arch']} "
              f"{f['metric']}: latest {f['latest']:.6g} vs baseline "
              f"{f['baseline']:.6g} (n={f['n_baseline']}, tol={f['tol']})")
    if args.warn_only:
        print(f"warn-only: {len(findings)} finding(s) reported, not failing")
        return
    raise SystemExit(1)


if __name__ == "__main__":
    main()
