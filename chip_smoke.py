#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the repository root on a machine with a GPU, nvcc and no JAX
needed. Phases (any failure exits non-zero):

  1. build  - every CUDA source in src/repro_torch/csrc with nvcc (sm_90a);
  2. kernel - the block-sparse int8 kernel against its plain PyTorch version
              at full-width yi-6b shapes (decode and prefill rows, f32 and
              bf16 inputs, poisoned padding, truncated packings, stacked and
              single-layer entry points);
  3. serve  - yi-6b at full width in bf16, depth cut to 4 layers, random
              weights from a seed, compressed (uniform 128x128 tile, 60%
              tile sparsity) and served by BatchServer on the scan and the
              loop runtime; tokens must match, the kernel launch counts must
              prove every projection went through the kernel, and the
              kernel path's logits must agree with the plain path's;
  4. profile - torch.profiler over a short scan-engine run: the device's
              busy share and its top kernels;
  5. times  - kernel, bound, plain-version and library times per shape.

Prints the card's name and power limit, one JSON line per timed shape, a
``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``. Without a GPU it exits 2 and prints no
result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# card peaks used for bounds: H100 SXM HBM3 rate and the f32 CUDA-core rate
# the kernel's FFMA loop runs at (it uses no tensor cores)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

N_LAYERS = 4
N_SLOTS = 4
PROMPT_ROWS = 128  # the longest prompt of the trace: the prefill row count
TILE = (128, 128)
SPARSITY = 0.6
DEV = "cuda"


def log(*a) -> None:
    print(*a, flush=True)


def random_packing(torch, L, gi, go, bk, bn, density, gen, nnz_max=None,
                   poison=False):
    """A random (L, go, nnz_max, bk, bn) stacked packing on the GPU, laid
    out as pack_bsr lays it out; padding slots hold 99 when ``poison``."""
    dev = DEV
    alive = torch.rand((L, go, gi), generator=gen, device=dev) < density
    counts = alive.sum(-1).to(torch.int32)
    nmax = nnz_max or max(int(counts.max()), 1)
    key = (~alive).to(torch.int32) * gi + torch.arange(gi, device=dev)
    rows = torch.argsort(key, dim=-1)[..., :nmax].to(torch.int32)
    valid = (torch.arange(nmax, device=dev)
             < counts.clamp(max=nmax)[..., None])
    rows = torch.where(valid, rows, 0)
    blocks = torch.randint(-127, 128, (L, go, nmax, bk, bn), generator=gen,
                           device=dev, dtype=torch.int8)
    fill = 99 if poison else 0
    blocks = torch.where(valid[..., None, None], blocks,
                         torch.full_like(blocks, fill))
    scales = torch.full((L, go, nmax), 1.0 / 128, device=dev)
    return [blocks.contiguous(), scales, rows.contiguous(), counts]


def check_kernels(torch, K, Q, shapes):
    """Phase 2: every kernel entry point against the plain version. f32
    inputs are eq. 5-quantized activations, as the serving path feeds the
    kernel; bf16 inputs are raw normals."""
    gen = torch.Generator(device=DEV).manual_seed(1)
    err = {}  # (entry, dtype) -> max |kernel - plain|
    tol = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
    layer1 = torch.tensor([1], dtype=torch.int32, device=DEV)
    n = 0

    def compare(entry, got, want, dt, what):
        nonlocal n
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=tol[dt], atol=tol[dt],
                                   msg=lambda m: f"{what}: {m}")
        key = (entry, str(dt).split(".")[-1])
        err[key] = max(err.get(key, 0.0), float((got - want).abs().max()))
        n += 1

    for name, d_in, d_out in shapes:
        bk, bn = TILE
        cases = [("", None, False)]
        if name in ("wq", "w_down"):
            cases += [("poisoned", None, True), ("truncated", 3, False)]
        for label, nmax, poison in cases:
            st = random_packing(torch, 2, d_in // bk, d_out // bn, bk, bn,
                                0.4, gen, nnz_max=nmax, poison=poison)
            single = [a[0] for a in st]
            for m in (N_SLOTS, PROMPT_ROWS):
                for dt in (torch.float32, torch.bfloat16):
                    x = torch.randn((m, d_in), generator=gen,
                                    device=DEV)
                    x = (Q.quantize_activation(x, 8, signed=True)
                         if dt == torch.float32 else x.to(dt))
                    what = f"{name} {label} M={m} {dt}"
                    compare("bsr_matmul_stacked",
                            K.bsr_matmul_stacked(x, *st, layer1),
                            K.bsr_matmul_stacked_plain(x, *st, 1), dt, what)
                    compare("bsr_matmul", K.bsr_matmul(x, *single),
                            K.bsr_matmul_stacked_plain(x, *st, 0), dt, what)
            del st, single
    log(f"[kernel] {n} comparisons within tolerance (f32 1e-5, bf16 2e-2); "
        "max |kernel - plain|: " + ", ".join(
            f"{e} {d} {v:.3e}" for (e, d), v in sorted(err.items())))
    return {e: max(v for (e2, _), v in err.items() if e2 == e)
            for e, _ in err}


def make_trace(Request, vocab, seed=0):
    """8 requests, prompts of 32-128 tokens, 16 new tokens each; r1 and r5
    share their first 64 tokens (the prefix-cache suffix pass runs)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = [96, 80, 32, 128, 48, 72, 112, 64]
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in lens]
    prompts[5][:64] = prompts[1][:64]
    return [Request(f"r{i}", p, 16) for i, p in enumerate(prompts)]


def serve(torch, K, cfg, sp):
    """Phase 3: the scan and loop runtimes on the same trace."""
    from repro_torch.serve import BatchConfig, BatchServer, Request
    bcfg = BatchConfig(n_slots=N_SLOTS, block_size=16, n_blocks=96)
    passes = 7 * cfg.n_layers + 1  # projections per layer, plus the head
    reports, counts = {}, {}
    for engine in ("scan", "loop"):
        srv = BatchServer(cfg, sp, engine=engine, bcfg=bcfg, device=DEV)
        srv.run(make_trace(Request, cfg.vocab, seed=9)[:1])  # warm-up
        torch.cuda.synchronize()
        K.reset_launches()
        rep = srv.run(make_trace(Request, cfg.vocab))
        torch.cuda.synchronize()
        counts[engine] = dict(K.LAUNCHES_BY_ENTRY)
        reports[engine] = rep
        forwards = rep.n_requests + rep.n_decode_steps  # prefills + steps
        want = ({"bsr_matmul_stacked": 7 * cfg.n_layers * forwards,
                 "bsr_matmul": forwards} if engine == "scan"
                else {"bsr_matmul_stacked": 0,
                      "bsr_matmul": passes * forwards})
        assert K.LAUNCHES == passes * forwards, (engine, K.LAUNCHES)
        assert counts[engine] == want, (engine, counts[engine], want)
        j = rep.to_json()
        log(f"[serve] engine={engine} requests={rep.n_requests} "
            f"tokens={rep.total_tokens} decode_steps={rep.n_decode_steps} "
            f"tokens_per_s={rep.tokens_per_s:.2f} "
            f"ttft_p50_s={j['ttft']['p50']} decode_step_p50_s="
            f"{j['tpot']['p50']} peak_blocks={rep.kv_stats['peak_blocks']} "
            f"prefix_hits={rep.prefix['hits']} launches={K.LAUNCHES} "
            f"({passes} per forward x {forwards} forwards)")
    scan, loop = reports["scan"], reports["loop"]
    assert scan.prefix["hits"] >= 1
    for rid, toks in scan.outputs.items():
        assert len(toks) == 16 and ((0 <= toks) & (toks < cfg.vocab)).all()
        assert (toks == loop.outputs[rid]).all(), f"{rid}: scan != loop"
    log(f"[serve] scan and loop tokens equal on all {scan.n_requests} "
        "requests")
    return counts


def plain_path_agreement(torch, K, cfg, sp, sxp):
    """One prefill and one decode step through the kernel (loop and scan
    runtimes) against the same forward with every projection on the plain
    version, on the card. The projections' f32 sums are exact here (eq. 5
    activations and int8 levels are multiples of 2^-7, their products of
    2^-14, and no partial sum nears 2^10), so the order of summation cannot
    show, every other op is the same torch op, and the logits must agree."""
    from repro_torch.serve import deployed as DP
    toks = torch.randint(0, cfg.vocab, (1, 32), device=DEV,
                         generator=torch.Generator(device=DEV).manual_seed(3))

    def forward(params):
        logits, k, v = DP.prefill_last(params, toks, 29, cfg)
        pad = (0, 0, 0, 0, 0, 16)  # view of 48 positions, decode at 29
        vk, vv = (torch.nn.functional.pad(a, pad) for a in (k, v))
        nxt = logits.argmax(-1, keepdim=True).to(torch.int32)
        step, _, _ = DP.decode_step_paged(
            params, vk, vv, torch.tensor([29], dtype=torch.int32,
                                         device=DEV), nxt, cfg)
        return torch.cat([logits, step])

    loop, scan = forward(sp), forward(sxp)
    run = K._run
    K._run = lambda entry, x, *ops: K.bsr_matmul_stacked_plain(x, *ops)
    try:
        plain = forward(sp)
    finally:
        K._run = run
    assert loop.shape == (2, cfg.vocab) and torch.isfinite(loop).all()
    assert torch.equal(loop, scan)
    diff = float((loop - plain).abs().max())
    log(f"[serve] prefill + decode logits, kernel path vs plain path on the "
        f"card: max |diff| {diff:.3e} (max |logit| "
        f"{float(plain.abs().max()):.3e}); loop == scan")
    assert diff <= 1e-3, diff


def profile_serve(torch, cfg, sp):
    """Phase 5: where a scan-engine serve run spends the card's time, from
    torch.profiler (its own overhead slows the host, so the busy share it
    reports is a lower bound for an unprofiled run)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import BatchConfig, BatchServer, Request
    srv = BatchServer(cfg, sp, engine="scan", device=DEV,
                      bcfg=BatchConfig(n_slots=N_SLOTS, block_size=16,
                                       n_blocks=96))
    reqs = make_trace(Request, cfg.vocab, seed=5)[:N_SLOTS]
    srv.run(reqs[:1])  # warm-up
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if DEV == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        rep = srv.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    events = [e for e in prof.key_averages() if dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:6]
    out = {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / (wall * 1e3),
           "decode_steps": rep.n_decode_steps,
           "bsr_kernel_ms": sum(dev_us(e) for e in events
                                if "bsr_matmul" in e.key) / 1e3,
           "top": [[e.key[:60], dev_us(e) / 1e3, e.count] for e in top]}
    if not events:
        out = {"device_time": "not measured (profiler saw no device time)"}
    log(json.dumps({"profile": out}))


def time_ms(torch, fn, flush, iters=30, warm=3):
    """Median CUDA-event time of ``fn``, with L2 flushed before each run
    (a decode step meets every weight cold)."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def bound(m, k, n, nnz, bk, bn, go):
    """Least time for the work: each input byte read once, each output
    written once (valid slots only), or the f32 FLOPs at the CUDA-core peak;
    the larger of the two."""
    blocks = nnz * bk * bn
    nbytes = blocks + nnz * 8 + go * 4 + m * k * 4 + m * n * 4
    flops = 2 * m * blocks
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def times(torch, K, Q, sp, stacked):
    """Phase 4: kernel / bound / plain / library times on the packed
    model's own weights."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=DEV)
    layer0 = stacked.layer_ids[0:1]
    rows = []
    for name in ("w_gate", "w_down", "head"):
        if name == "head":  # the untied head: a single-layer packing
            p = sp.head.packed[0]
            single = [p[k] for k in ("blocks", "scales", "row_idx", "nnz")]
            ops = [a[None] for a in single]
            run = lambda x: K.bsr_matmul(x, *single)
            entry, k_in = "bsr_matmul", sp.head.d_in
        else:  # layer 0 of the stacked envelope, layer id on the card
            sw = stacked.packed[name]
            ops = [sw.blocks, sw.scales, sw.row_idx, sw.nnz]
            run = lambda x: K.bsr_matmul_stacked(x, *ops, layer0)
            entry, k_in = "bsr_matmul_stacked", sw.d_in
        _, go, nmax, bk, bn = ops[0].shape
        nnz = int(ops[3][0].clamp(max=nmax).sum())
        w_dense = K.dense_weight(*ops, 0, k_in)  # the library call's weight
        for m in (N_SLOTS, PROMPT_ROWS):
            x = Q.quantize_activation(torch.randn((m, k_in), device=DEV),
                                      8, signed=True)
            b_ms, b_by = bound(m, k_in, go * bn, nnz, bk, bn, go)
            row = {"shape": f"{name} decode" if m == N_SLOTS
                   else f"{name} prefill", "entry": entry, "M": m,
                   "K": k_in, "N": go * bn, "tile": [bk, bn],
                   "nnz_blocks": nnz,
                   "kernel_ms": time_ms(torch, lambda: run(x), flush),
                   "bound_ms": b_ms, "bound_by": b_by,
                   "plain_ms": time_ms(torch, lambda: K.bsr_matmul_stacked_plain(
                       x, *ops, 0), flush),
                   "library_ms": time_ms(
                       torch, lambda: torch.matmul(x, w_dense), flush)}
            rows.append(row)
            log(json.dumps(row))
        del w_dense
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import quant as Q
    from repro_torch.kernels import _build
    from repro_torch.kernels import cim_bsr_matmul as K
    from repro_torch.models import registry
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import deployed as DP
    from repro_torch.serve import stacked as ST

    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 references
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(card)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"[build] {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name, (secs, out) in _build.BUILD_LOG.items():
        regs = [ln.strip() for ln in out.splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"[build] {name}: nvcc {secs:.1f} s; " + " | ".join(regs))

    cfg = registry.get_config("yi-6b", n_layers=N_LAYERS)
    shapes = [("wq", cfg.d_model, cfg.n_heads * cfg.dh),
              ("wk", cfg.d_model, cfg.n_kv_heads * cfg.dh),
              ("w_gate", cfg.d_model, cfg.d_ff),
              ("w_down", cfg.d_ff, cfg.d_model),
              ("head", cfg.d_model, cfg.vocab)]
    max_err = check_kernels(torch, K, Q, shapes)

    log(f"[serve] yi-6b at full width ({cfg.d_model} wide, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"{cfg.dtype}); depth cut from 32 to {cfg.n_layers} layers; random "
        "weights, seed 0")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0))
    sp = DP.compress(cfg, params, target_sparsity=SPARSITY, tile=TILE,
                     uniform=True)
    del params
    report = sp.report()
    log(f"[serve] compress {time.perf_counter() - t0:.1f} s; tile "
        f"{sp.head.tile}; compression_x {report['compression_x']:.3f}; "
        f"head density {sp.head.density:.3f}")
    counts = serve(torch, K, cfg, sp)
    sxp = ST.stack(sp)
    plain_path_agreement(torch, K, cfg, sp, sxp)

    profile_serve(torch, cfg, sp)
    rows = times(torch, K, Q, sp, sxp)
    pick = {"bsr_matmul_stacked": "w_gate decode", "bsr_matmul": "head decode"}
    replaces = {"bsr_matmul": "src/repro/kernels/cim_bsr_matmul.py:83",
                "bsr_matmul_stacked": "src/repro/kernels/cim_bsr_matmul.py:138"}
    kernels = []
    for entry in ("bsr_matmul_stacked", "bsr_matmul"):
        row = next(r for r in rows if r["shape"] == pick[entry])
        launches = sum(c[entry] for c in counts.values())
        assert launches > 0, entry
        kernels.append({
            "name": entry, "route": "cuda",
            "source": "src/repro_torch/csrc/bsr_matmul.cu",
            "replaces": replaces[entry], "launches": launches,
            "max_abs_err": max_err[entry], "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
