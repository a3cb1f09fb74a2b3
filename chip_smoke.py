#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the repository root on a machine with a GPU, nvcc and no JAX
needed. Phases (any failure exits non-zero):

  1. build  - every CUDA source in src/repro_torch/csrc with nvcc (sm_90a),
              one nvcc per source, all started together;
  2. kernel - each kernel against its plain PyTorch version on the card:
              the block-sparse int8 kernel at full-width yi-6b shapes
              (decode and prefill rows, f32 and bf16 inputs, poisoned
              padding, truncated packings, stacked and single-layer entry
              points); fake_quant bit for bit (bits 2/4/8, signed and
              unsigned, f32 and bf16, ragged sizes, NaN, +-inf and exact
              half-levels); ssd_intra_chunk at the full-width mamba2-780m
              shape (f32 at 1e-4, bf16 in with f32 out at 2e-2);
              quant_matmul at test_kernels.py's, kernel_bench's and
              full-width yi-6b's shapes within QM_TOL of max |plain|, with x
              a row and column slice of a NaN-poisoned buffer in two cases;
  3. serve yi-6b - yi-6b at full width in bf16, depth cut to 4 layers,
              random weights from a seed, compressed (uniform 128x128 tile,
              60% tile sparsity) and served by BatchServer on the scan and
              the loop runtime; tokens must match, the launch counts must
              prove every projection went through the block-sparse kernel
              and its eq. 5 activations through fake_quant, and the kernel
              path's logits must agree with the plain path's;
  4. serve mamba2-780m - full width and depth (48 layers), bf16, MARS QAT
              w8a8, random weights from a seed, Engine.generate on 4
              prompts of 1024 tokens for 32 new tokens; the launch counts
              must prove every layer's prefill went through ssd_intra_chunk
              and every projection's activations and weight through
              fake_quant; against the plain path: the whole generate with
              fake_quant swapped equal bit for bit, every layer with both
              kernels swapped within LAYER_ULPS bf16 ulps, the two whole
              residual streams within DRIFT_LIMITS after the first layers,
              and the same weights in f32 (dense mode) with prefill and
              decode logits within MAMBA_F32_TOL and greedy tokens by the
              margin rule;
  5. baseline - the dense int8 baseline macro (quant_matmul) through its
              entry point, repro_torch.kernels.ops.quant_matmul: one
              full-width yi-6b gated MLP quantized per output channel, at
              decode and prefill rows, and kernel_bench's shape;
  6. cli    - the serving CLI, repro_torch.launch.serve.main, in-process:
              full-width, full-depth yi-6b packed, saved as an artifact and
              served on the loop runtime; booted from the artifact (no
              packing; the booted packing equal to the saved one) and served
              on the scan runtime with the same tokens; the legacy Engine
              over the stacked and the per-layer packing, equal tokens;
              full-width, full-depth mamba2-780m (QAT) through the Engine
              fallback; launch counts for every run;
  7. profile - torch.profiler over a short scan-engine run and a short
              mamba2 generate: the device's busy share and its top kernels;
  8. times  - kernel, bound, plain-version and library times per shape.

Prints the card's name and power limit, one JSON line per timed shape, a
``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``. Without a GPU it exits 2 and prints no
result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# card peaks used for bounds (H100 SXM, dense): the HBM3 rate, the f32
# CUDA-core rate, and the bf16 tensor-core rate, which is exact for a
# product of bf16 x with int8 levels (|level| <= 127 is exact in bf16;
# bf16 x bf16 products summed in f32)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_TC_FLOPS_PER_S = 989e12

N_LAYERS = 4
N_SLOTS = 4
PROMPT_ROWS = 128  # the longest prompt of the trace: the prefill row count
TILE = (128, 128)
SPARSITY = 0.6
DEV = "cuda"

# mamba2-780m serving: prompts, prompt length (4 chunks of 256), new tokens
MAMBA_BATCH = 4
MAMBA_PROMPT = 1024
MAMBA_NEW = 32
# kernel path vs plain path (see serve_mamba): each layer's output within
# this many bf16 ulps of its scale; the relative RMS difference of the two
# whole bf16 QAT residual streams after layers 0, 1 and 2 within these
# limits (about 3x the readings on an H100: 6.1e-4 after layer 0, 4.7e-3
# after layer 1, 3.2e-2 after layer 3); the whole f32 dense path's logits
# within MAMBA_F32_TOL (f32 sums in another order inside ssd_intra, ~3e-5
# over 48 layers, measured in PERF.md)
LAYER_ULPS = 2
DRIFT_LIMITS = (2e-3, 1.5e-2, 4e-2)
MAMBA_F32_TOL = 1e-3

# quant_matmul against its plain version: max |kernel - plain| within this
# share of max |plain| (both widen x to f32 exactly and multiply int8
# levels exactly; only the order of the f32 sums differs)
QM_TOL = 1e-4
# (M, K, N, x dtype): tests/test_kernels.py's four, benchmarks/
# kernel_bench.py's, and full-width yi-6b's w_gate / w_down at decode and
# prefill rows
QM_SHAPES = [(128, 256, 256, "float32"), (100, 200, 300, "float32"),
             (256, 128, 512, "bfloat16"), (64, 384, 128, "float32"),
             (256, 1024, 1024, "float32"),
             (N_SLOTS, 4096, 11008, "bfloat16"),
             (PROMPT_ROWS, 4096, 11008, "bfloat16"),
             (N_SLOTS, 11008, 4096, "bfloat16"),
             (PROMPT_ROWS, 11008, 4096, "bfloat16")]
QM_POISONED = {(100, 200, 300), (N_SLOTS, 4096, 11008)}

# the cli phase's yi-6b runs (full width and depth): packing flags, then
# the batch trace and the legacy batch
CLI_YI = ["--arch", "yi-6b", "--dtype", "bfloat16", "--compressed",
          "--tile", "128x128", "--target-sparsity", "0.6"]
CLI_BATCH = ["--requests", "8", "--prompt-len", "128", "--new-tokens", "32",
             "--slots", "4", "--block-size", "16", "--kv-blocks", "256"]
CLI_LEGACY = ["--engine", "legacy", "--batch", "4", "--prompt-len", "128",
              "--new-tokens", "16"]
# the mamba2 run serves MARS-QAT: the reference's CLI has no flag for a
# config's cim_mode, so the cli phase sets it in code (see cli)
CLI_MAMBA = ["--arch", "mamba2-780m", "--dtype", "bfloat16", "--batch", "4",
             "--prompt-len", "1024", "--new-tokens", "8"]


def log(*a) -> None:
    print(*a, flush=True)


def reset_launches(kern) -> None:
    for mod in kern:
        mod.reset_launches()


def launch_counts(kern) -> dict:
    K, FQ, SI, QM = kern
    return dict(K.LAUNCHES_BY_ENTRY, fake_quant=FQ.LAUNCHES,
                ssd_intra_chunk=SI.LAUNCHES, quant_matmul=QM.LAUNCHES)


def mamba_launches(cfg, prefills, forwards) -> dict:
    """The launches of a QAT mamba2 Engine run: fake_quant on the
    activations and the weight of in_proj and out_proj in every layer and
    of the head, every forward; ssd_intra_chunk once per layer in every
    prefill."""
    return {"bsr_matmul": 0, "bsr_matmul_stacked": 0,
            "fake_quant": 2 * (2 * cfg.n_layers + 1) * forwards,
            "ssd_intra_chunk": cfg.n_layers * prefills, "quant_matmul": 0}


def compressed_launches(cfg, engine, forwards) -> dict:
    """The launches of ``forwards`` forwards of a compressed dense model:
    7 projections per layer and the head, each on the block-sparse kernel
    (the scan runtime's layers on the stacked entry, the head and the loop
    runtime on the single-layer one) after eq. 5 on fake_quant."""
    passes = 7 * cfg.n_layers + 1
    want = ({"bsr_matmul_stacked": 7 * cfg.n_layers * forwards,
             "bsr_matmul": forwards} if engine == "scan"
            else {"bsr_matmul_stacked": 0, "bsr_matmul": passes * forwards})
    want.update(fake_quant=passes * forwards, ssd_intra_chunk=0,
                quant_matmul=0)
    return want


@contextlib.contextmanager
def plain_kernels(kern):
    """Every kernel wrapper swapped for its plain version (on the card),
    every other op unchanged."""
    K, FQ, SI, _ = kern
    saved = K._run, FQ.fake_quant, SI.ssd_intra_chunk
    K._run = lambda entry, x, *ops: K.bsr_matmul_stacked_plain(x, *ops)
    FQ.fake_quant = FQ.fake_quant_plain
    SI.ssd_intra_chunk = SI.ssd_intra_chunk_plain
    try:
        yield
    finally:
        K._run, FQ.fake_quant, SI.ssd_intra_chunk = saved


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


def check_fake_quant(torch, FQ):
    """Phase 2: fake_quant against its plain version, bit for bit: NaN
    where the plain version has NaN, every other value equal. Inputs are
    1.5-scaled normals salted with NaN, +-inf and exact half-levels (values
    whose product with the level count is k + 0.5 in f32)."""
    gen = torch.Generator(device=DEV).manual_seed(2)
    shapes = [(1,), (3, 100, 130), (MAMBA_BATCH, 1536), (4096, 1536),
              (1536, 6448), (1_000_003,)]
    n = ties = 0
    for bits in (2, 4, 8):
        for signed in (False, True):
            q = 2.0 ** (bits - 1) - 1.0 if signed else 2.0 ** bits - 1.0
            for dt in (torch.float32, torch.bfloat16):
                for shape in shapes:
                    x = torch.randn(shape, generator=gen, device=DEV) * 1.5
                    flat = x.view(-1)
                    if flat.numel() > 8:
                        k = torch.randint(-int(q) if signed else 0, int(q),
                                          (flat.numel() // 8,), generator=gen,
                                          device=DEV).float()
                        half = ((k + 0.5) / q).to(dt).float()
                        half = half[half * q == k + 0.5]
                        slots = flat[3::8]
                        slots[:half.numel()] = half[:slots.numel()]
                        ties += min(half.numel(), slots.numel())
                        flat[::97] = float("nan")
                        flat[1::101] = float("inf")
                        flat[2::103] = -float("inf")
                    x = x.to(dt)
                    got = FQ.fake_quant(x, bits, signed)
                    torch.cuda.synchronize()
                    want = FQ.fake_quant_plain(x, bits, signed)
                    assert got.dtype == x.dtype and got.shape == x.shape
                    assert torch.equal(got.isnan(), want.isnan()), \
                        (bits, signed, dt, shape)
                    assert torch.equal(got.nan_to_num(), want.nan_to_num()), \
                        (bits, signed, dt, shape)
                    n += 1
    log(f"[kernel] fake_quant: {n} comparisons bit for bit (tolerance 0), "
        f"{ties} exact half-levels among the inputs")
    return 0.0


def check_ssd_intra(torch, SI, cfg):
    """Phase 2: ssd_intra_chunk against its plain version at the serving
    shape (C = batch x chunks, H, l, N, P of mamba2-780m) and a ragged one,
    with two decay draws: test_kernels.py's (-|N(0,1)| x 0.1) and the serving
    path's (-softplus(N(0,1)), a = dt * A with A = -1)."""
    gen = torch.Generator(device=DEV).manual_seed(4)
    serve_shape = (MAMBA_BATCH * MAMBA_PROMPT // cfg.ssm_chunk,
                   cfg.n_ssm_heads, cfg.ssm_chunk, cfg.ssm_state,
                   cfg.d_inner // cfg.n_ssm_heads)
    err = {}
    f32, bf16 = torch.float32, torch.bfloat16
    for C, H, l, N, P in (serve_shape, (3, 5, 100, 20, 70)):
        for draw in ("kernels", "serve"):
            z = torch.randn((C, H, l), generator=gen, device=DEV)
            a = (-z.abs() * 0.1 if draw == "kernels"
                 else -torch.nn.functional.softplus(z))
            b, c = (torch.randn((C, l, N), generator=gen, device=DEV) * 0.3
                    for _ in range(2))
            x = torch.randn((C, l, H, P), generator=gen, device=DEV) * 0.3
            for dt, out, tol in ((f32, f32, 1e-4), (bf16, f32, 2e-2),
                                 (bf16, bf16, 2e-2)):
                args = (a, b.to(dt), c.to(dt), x.to(dt))
                got = SI.ssd_intra_chunk(*args, out_dtype=out)
                torch.cuda.synchronize()
                want = SI.ssd_intra_chunk_plain(*args, out_dtype=out)
                torch.testing.assert_close(
                    got, want, rtol=tol, atol=tol,
                    msg=lambda m: f"ssd_intra {(C, H, l, N, P)} {dt}: {m}")
                key = f"{str(dt)[6:]}->{str(out)[6:]}"
                err[key] = max(err.get(key, 0.0),
                               float((got.float() - want.float()).abs().max()))
            del args, got, want
    log(f"[kernel] ssd_intra_chunk at {serve_shape} (C, H, l, N, P) and "
        "(3, 5, 100, 20, 70): within tolerance (f32 1e-4, bf16 in 2e-2); "
        "max |kernel - plain|: " + ", ".join(
            f"{k} {v:.3e}" for k, v in sorted(err.items())))
    return max(err.values())


def qm_inputs(torch, m, k, n, dtype, gen, poison=False):
    """x (M, K) normal in ``dtype``, w (K, N) int8 levels in [-127, 127],
    scale (N,) in [0.01, 0.11), as test_kernels.py draws them. With
    ``poison`` x is the top-left (M, K) corner of a buffer whose other rows
    and columns are NaN."""
    x = torch.randn((m, k), generator=gen, device=DEV)
    if poison:
        buf = torch.full((m + 7, k + 5), float("nan"), device=DEV)
        buf[:m, :k] = x
        x = buf.to(getattr(torch, dtype))[:m, :k]
    else:
        x = x.to(getattr(torch, dtype))
    w = torch.randint(-127, 128, (k, n), generator=gen, device=DEV,
                      dtype=torch.int8)
    scale = torch.rand((n,), generator=gen, device=DEV) * 0.1 + 0.01
    return x, w, scale


def check_quant_matmul(torch, QM):
    """Phase 2: quant_matmul against its plain version at QM_SHAPES, max
    |kernel - plain| within QM_TOL of max |plain|; in the QM_POISONED
    cases x is a slice of a NaN-poisoned buffer (a read past the ragged
    row or column edge would put NaN into y)."""
    gen = torch.Generator(device=DEV).manual_seed(7)
    worst_abs = worst_rel = 0.0
    n = 0
    for m, k, nn, dt in QM_SHAPES:
        for poison in (False, True) if (m, k, nn) in QM_POISONED else (False,):
            x, w, scale = qm_inputs(torch, m, k, nn, dt, gen, poison)
            got = QM.quant_matmul(x, w, scale)
            torch.cuda.synchronize()
            want = QM.quant_matmul_plain(x, w, scale)
            assert got.shape == (m, nn) and got.dtype == torch.float32
            assert torch.isfinite(got).all(), (m, k, nn, dt, poison)
            d = float((got - want).abs().max())
            scale_max = float(want.abs().max())
            assert d <= QM_TOL * scale_max, (m, k, nn, dt, poison, d,
                                             scale_max)
            worst_abs = max(worst_abs, d)
            worst_rel = max(worst_rel, d / scale_max)
            n += 1
    log(f"[kernel] quant_matmul: {n} comparisons within {QM_TOL} x max "
        f"|plain| ({len(QM_POISONED)} with x sliced from a NaN-poisoned "
        f"buffer); max |kernel - plain| {worst_abs:.3e}, at most "
        f"{worst_rel:.3e} of max |plain|")
    return worst_abs


def make_trace(Request, vocab, seed=0):
    """8 requests, prompts of 32-128 tokens, 16 new tokens each; r1 and r5
    share their first 64 tokens (the prefix-cache suffix pass runs)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = [96, 80, 32, 128, 48, 72, 112, 64]
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in lens]
    prompts[5][:64] = prompts[1][:64]
    return [Request(f"r{i}", p, 16) for i, p in enumerate(prompts)]


def serve(torch, kern, cfg, sp):
    """Phase 3: the scan and loop runtimes on the same trace. Every
    projection runs eq. 5 on its activations (fake_quant) and then the
    block-sparse kernel; no SSD block runs."""
    K = kern[0]
    from repro_torch.serve import BatchConfig, BatchServer, Request
    bcfg = BatchConfig(n_slots=N_SLOTS, block_size=16, n_blocks=96)
    passes = 7 * cfg.n_layers + 1  # projections per layer, plus the head
    reports, counts = {}, {}
    for engine in ("scan", "loop"):
        srv = BatchServer(cfg, sp, engine=engine, bcfg=bcfg, device=DEV)
        srv.run(make_trace(Request, cfg.vocab, seed=9)[:1])  # warm-up
        torch.cuda.synchronize()
        reset_launches(kern)
        rep = srv.run(make_trace(Request, cfg.vocab))
        torch.cuda.synchronize()
        counts[engine] = launch_counts(kern)
        reports[engine] = rep
        forwards = rep.n_requests + rep.n_decode_steps  # prefills + steps
        want = compressed_launches(cfg, engine, forwards)
        assert K.LAUNCHES == passes * forwards, (engine, K.LAUNCHES)
        assert counts[engine] == want, (engine, counts[engine], want)
        j = rep.to_json()
        log(f"[serve] engine={engine} requests={rep.n_requests} "
            f"tokens={rep.total_tokens} decode_steps={rep.n_decode_steps} "
            f"tokens_per_s={rep.tokens_per_s:.2f} "
            f"ttft_p50_s={j['ttft']['p50']} decode_step_p50_s="
            f"{j['tpot']['p50']} peak_blocks={rep.kv_stats['peak_blocks']} "
            f"prefix_hits={rep.prefix['hits']} launches={K.LAUNCHES} "
            f"({passes} per forward x {forwards} forwards; as many "
            "fake_quant)")
    scan, loop = reports["scan"], reports["loop"]
    assert scan.prefix["hits"] >= 1
    for rid, toks in scan.outputs.items():
        assert len(toks) == 16 and ((0 <= toks) & (toks < cfg.vocab)).all()
        assert (toks == loop.outputs[rid]).all(), f"{rid}: scan != loop"
    log(f"[serve] scan and loop tokens equal on all {scan.n_requests} "
        "requests")
    return counts


def plain_path_agreement(torch, kern, cfg, sp, sxp):
    """One prefill and one decode step through the kernels (loop and scan
    runtimes) against the same forward with every kernel swapped for its
    plain version, on the card. fake_quant is bit-exact, and the
    projections' f32 sums are exact here (eq. 5 activations and int8 levels
    are multiples of 2^-7, their products of 2^-14, and no partial sum
    nears 2^10), so the order of summation cannot show, every other op is
    the same torch op, and the logits must agree."""
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
    with plain_kernels(kern):
        plain = forward(sp)
    assert loop.shape == (2, cfg.vocab) and torch.isfinite(loop).all()
    assert torch.equal(loop, scan)
    diff = float((loop - plain).abs().max())
    log(f"[serve] prefill + decode logits, kernel path vs plain path on the "
        f"card: max |diff| {diff:.3e} (max |logit| "
        f"{float(plain.abs().max()):.3e}); loop == scan")
    assert diff <= 1e-3, diff


def _recording(torch, fn, secs, logits):
    """``fn`` (a prefill or decode step) with a host-clock time around it,
    synchronized on both ends, and its logits kept."""
    def run(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        logits.append(out[0].float())
        return out
    return run


def serve_mamba(torch, kern, cfg, params):
    """Phase 4: Engine.generate at full width and depth on the kernel path
    (timed, launches counted), then the kernel path against the plain path
    (kernels swapped for their plain versions, every other op unchanged):

    a. fake_quant alone swapped: every logit of the whole generate equal,
       bit for bit, and so every token;
    b. both swapped, layer by layer on the kernel path's own inputs: each
       layer's output and final SSM state within LAYER_ULPS bf16 ulps of
       its own scale (ssd_intra's f32 sums run in another order than the
       plain version's, which moves a bf16 rounding by an ulp); beside it
       the plain path's own residual stream: the two streams' relative RMS
       difference within DRIFT_LIMITS after layers 0, 1 and 2;
    c. both swapped, the whole path on the same weights in f32 with
       cim_mode "dense": prefill and first decode logits within
       MAMBA_F32_TOL, greedy tokens equal wherever the plain path's top-2
       margin exceeds it.

    The whole QAT path is held only over its first layers: a random-weight
    QAT model carries a one-level eq. 5 flip in one layer into every later
    one, so its two paths decorrelate with depth; the deeper drift and the
    prefill logits' difference are printed."""
    from repro_torch.models import layers as L
    from repro_torch.models import registry
    from repro_torch.models import ssm as SSM
    from repro_torch.serve import Engine, ServeConfig
    FQ = kern[1]
    fns = registry.model_fns(cfg)
    toks = torch.randint(0, cfg.vocab, (MAMBA_BATCH, MAMBA_PROMPT),
                         generator=torch.Generator(device=DEV).manual_seed(1),
                         device=DEV, dtype=torch.int32)
    batch = {"tokens": toks}

    def generate(cfg, params):
        """Engine.generate with each prefill and decode step timed on the
        host clock (synchronized) and its logits kept."""
        rec = {"prefill": [], "decode": [], "logits": []}
        timed = dataclasses.replace(
            fns, prefill=_recording(torch, fns.prefill, rec["prefill"],
                                    rec["logits"]),
            decode_step=_recording(torch, fns.decode_step, rec["decode"],
                                   rec["logits"]))
        eng = Engine(cfg, params, ServeConfig(max_new_tokens=MAMBA_NEW),
                     fns=timed)
        return eng.generate(batch), rec

    Engine(cfg, params).generate({"tokens": toks[:1, :cfg.ssm_chunk]},
                                 2)  # warm-up: kernel libraries, cuBLAS
    torch.cuda.synchronize()
    reset_launches(kern)
    t0 = time.perf_counter()
    out, rec = generate(cfg, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts(kern)
    forwards = len(rec["prefill"]) + len(rec["decode"])
    per_forward = 2 * (2 * cfg.n_layers + 1)  # (in_proj, out_proj) x L + head
    want = mamba_launches(cfg, 1, forwards)
    assert counts == want, (counts, want)
    assert out.shape == (MAMBA_BATCH, MAMBA_NEW)
    assert ((0 <= out) & (out < cfg.vocab)).all()
    assert all(torch.isfinite(lg).all() for lg in rec["logits"])
    decode_p50 = statistics.median(rec["decode"])
    log(f"[mamba] Engine.generate: {MAMBA_BATCH} x {MAMBA_PROMPT} prompt "
        f"tokens, {MAMBA_NEW} new each, {len(rec['decode'])} decode steps; "
        f"host clock: wall {wall:.4f} s, tokens_per_s "
        f"{MAMBA_BATCH * MAMBA_NEW / wall:.2f}, prefill "
        f"{rec['prefill'][0]:.4f} s, decode_step_p50 {decode_p50:.5f} s "
        f"(min {min(rec['decode']):.5f}, max {max(rec['decode']):.5f}); "
        f"launches {counts} = fake_quant {per_forward} per forward x "
        f"{forwards} forwards, ssd_intra_chunk {cfg.n_layers} per prefill")

    # a. fake_quant alone on its plain version: the same run, bit for bit
    saved = FQ.fake_quant
    FQ.fake_quant = FQ.fake_quant_plain
    try:
        out_fq, rec_fq = generate(cfg, params)
    finally:
        FQ.fake_quant = saved
    assert (out_fq == out).all()
    assert all(torch.equal(a, b) for a, b in zip(rec["logits"],
                                                 rec_fq["logits"]))
    log(f"[mamba] fake_quant kernel vs plain on the whole QAT generate: all "
        f"{forwards} forwards' logits and all tokens equal bit for bit")

    # b. every layer on the kernel path's own input, both kernels swapped;
    # beside it the plain path's own residual stream, held over the first
    # layers and read after the later ones
    worst, drift = 0.0, {}
    with torch.no_grad():
        x = L.embed(params["embed"], toks, cfg.param_dtype)
        x_plain = x
        for i in range(cfg.n_layers):
            p = {k: v[i] for k, v in params["layers"].items()}
            h = L.rmsnorm(x, p["ln"])
            y, (_, state) = SSM.mamba_block(p, h, cfg)
            with plain_kernels(kern):
                y_p, (_, state_p) = SSM.mamba_block(p, h, cfg)
                x_plain = x_plain + SSM.mamba_block(
                    p, L.rmsnorm(x_plain, p["ln"]), cfg)[0]
            for got, ref in ((y, y_p), (state, state_p)):
                # a bf16 ulp at the tensor's largest magnitude
                ulp = math.ldexp(1.0, math.frexp(float(
                    ref.float().abs().max()))[1] - 8)
                d = float((got.float() - ref.float()).abs().max())
                assert d <= LAYER_ULPS * ulp, (i, d, ulp)
                worst = max(worst, d / ulp)
            x = x + y
            if i < len(DRIFT_LIMITS) or i in (7, 31, cfg.n_layers - 1):
                drift[i] = float((x.float() - x_plain.float()).norm()
                                 / x_plain.float().norm())
        final, whole = (L.logits_out(params["head"], L.rmsnorm(
            s, params["final_ln"])[:, -1:], cfg.cim)[:, 0].float()
            for s in (x, x_plain))
    for i, limit in enumerate(DRIFT_LIMITS[:cfg.n_layers]):
        assert drift[i] <= limit, (i, drift[i], limit)
    log(f"[mamba] both kernels vs plain, each of {cfg.n_layers} layers on "
        f"the kernel path's inputs: max |diff| {worst:.3f} bf16 ulps of the "
        f"layer's scale (tolerance {LAYER_ULPS}); the whole QAT paths: "
        "relative RMS of the residual streams' difference after layer "
        + ", ".join(f"{i}: {v:.3e}" for i, v in drift.items())
        + f" (held after layers 0-{len(DRIFT_LIMITS) - 1} at "
        f"{', '.join(map(str, DRIFT_LIMITS))}); prefill max |logit diff| "
        f"{float((final - whole).abs().max()):.4e} (max |logit| "
        f"{float(whole.abs().max()):.4e}), not held")

    # c. the whole path in f32, dense mode: logits and tokens
    cfg32 = dataclasses.replace(cfg, dtype="float32", cim_mode="dense")
    p32 = {k: ({n: t.float() for n, t in v.items()} if k == "layers"
               else v.float()) for k, v in params.items()}

    out32, rec32 = generate(cfg32, p32)
    with plain_kernels(kern):
        out32_p, rec32_p = generate(cfg32, p32)
    # the prefill's and the first decode step's logits
    diffs = [float((a - b).abs().max())
             for a, b in zip(rec32["logits"][:2], rec32_p["logits"][:2])]
    assert max(diffs) <= MAMBA_F32_TOL, diffs
    top2 = [lg.topk(2, dim=-1).values for lg in rec32_p["logits"]]
    margins = torch.stack([t[:, 0] - t[:, 1] for t in top2], 1).cpu()
    same = 0
    for row in range(MAMBA_BATCH):
        diff = (out32[row] != out32_p[row]).nonzero()[0]
        k = int(diff[0]) if diff.size else MAMBA_NEW
        same += k
        if k < MAMBA_NEW:  # the first divergence must sit on a near-tie
            assert float(margins[row, k]) <= MAMBA_F32_TOL, (row, k)
    log(f"[mamba] f32 dense, kernel path vs plain path on the same weights: "
        f"prefill max |logit diff| {diffs[0]:.4e}, first decode step "
        f"{diffs[1]:.4e} (tolerance {MAMBA_F32_TOL}); greedy tokens {same} "
        f"of {MAMBA_BATCH * MAMBA_NEW} equal before any divergence, smallest "
        f"plain-path top-2 margin {float(margins.min()):.4e}")
    del p32
    return counts


def baseline(torch, kern, cfg):
    """Phase 5: the dense int8 baseline macro through its entry point,
    ``repro_torch.kernels.ops.quant_matmul``: a full-width yi-6b gated MLP
    (w_gate, w_up, w_down, random bf16 weights quantized to int8 per output
    channel) on bf16 activations at decode and prefill rows, then
    kernel_bench's shape. Returns the launch counts and the weights."""
    from repro_torch.kernels import ops
    QM = kern[3]
    gen = torch.Generator(device=DEV).manual_seed(8)
    d, ff = cfg.d_model, cfg.d_ff
    mlp = {}
    for name, k, n in (("w_gate", d, ff), ("w_up", d, ff),
                       ("w_down", ff, d)):
        w = torch.randn((k, n), generator=gen, device=DEV) / k ** 0.5
        scale = w.abs().amax(0) / 127
        mlp[name] = (torch.round(w / scale).to(torch.int8), scale)
    xs = {m: torch.randn((m, d), generator=gen, device=DEV).to(torch.bfloat16)
          for m in (N_SLOTS, PROMPT_ROWS)}
    bench = qm_inputs(torch, 256, 1024, 1024, "float32", gen)
    torch.cuda.synchronize()
    reset_launches(kern)
    outs = {}
    for m, x in xs.items():
        g = ops.quant_matmul(x, *mlp["w_gate"])
        u = ops.quant_matmul(x, *mlp["w_up"])
        h = (torch.nn.functional.silu(g) * u).to(torch.bfloat16)
        outs[m] = ((x, g, "w_gate"), (x, u, "w_up"),
                   (h, ops.quant_matmul(h, *mlp["w_down"]), "w_down"))
    y_bench = ops.quant_matmul(*bench)
    torch.cuda.synchronize()
    counts = launch_counts(kern)
    want = {e: 0 for e in counts}
    want["quant_matmul"] = 3 * len(xs) + 1
    assert counts == want, (counts, want)
    for m, triple in outs.items():
        for x, y, name in triple:
            assert y.shape == (m, mlp[name][0].shape[1]), (m, name)
            assert torch.isfinite(y).all(), (m, name)
            want_y = QM.quant_matmul_plain(x, *mlp[name])
            assert float((y - want_y).abs().max()) <= QM_TOL * float(
                want_y.abs().max()), (m, name)
    assert y_bench.shape == (256, 1024) and torch.isfinite(y_bench).all()
    log(f"[baseline] yi-6b gated MLP ({d} -> {ff} -> {d}) on the dense int8 "
        f"baseline at M = {sorted(xs)}, and kernel_bench's 256x1024x1024: "
        f"launches {counts}")
    return counts, mlp, bench


def cli(torch, kern, card):
    """Phase 6: ``repro_torch.launch.serve.main(argv)`` in-process, with
    its artifact in a temporary directory removed afterwards. Every run is
    driven with the launch counts at 0 and read after; ``deploy_weight`` is
    counted (the boots must pack nothing), and compress, save, boot and
    generate are timed on the host clock, synchronized. The mamba2-780m
    run serves its config in QAT, set by wrapping ``registry.get_config``
    (the CLI reads its config there), as the reference sets cim_mode only
    in code."""
    import shutil
    import tempfile
    from repro_torch.core import deploy as D
    from repro_torch.launch import serve as CLI
    from repro_torch.models import registry
    from repro_torch.serve import deployed as DP
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.server import BatchServer
    K = kern[0]
    rec = {"deploy_weight": 0, "reports": [], "secs": {}}
    orig = {"deploy_weight": (D, D.deploy_weight),
            "compress": (DP, DP.compress),
            "save_artifact": (DP, DP.save_artifact),
            "load_artifact_tiers": (DP, DP.load_artifact_tiers),
            "run": (BatchServer, BatchServer.run),
            "generate": (Engine, Engine.generate),
            "get_config": (registry, registry.get_config)}

    def timed(name, fn, keep=None):
        def wrapped(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            rec["secs"][name] = time.perf_counter() - t0
            if keep:
                rec[keep] = out
            return out
        return wrapped

    def deploy_weight(*a, **k):
        rec["deploy_weight"] += 1
        return orig["deploy_weight"][1](*a, **k)

    def run(self, requests):
        rep = orig["run"][1](self, requests)
        rec["reports"].append(rep)
        return rep

    D.deploy_weight = deploy_weight
    DP.compress = timed("pack", orig["compress"][1], keep="packed")
    DP.save_artifact = timed("save", orig["save_artifact"][1])
    DP.load_artifact_tiers = timed("boot", orig["load_artifact_tiers"][1],
                                   keep="booted")
    BatchServer.run = run
    Engine.generate = timed("generate", orig["generate"][1])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    art = os.path.join(tmp, "yi-6b")
    counts = {}

    def drive(label, argv):
        rec["deploy_weight"] = 0
        rec["reports"].clear()
        rec["secs"].clear()
        torch.cuda.synchronize()
        reset_launches(kern)
        log(f"[cli] {label}: main({' '.join(argv)})")
        out = CLI.main(argv)
        torch.cuda.synchronize()
        counts[f"cli {label}"] = launch_counts(kern)
        return out

    try:
        cfg = registry.get_config("yi-6b", dtype="bfloat16")
        yi = CLI_YI + ["--artifact", art]
        batch = {}
        for runtime in ("loop", "scan"):  # pack + save, then boot
            rep = drive(f"yi-6b batch {runtime}",
                        yi + CLI_BATCH + ["--runtime", runtime])
            forwards = sum(r.n_requests + r.n_decode_steps
                           for r in rec["reports"])
            want = compressed_launches(cfg, runtime, forwards)
            got = counts[f"cli yi-6b batch {runtime}"]
            assert got == want, (runtime, got, want)
            packs = 7 * cfg.n_layers + 1 if runtime == "loop" else 0
            assert rec["deploy_weight"] == packs, (runtime,
                                                   rec["deploy_weight"])
            j = rep.to_json()
            for rid, toks in rep.outputs.items():
                assert ((0 <= toks) & (toks < cfg.vocab)).all(), rid
            batch[runtime] = rep
            if runtime == "loop":
                size = sum(os.path.getsize(os.path.join(r, f))
                           for r, _, fs in os.walk(art) for f in fs)
                what = (f"pack_s {rec['secs']['pack']:.2f} save_s "
                        f"{rec['secs']['save']:.2f} artifact_bytes {size}")
            else:
                what = f"boot_s {rec['secs']['boot']:.2f} deploy_weight 0"
            log(f"[cli] yi-6b batch {runtime}: {what}; tokens_per_s "
                f"{rep.tokens_per_s:.2f} ttft_p50_s {j['ttft']['p50']} "
                f"decode_step_p50_s {j['tpot']['p50']} requests "
                f"{rep.n_requests} tokens {rep.total_tokens}; launches "
                f"{got} over {forwards} forwards (warm-up and measured "
                f"runs) ({card})")
        saved, booted = rec.pop("packed"), rec.pop("booted")[0]
        pairs = list(zip(saved.deployed().values(),
                         booted.deployed().values()))
        assert len(pairs) == 7 * cfg.n_layers + 1
        for a, b in pairs:
            for pa, pb in zip(a.packed, b.packed):
                for k in ("blocks", "scales", "row_idx", "nnz"):
                    assert pa[k].dtype == pb[k].dtype and torch.equal(
                        pa[k], pb[k]), k
        for a, b in ((saved.embed, booted.embed),
                     (saved.final_ln, booted.final_ln)):
            assert torch.equal(a, b)
        for la, lb in zip(saved.layers, booted.layers):
            assert torch.equal(la["ln1"], lb["ln1"])
            assert torch.equal(la["ln2"], lb["ln2"])
        del saved, booted, pairs
        for rid, toks in batch["loop"].outputs.items():
            assert (toks == batch["scan"].outputs[rid]).all(), rid
        log(f"[cli] booted packing equal to the saved one on the card "
            f"({7 * cfg.n_layers + 1} projections: int8 blocks, row_idx, "
            f"nnz, scales; embed and norms); scan tokens equal loop tokens "
            f"on all {batch['loop'].n_requests} requests")
        legacy = {}
        for runtime in ("scan", "loop"):
            out = drive(f"yi-6b legacy {runtime}",
                        yi + CLI_LEGACY + ["--runtime", runtime])
            new = int(CLI_LEGACY[CLI_LEGACY.index("--new-tokens") + 1])
            want = compressed_launches(cfg, runtime, new + 1)
            got = counts[f"cli yi-6b legacy {runtime}"]
            assert got == want, (runtime, got, want)
            assert rec["deploy_weight"] == 0
            assert out.shape == (4, new) and ((0 <= out) & (out < cfg.vocab)
                                              ).all()
            legacy[runtime] = out
            log(f"[cli] yi-6b legacy {runtime}: boot_s "
                f"{rec['secs']['boot']:.2f} generate_s "
                f"{rec['secs']['generate']:.3f} for {out.shape}; launches "
                f"{got} over {new + 1} forwards ({card})")
        assert (legacy["scan"] == legacy["loop"]).all()
        log("[cli] legacy Engine tokens equal over the stacked and the "
            "per-layer packing")
        # the CLI reads its config from the registry; serve it in QAT
        registry.get_config = lambda arch, **k: orig["get_config"][1](
            arch, **{"cim_mode": "qat", **k})
        mcfg = registry.get_config("mamba2-780m")
        assert mcfg.cim_mode == "qat"
        out = drive("mamba2-780m legacy", CLI_MAMBA)
        new = int(CLI_MAMBA[CLI_MAMBA.index("--new-tokens") + 1])
        got = counts["cli mamba2-780m legacy"]
        want = mamba_launches(mcfg, 1, new + 1)
        assert got == want, (got, want)
        assert out.shape == (4, new) and ((0 <= out) & (out < mcfg.vocab)
                                          ).all()
        log(f"[cli] mamba2-780m legacy: generate_s "
            f"{rec['secs']['generate']:.3f} for {out.shape}; launches {got} "
            f"over {new + 1} forwards ({card})")
    finally:
        for name, (owner, fn) in orig.items():
            setattr(owner, name, fn)
        shutil.rmtree(tmp, ignore_errors=True)
    return counts


def profile_run(torch, label, run, kernels):
    """Phase 5: where ``run`` spends the card's time, from torch.profiler
    (its own overhead slows the host, so the busy share it reports is a
    lower bound for an unprofiled run). ``kernels`` maps a name to a
    substring of the kernel's symbol."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        extra = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    events = [e for e in prof.key_averages() if dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:6]
    out = {"run": label, "wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / (wall * 1e3), **extra,
           **{f"{name}_ms": sum(dev_us(e) for e in events if sym in e.key)
              / 1e3 for name, sym in kernels.items()},
           "top": [[e.key[:60], dev_us(e) / 1e3, e.count] for e in top]}
    if not events:
        out = {"run": label,
               "device_time": "not measured (profiler saw no device time)"}
    log(json.dumps({"profile": out}))


def profile_serve(torch, cfg, sp):
    """A scan-engine serve run of 4 requests."""
    from repro_torch.serve import BatchConfig, BatchServer, Request
    srv = BatchServer(cfg, sp, engine="scan", device=DEV,
                      bcfg=BatchConfig(n_slots=N_SLOTS, block_size=16,
                                       n_blocks=96))
    reqs = make_trace(Request, cfg.vocab, seed=5)[:N_SLOTS]
    srv.run(reqs[:1])  # warm-up
    torch.cuda.synchronize()
    profile_run(torch, "yi-6b scan serve", lambda: {
        "decode_steps": srv.run(reqs).n_decode_steps},
        {"bsr_kernel": "bsr_matmul", "fake_quant_kernel": "fake_quant"})


def profile_mamba(torch, cfg, params):
    """A mamba2-780m Engine.generate: 4 x 1024 prompt tokens, 8 new."""
    from repro_torch.serve import Engine
    toks = torch.randint(0, cfg.vocab, (MAMBA_BATCH, MAMBA_PROMPT),
                         generator=torch.Generator(device=DEV).manual_seed(5),
                         device=DEV, dtype=torch.int32)
    eng = Engine(cfg, params)
    profile_run(torch, "mamba2-780m Engine.generate 8 new tokens", lambda: {
        "new_tokens": int(eng.generate({"tokens": toks}, 8).shape[1])},
        {"ssd_intra_kernel": "ssd_intra", "fake_quant_kernel": "fake_quant"})


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


def bound_ms(nbytes, flops, flops_per_s=F32_FLOPS_PER_S):
    """Least time for the work: the bytes it must move (each input read
    once, each output written once) over the HBM rate, or its operations
    at the card's peak for their type (f32 on the CUDA cores unless told
    otherwise); the larger of the two."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def bound(m, k, n, nnz, bk, bn, go):
    """The block-sparse product's bound: valid blocks, their scales and
    indices, x and y; 2 FLOPs per multiply-add of a valid block."""
    blocks = nnz * bk * bn
    return bound_ms(blocks + nnz * 8 + go * 4 + m * k * 4 + m * n * 4,
                    2 * m * blocks)


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


def times_mamba(torch, kern, cfg, params):
    """Phase 6: fake_quant on the in_proj input at prefill and decode and
    on the in_proj weight (each QAT call re-quantizes it), and
    ssd_intra_chunk at the serving shape, as the path calls them (bf16 in,
    f32 out)."""
    from repro_torch.core import quant as Q
    _, FQ, SI, _ = kern
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(6)
    bf16, f32 = torch.bfloat16, torch.float32
    d = cfg.d_model
    rows = []
    w = Q.tanh_normalize(params["layers"]["in_proj"][0].float(),
                         cfg.cim_alpha)
    for name, x in (
            ("act prefill", torch.randn((MAMBA_BATCH * MAMBA_PROMPT, d),
                                        generator=gen, device=DEV).to(bf16)),
            ("act decode", torch.randn((MAMBA_BATCH, d), generator=gen,
                                       device=DEV).to(bf16)),
            ("weight in_proj", w)):
        # read and write each element once; 5 f32 ops (2 compares, 2
        # multiplies, 1 rint) each
        b_ms, b_by = bound_ms(2 * x.numel() * x.element_size(),
                              5 * x.numel())
        row = {"shape": f"fake_quant {name}", "entry": "fake_quant",
               "dims": list(x.shape), "dtype": str(x.dtype)[6:],
               "kernel_ms": time_ms(torch, lambda: FQ.fake_quant(x, 8, True),
                                    flush),
               "bound_ms": b_ms, "bound_by": b_by,
               "plain_ms": time_ms(
                   torch, lambda: FQ.fake_quant_plain(x, 8, True), flush),
               "library_ms": None}
        rows.append(row)
        log(json.dumps(row))
    C = MAMBA_BATCH * MAMBA_PROMPT // cfg.ssm_chunk
    H, l, N = cfg.n_ssm_heads, cfg.ssm_chunk, cfg.ssm_state
    P = cfg.d_inner // H
    a = -torch.nn.functional.softplus(torch.randn((C, H, l), generator=gen,
                                                  device=DEV))
    b, c = (torch.randn((C, l, N), generator=gen, device=DEV).to(bf16)
            for _ in range(2))
    x = torch.randn((C, l, H, P), generator=gen, device=DEV).to(bf16)
    # the least work: C B^T once per chunk, (s * L) @ x once per head, over
    # the causal pairs i >= j only (L is 0 above the diagonal), l (l + 1) / 2
    # of them, 2 FLOPs per multiply-add; a, b, c, x read once and y (f32)
    # written once
    pairs = l * (l + 1) // 2
    b_ms, b_by = bound_ms(4 * C * H * l + 2 * 2 * C * l * N
                          + 2 * C * l * H * P + 4 * C * l * H * P,
                          C * (2 * pairs * N + H * 2 * pairs * P))
    row = {"shape": "ssd_intra serve", "entry": "ssd_intra_chunk",
           "dims": {"C": C, "H": H, "l": l, "N": N, "P": P},
           "dtype": "bfloat16 in, float32 out",
           "kernel_ms": time_ms(torch, lambda: SI.ssd_intra_chunk(
               a, b, c, x, out_dtype=f32), flush),
           "bound_ms": b_ms, "bound_by": b_by,
           "plain_ms": time_ms(torch, lambda: SI.ssd_intra_chunk_plain(
               a, b, c, x, out_dtype=f32), flush),
           "library_ms": None}
    rows.append(row)
    log(json.dumps(row))
    return rows


def times_quant_matmul(torch, QM, cfg, mlp, bench):
    """Phase 8: quant_matmul at the baseline path's yi-6b shapes (w_gate
    and w_down at decode and prefill rows, bf16 x) and kernel_bench's.
    Bound: x read once, the int8 weight, the scales, f32 y written once,
    or 2 MKN FLOPs at the bf16 tensor-core rate for bf16 x (exact: see
    BF16_TC_FLOPS_PER_S) and the f32 rate for f32 x; library: torch.matmul of x.float() with the f32
    weight made ahead, then the scale (TF32 off)."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(9)
    cases = [(f"{name} {label}", torch.randn((m, w.shape[0]), generator=gen,
                                              device=DEV).to(torch.bfloat16),
              w, scale)
             for name in ("w_gate", "w_down") for w, scale in [mlp[name]]
             for label, m in (("decode", N_SLOTS), ("prefill", PROMPT_ROWS))]
    cases.append(("kernel_bench", *bench))
    rows = []
    for name, x, w, scale in cases:
        (m, k), n = x.shape, w.shape[1]
        w_f32 = w.float()
        rate = (BF16_TC_FLOPS_PER_S if x.dtype == torch.bfloat16
                else F32_FLOPS_PER_S)
        b_ms, b_by = bound_ms(m * k * x.element_size() + k * n + 4 * n
                              + 4 * m * n, 2 * m * k * n, rate)
        row = {"shape": f"quant_matmul {name}", "entry": "quant_matmul",
               "M": m, "K": k, "N": n, "dtype": str(x.dtype)[6:],
               "kernel_ms": time_ms(torch, lambda: QM.quant_matmul(
                   x, w, scale), flush),
               "bound_ms": b_ms, "bound_by": b_by,
               "plain_ms": time_ms(torch, lambda: QM.quant_matmul_plain(
                   x, w, scale), flush),
               "library_ms": time_ms(torch, lambda: torch.matmul(
                   x.float(), w_f32) * scale, flush)}
        rows.append(row)
        log(json.dumps(row))
        del w_f32
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
    from repro_torch.kernels import fake_quant as FQ
    from repro_torch.kernels import quant_matmul as QM
    from repro_torch.kernels import ssd_intra as SI
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
    kern = (K, FQ, SI, QM)
    mcfg = registry.get_config("mamba2-780m", cim_mode="qat")
    max_err = check_kernels(torch, K, Q, shapes)
    max_err["fake_quant"] = check_fake_quant(torch, FQ)
    max_err["ssd_intra_chunk"] = check_ssd_intra(torch, SI, mcfg)
    max_err["quant_matmul"] = check_quant_matmul(torch, QM)

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
    counts = serve(torch, kern, cfg, sp)
    sxp = ST.stack(sp)
    plain_path_agreement(torch, kern, cfg, sp, sxp)

    log(f"[mamba] mamba2-780m at full width and depth ({mcfg.n_layers} "
        f"layers, d_model {mcfg.d_model}, d_inner {mcfg.d_inner}, "
        f"{mcfg.n_ssm_heads} heads of {mcfg.d_inner // mcfg.n_ssm_heads}, "
        f"state {mcfg.ssm_state}, chunk {mcfg.ssm_chunk}, vocab "
        f"{mcfg.vocab}, {mcfg.dtype}), cim_mode {mcfg.cim_mode} "
        f"w{mcfg.w_bits}a{mcfg.a_bits}; random weights, seed 0")
    mparams = init_params(mcfg, torch.Generator(device=DEV).manual_seed(0))
    n_params = sum(v.numel() for v in mparams["layers"].values()) + sum(
        v.numel() for k, v in mparams.items() if k != "layers")
    log(f"[mamba] {n_params / 1e6:.1f} M parameters")
    counts["mamba"] = serve_mamba(torch, kern, mcfg, mparams)
    counts["baseline"], mlp, bench = baseline(torch, kern,
                                              registry.get_config("yi-6b"))
    counts.update(cli(torch, kern, card))

    profile_serve(torch, cfg, sp)
    profile_mamba(torch, mcfg, mparams)
    rows = (times(torch, K, Q, sp, sxp)
            + times_mamba(torch, kern, mcfg, mparams)
            + times_quant_matmul(torch, QM, cfg, mlp, bench))
    pick = {"bsr_matmul_stacked": "w_gate decode", "bsr_matmul": "head decode",
            "fake_quant": "fake_quant act prefill",
            "ssd_intra_chunk": "ssd_intra serve",
            "quant_matmul": "quant_matmul w_gate decode"}
    source = {"bsr_matmul_stacked": "bsr_matmul.cu",
              "bsr_matmul": "bsr_matmul.cu", "fake_quant": "fake_quant.cu",
              "ssd_intra_chunk": "ssd_intra.cu",
              "quant_matmul": "quant_matmul.cu"}
    replaces = {"bsr_matmul": "src/repro/kernels/cim_bsr_matmul.py:83",
                "bsr_matmul_stacked": "src/repro/kernels/cim_bsr_matmul.py:138",
                "fake_quant": "src/repro/kernels/fake_quant.py:28",
                "ssd_intra_chunk": "src/repro/kernels/ssd_intra.py:47",
                "quant_matmul": "src/repro/kernels/quant_matmul.py:40"}
    kernels = []
    for entry in pick:
        row = next(r for r in rows if r["shape"] == pick[entry])
        launches = sum(c.get(entry, 0) for c in counts.values())
        assert launches > 0, entry
        kernels.append({
            "name": entry, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source[entry]}",
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
