#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the repository root on a machine with a GPU, nvcc and no JAX
needed. Phases (any failure exits non-zero):

  1. build  - every CUDA source in src/repro_torch/csrc with nvcc (sm_90a),
              one nvcc per source, all started together;
  2. kernel - each kernel against its plain PyTorch version on the card:
              the block-sparse int8 kernel at full-width yi-6b shapes on
              its 16-byte path and at two tiles on its masked path
              (decode, speculative verify and prefill rows, a draft-tier
              packing at SPEC_DRAFT_SPARSITY, eq. 5 f32, off-grid f32 and bf16
              inputs, poisoned padding, truncated packings, stacked and
              single-layer entry points), each call repeated bit for bit
              and each layer's own packing bit for bit equal to the
              envelope, launches counted by path; the same kernel at
              every MARS tile the schedule searches can propose (8-64 a
              side; bn = 8 on the masked path) at every distinct
              full-width yi-6b projection shape, at MARS_ROWS (autotune's
              decode and prefill rows), the same checks; fake_quant bit for bit (bits 2/4/8, signed and
              unsigned, every (in, out) pair of f32 and bf16, ragged
              sizes, NaN, +-inf and exact half-levels, misaligned views
              at odd lengths); ssd_intra_chunk at the full-width
              mamba2-780m shape and SSD_SHAPES (f32 at 1e-4, bf16 in at
              2e-2, each call repeated bit for bit, bf16 in with f32 out
              against the function in f64), launches counted by path;
              quant_matmul at test_kernels.py's, kernel_bench's and
              full-width yi-6b's shapes and at its plan's edges within
              QM_TOL of max |plain|, each call repeated bit for bit, with x
              a row and column slice of a NaN-poisoned buffer in two cases
              (the masked load path; the yi-6b and kernel_bench shapes on
              the 16-byte path, by the per-path launch counts); the paged
              decode-attention kernel at yi-6b's heads (32 over 4 kv
              heads, dh 128) over DA_VIEWS (the main path's view and
              serving contexts), decode and verify rows and a
              prefix-suffix row (one slot, DA_PREFIX_T tokens over
              DA_PREFIX_VIEW positions), a sliding window and padded
              heads, bf16 within DA_TOL of max |plain| and f32 within
              DA_F32_TOL, each call repeated bit for bit, every
              multi-token launch bit for bit equal to one-token launches
              over views cut past each position, the k_new/v_new path bit
              for bit equal to the spliced view at every view, and at the
              longest view (more chunks than a cluster has CTAs) other
              launch plans bit for bit equal; the paged pass's row-by-row
              norm equal alone and in batches of 1 to NORM_ROWS rows;
              the straight-through backward of fake_quant bit for bit
              (both modes, bits 2/4/8, signed and unsigned, every (x,
              grad) pair of f32 and bf16, x on and one step either side of
              the clamp bounds, NaN, +-inf, misaligned views at odd
              lengths); the SSD intra-chunk backward at the train phase's
              mamba2-780m shape, the serving shape and SSD_SHAPES (f32
              within SSD_BWD_TOL of each gradient's max |plain|, bf16 in
              within 2e-2, each call repeated bit for bit);
  3. serve yi-6b - yi-6b at full width in bf16, depth cut to 4 layers,
              random weights from a seed, compressed (uniform 128x128 tile,
              60% tile sparsity) and served by BatchServer on the scan and
              the loop runtime; tokens must match, the launch counts must
              prove every projection went through the block-sparse kernel
              and its eq. 5 activations through fake_quant, and the kernel
              path's logits must agree with the plain path's; then the
              same packing saved, booted on the CPU and run there: the
              card-vs-CPU logit gap, greedy tokens by the margin rule and
              the eq. 5 levels that differ, per projection; then
              self-speculative decoding on the same packing: a draft tier
              re-pruned to SPEC_DRAFT_SPARSITY (serve/spec.draft_serving),
              one verify pass of k+1 tokens held bit for bit against k+1
              one-token steps, and the trace served by the spec engine
              with the reprune draft (k = SPEC_K) and with the layer-skip
              draft (keep = SPEC_KEEP), and by the scan engine with a
              recording Tracer and MetricsRegistry: tokens bit for bit
              equal to the plain scan run's, launch counts exact from each
              run's own SpecStats, the Chrome trace and the metrics
              snapshot validated; then both families with a draft equal
              to the target (the target's own packing as the reprune
              tier, layer-skip keep = 1.0): every proposal accepted, so
              the accepted runs, their multi-position commits and the
              draft tier's KV after an accept are driven on the card;
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
              decode and prefill rows, and kernel_bench's shape, every
              launch on the kernel's 16-byte path;
  6. cli    - the serving CLI, repro_torch.launch.serve.main, in-process:
              full-width, full-depth yi-6b packed, saved as an artifact and
              served on the loop runtime; booted from the artifact (no
              packing; the booted packing equal to the saved one) and served
              on the scan runtime with the same tokens; the legacy Engine
              over the stacked and the per-layer packing, equal tokens;
              full-width, full-depth mamba2-780m (QAT) through the Engine
              fallback; the booted artifact once more with --spec
              draft=layerskip (no second packing), --trace-out and
              --metrics-out, tokens equal to the booted scan run's and
              both files validated; launch counts for every run;
  7. profile - torch.profiler over a short scan-engine run, a short
              spec-engine run and a short mamba2 generate: the device's
              busy share and its top kernels, and in the yi-6b runs
              exactly one decode-attention kernel per wrapper call;
  8. times  - kernel, bound, plain-version and library times per shape
              (the block-sparse kernel at all six yi-6b rows and at w_gate
              and w_down's decode and prefill rows at phase 9's tiles: the
              full-depth schedule's, autotune's winner, 16x16 and 8x8; the
              decode-attention kernel at decode and verify rows over
              DA_VIEWS and the prefix-suffix row), and the per-launch
              device time of the block-sparse, fake_quant, ssd_intra and
              decode-attention kernels; the two backward kernels at the
              train phase's shapes;
  9. sched  - run after phase 6 (phase 8 times its tiles): the MARS
              schedule search at full width. default_schedule over
              full-depth yi-6b in a process of its own, started before
              the build (its seconds and tile); the CLI in-process at
              full width cut to SCHED_LAYERS layers: --autotune
              SCHED_TOPN on a fresh pack (the measured table, the winner
              never slower than the simulated pick, measure_tile's
              launches counted), the artifact booted (a cache hit, no
              re-timing, the same tokens), --compressed with no --tile on
              the loop runtime (every launch at its projection's schedule
              tile), executor.verify_layer at each projection shape and
              obs.gap.kernel_gap on the card, and --spec auto over the
              booted artifact (the scan run's tokens, spec or declined);
 10. train  - run after phase 9: QAT training (--cim w8a8, group lasso
              1e-5, AdamW, f32) through repro_torch.launch.train.main
              in-process, under torch.use_deterministic_algorithms(True):
              yi-6b at full width cut to TRAIN_YI_LAYERS layers (30 steps
              of 4 x 256 tokens) and mamba2-780m at full width and depth
              (8 steps of 2 x 512); for each, one step's gradients against
              the plain path (fake_quant swapped: bit for bit; mamba2's SSD
              kernels swapped too, f32 dense mode: within TRAIN_GRAD_TOL),
              the loss finite and falling, launch counts exact (every
              projection's forward and backward through fake_quant and
              fake_quant_bwd, every mamba2 layer's through both SSD
              kernels), step ms and tokens/s, a SIGTERM after step STOP
              (checkpoint and exit 0) and --resume reaching the straight
              run's parameters and moments bit for bit, and one more step
              profiled (phase 7); phase 8 then times both backward kernels
              at these shapes;
 11. cnn    - run after phase 10: the paper's CNNs (repro_torch.models.cnn)
              driven as tests/test_system.py and examples/compress_cnn.py
              drive the reference's, under
              torch.use_deterministic_algorithms(True) in f32:
              VGG16-CIFAR and ResNet18-CIFAR at full width (cim_config()'s
              QAT w8a4, alpha = N = 16, lambda_g 1e-4; random weights from
              a seed; CNN_BATCH 32x32 images of ImagePipeline a step): one
              train step's loss, gradients and BN state equal bit for bit
              to the plain path's (fake_quant and its backward swapped),
              CNN_STEPS steps of the reference's SGD update (step ms,
              images/s, peak memory, the loss finite, launch counts exact:
              two fake_quant launches a conv a forward, fake_quant_bwd on
              every weight and every conv input but the images), one step
              profiled (phase 7), prune_all at CNN_TARGET (each conv's
              zero group-set proportion), CNN_RETRAIN masked steps (the
              masks unchanged, every masked weight's effective weight 0),
              an eval forward on a held-out batch equal bit for bit to the
              plain path's (its accuracy printed); VGG16's deepest conv
              deployed as a 4608 x 512 eqs. 6-8 matrix at 16x16 tiles
              through ops.bsr_matmul at CNN_DEPLOY_ROWS rows (within 1e-5
              of the plain version and of x @ w2d; timed in phase 8 with
              fake_quant and its backward at the phase's widest shapes);
              the reference's own CNN learning check (SMALL_PLAN, w4a4,
              CNN_SMALL_STEPS steps: the mean of the last 5 losses under
              the first 5's by 0.05).

Prints the card's name and power limit, one JSON line per timed shape, a
``{"kernels": [...]}`` line (the block-sparse and decode-attention entries
with the timed row that fares worst against its library call), and as its
last line
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
# bf16 x bf16 products summed in f32) and for f32 x split into three bf16
# planes, as quant_matmul's kernel multiplies it
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_TC_FLOPS_PER_S = 989e12

N_LAYERS = 4
N_SLOTS = 4
PROMPT_ROWS = 128  # the longest prompt of the trace: the prefill row count
TILE = (128, 128)
SPARSITY = 0.6
DEV = "cuda"
# self-speculative decoding (phase 3): draft length, the reprune draft's
# sparsity, the layer-skip draft's kept share of sublayers; a verify pass
# runs N_SLOTS * (SPEC_K + 1) rows through every projection
SPEC_K = 4
SPEC_DRAFT_SPARSITY = 0.9
SPEC_KEEP = 0.5
VERIFY_ROWS = N_SLOTS * (SPEC_K + 1)
# the paged decode-attention kernel (phases 2 and 8): bf16 output within
# DA_TOL of max |plain| (a score or a probability may round to the other
# bf16 neighbour where the two orders of an f32 sum straddle a rounding
# edge; tests/test_torch_decode_attention.py holds the kernel's order,
# emulated on the CPU, to the same bar), f32 within DA_F32_TOL; views of
# the main path's length and of serving contexts of 1k and 4k positions
DA_TOL = 2e-2
DA_F32_TOL = 1e-5
DA_VIEWS = (160, 1024, 4096)
# the prefix-cache suffix pass: one slot's unshared prompt tokens through
# one verify pass over its view
DA_PREFIX_T = 64
DA_PREFIX_VIEW = 1024
# the paged pass's norm holds each row equal alone and in batches of 1 to
# NORM_ROWS rows (phase 2): a verify runs N_SLOTS * (k + 1) rows, a suffix
# prefill up to a prompt's length
NORM_ROWS = 256

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

# phase 2's ssd_intra shapes beside the serving one, (C, H, l, N, P): the
# ragged case (l, N, P off the tile grid: the masked path), l < 16, H = 1,
# and l past one pass over the kernel's 256 S columns; bf16 in, f32 out
# within SSD_F64_TOL of max |f64| of the function in f64 (or no farther
# than the f32 plain version is)
SSD_SHAPES = ((3, 5, 100, 20, 70), (2, 3, 9, 16, 64), (4, 1, 64, 32, 64),
              (2, 4, 600, 64, 64))
SSD_F64_TOL = 1e-5
# phase 2's SSD intra-chunk backward in f32: each gradient within this share
# of its max |plain| (f32 sums in another order; the forward's bar)
SSD_BWD_TOL = 1e-4
# the backward kernel's bf16 tensor-core products per multiply-add of f32
# operands (three exact planes a side, the six plane products of order <=
# 2^-16; csrc/ssd_intra_bwd.cu), which phase 8's bound counts
SSD_BWD_PASSES = 6

# the train phase: QAT (--cim, w8a8, group lasso 1e-5) training through the
# CLI in f32 with AdamW on TokenPipeline. yi-6b at full width, depth cut to
# TRAIN_YI_LAYERS: AdamW holds 16 B a parameter with the gradient, and 2
# layers are 0.87 G parameters (14 GB; the 64000 x 4096 embedding and head
# are 0.52 G of them), 30 steps of 4 x 256 tokens. mamba2-780m at full width
# and depth (0.86 G parameters), 8 steps of 2 x 512 tokens (two 256-token
# chunks a row). Each run is stopped by SIGTERM after its STOP step and
# resumed from that checkpoint. TRAIN_GRAD_TOL: the SSD kernels' gradients
# against the plain path's at full depth in f32 dense mode, per leaf
# (relative L2; f32 sums in another order through 48 layers).
TRAIN_YI_LAYERS = 2
TRAIN_YI_BATCH, TRAIN_YI_SEQ = 4, 256
TRAIN_YI_ROWS = TRAIN_YI_BATCH * TRAIN_YI_SEQ
TRAIN_COMMON = ["--cim", "--w-bits", "8", "--a-bits", "8", "--lambda-g",
                "1e-5", "--opt", "adamw", "--dtype", "float32", "--seed", "0",
                "--ckpt-every", "1000"]
TRAIN_YI = ["--arch", "yi-6b", "--batch", str(TRAIN_YI_BATCH), "--seq",
            str(TRAIN_YI_SEQ), "--steps", "30", "--log-every", "5",
            *TRAIN_COMMON]
TRAIN_YI_STOP = 20
TRAIN_MAMBA_BATCH, TRAIN_MAMBA_SEQ = 2, 512
TRAIN_MAMBA = ["--arch", "mamba2-780m", "--batch", str(TRAIN_MAMBA_BATCH),
               "--seq", str(TRAIN_MAMBA_SEQ), "--steps", "8", "--log-every",
               "2", *TRAIN_COMMON]
TRAIN_MAMBA_STOP = 5
TRAIN_GRAD_TOL = 1e-3

# the cnn phase (11): the paper's VGG16-CIFAR and ResNet18-CIFAR at full
# width with cim_config()'s defaults (QAT w8a4, alpha = N = 16, lambda_g
# 1e-4), f32, on ImagePipeline's 32x32 images, CNN_BATCH a step; CNN_STEPS
# steps of the reference's update (p - CNN_LR g, tests/test_system.py),
# pruning to CNN_TARGET of the group-set tiles (examples/compress_cnn.py's
# default), CNN_RETRAIN masked steps; the deepest VGG16 conv deployed at
# 16x16 tiles through the block-sparse kernel at CNN_DEPLOY_ROWS rows; the
# reference's own learning check (test_cnn_qat_prune_deploy_pipeline's
# configuration) at CNN_SMALL_STEPS steps
CNN_BATCH = 128
CNN_STEPS = 20
CNN_LR = 0.05
CNN_TARGET = 0.7
CNN_RETRAIN = 10
CNN_DEPLOY_ROWS = (32, 128)
CNN_SMALL_STEPS = 60

# card vs CPU (phase 3): a greedy divergence is a fault where the card's
# top-2 logit margin exceeds the bf16 kernel tolerance (the model is bf16)
MARGIN_TOL = 2e-2

# phase 2's block-sparse tiles that miss the 16-byte conditions (bn not a
# multiple of 16), as (d_in, d_out, (bk, bn)); bk != bn, not powers of two
MASKED_TILES = [(4000, 2400, (40, 24)), (2400, 4000, (24, 40))]

# phase 2's MARS tiles: every (bk, bn) the two schedule searches can
# propose (default_schedule: 16-64 a side; autotune: 8-32), at every
# distinct full-width yi-6b projection shape, at autotune.measure_tile's
# decode and prefill rows; bn = 8 misses the 16-byte conditions (masked)
MARS_SIDES = (8, 16, 32, 64)
MARS_ROWS = (4, 32)

# quant_matmul against its plain version: max |kernel - plain| within this
# share of max |plain| (both widen x to f32 exactly and multiply int8
# levels exactly; only the order of the f32 sums differs)
QM_TOL = 1e-4
# (M, K, N, x dtype): tests/test_kernels.py's four, benchmarks/
# kernel_bench.py's, full-width yi-6b's w_gate / w_down at decode and
# prefill rows, then the kernel's plan edges: tile heights 16 / 64 / 128
# on both sides of each edge, split-K with f32 x, K shorter than one
# stage, N < 8
QM_SHAPES = [(128, 256, 256, "float32"), (100, 200, 300, "float32"),
             (256, 128, 512, "bfloat16"), (64, 384, 128, "float32"),
             (256, 1024, 1024, "float32"),
             (N_SLOTS, 4096, 11008, "bfloat16"),
             (PROMPT_ROWS, 4096, 11008, "bfloat16"),
             (N_SLOTS, 11008, 4096, "bfloat16"),
             (PROMPT_ROWS, 11008, 4096, "bfloat16"),
             (1, 4096, 4096, "bfloat16"), (16, 1024, 512, "float32"),
             (17, 1024, 512, "bfloat16"), (64, 512, 384, "float32"),
             (65, 512, 384, "bfloat16"), (8, 4096, 1024, "float32"),
             (96, 40, 256, "bfloat16"), (33, 520, 5, "float32")]
QM_POISONED = {(100, 200, 300), (N_SLOTS, 4096, 11008)}
# the shapes whose contiguous x must take the kernel's 16-byte path (the
# poisoned slices, row stride K + 5, take the masked one)
QM_ALIGNED = {(256, 1024, 1024), (N_SLOTS, 4096, 11008),
              (PROMPT_ROWS, 4096, 11008), (N_SLOTS, 11008, 4096),
              (PROMPT_ROWS, 11008, 4096)}

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
# the cli phase's speculative run over the booted 32-layer artifact
CLI_SPEC = ["--runtime", "scan", "--spec",
            f"draft=layerskip,keep={SPEC_KEEP},k={SPEC_K}"]
# the sched phase (9): the CLI's runs at full width cut to SCHED_LAYERS
# layers, packed by --autotune SCHED_TOPN or the schedule search (no
# --tile); the full-depth search in its own process must end within
# SEARCH_TIMEOUT s of being waited for; executor.verify_layer holds the
# kernel to the dense oracle within VERIFY_TOL x max |oracle| (eq. 5 x and
# int8 levels are exact on both sides; f32 sums of 4096-11008 terms in
# another order, as phase 2's 1e-5)
CLI_SCHED = ["--arch", "yi-6b", "--dtype", "bfloat16", "--compressed",
             "--target-sparsity", str(SPARSITY)] + CLI_BATCH
SCHED_LAYERS = 4
SCHED_TOPN = 3
SEARCH_TIMEOUT = 900
VERIFY_TOL = 1e-5


def log(*a) -> None:
    print(*a, flush=True)


def reset_launches(kern) -> None:
    for mod in kern:
        mod.reset_launches()


def launch_counts(kern) -> dict:
    K, FQ, SI, QM, DA = kern
    return dict(K.LAUNCHES_BY_ENTRY, fake_quant=FQ.LAUNCHES,
                ssd_intra_chunk=SI.LAUNCHES, quant_matmul=QM.LAUNCHES,
                decode_attention=DA.LAUNCHES)


def mamba_launches(cfg, prefills, forwards) -> dict:
    """The launches of a QAT mamba2 Engine run: fake_quant on the
    activations and the weight of in_proj and out_proj in every layer and
    of the head, every forward; ssd_intra_chunk once per layer in every
    prefill."""
    return {"bsr_matmul": 0, "bsr_matmul_stacked": 0,
            "fake_quant": 2 * (2 * cfg.n_layers + 1) * forwards,
            "ssd_intra_chunk": cfg.n_layers * prefills, "quant_matmul": 0,
            "decode_attention": 0}


def compressed_launches(cfg, engine, forwards, paged) -> dict:
    """The launches of ``forwards`` forwards of a compressed dense model:
    7 projections per layer and the head, each on the block-sparse kernel
    (the scan runtime's layers on the stacked entry, the head and the loop
    runtime on the single-layer one) after eq. 5 on fake_quant; and the
    decode-attention kernel once a layer in each of the ``paged`` forwards
    that attend over the KV cache (decode steps and prefix-hit suffix
    prefills; a full prefill attends in plain torch)."""
    passes = 7 * cfg.n_layers + 1
    want = ({"bsr_matmul_stacked": 7 * cfg.n_layers * forwards,
             "bsr_matmul": forwards} if engine == "scan"
            else {"bsr_matmul_stacked": 0, "bsr_matmul": passes * forwards})
    want.update(fake_quant=passes * forwards, ssd_intra_chunk=0,
                quant_matmul=0, decode_attention=cfg.n_layers * paged)
    return want


def paged_passes(rep) -> int:
    """A BatchServer run's forwards over the paged KV cache: every decode
    step and every prefix-hit suffix prefill."""
    return rep.n_decode_steps + rep.prefix["hits"]


def spec_launches(cfg, rep, masks=None) -> dict:
    """The launches of a spec-engine run, from its own SpecStats: every
    prefill is a full forward (7 projections a layer and the head; the
    reprune draft tier prefills too), every round a full verify forward
    plus the draft's steps - k+1 full forwards over the draft envelope
    (reprune), or k steps that run only the kept sublayers' projections
    (4 for an attention, 3 for an MLP) and the head (layerskip). The
    decode-attention kernel runs once a layer in every verify, every
    reprune draft step and every prefix-hit suffix prefill (on both tiers
    for reprune), and once a kept attention in every layerskip step."""
    ks = rep.spec["round_k"]
    hits = rep.prefix["hits"]
    assert len(ks) == rep.spec["n_rounds"] == rep.n_decode_steps
    if masks is None:  # reprune
        full = 2 * rep.n_requests + sum(k + 2 for k in ks)
        stacked, single = 7 * cfg.n_layers * full, full
        attn = cfg.n_layers * (2 * hits + sum(k + 2 for k in ks))
    else:
        attn_on, mlp_on = masks
        full = rep.n_requests + len(ks)
        steps = sum(ks)
        stacked = (7 * cfg.n_layers * full
                   + (4 * sum(attn_on) + 3 * sum(mlp_on)) * steps)
        single = full + steps
        attn = cfg.n_layers * (hits + len(ks)) + sum(attn_on) * steps
    return {"bsr_matmul_stacked": stacked, "bsr_matmul": single,
            "fake_quant": stacked + single, "ssd_intra_chunk": 0,
            "quant_matmul": 0, "decode_attention": attn}


@contextlib.contextmanager
def plain_kernels(kern, attention=False):
    """The block-sparse, fake_quant and ssd_intra wrappers swapped for their
    plain versions (on the card), and with ``attention`` the
    decode-attention wrapper too; every other op unchanged."""
    K, FQ, SI, _, DA = kern
    saved = K._run, FQ.fake_quant, SI.ssd_intra_chunk, DA.decode_attention
    K._run = lambda entry, x, *ops: K.bsr_matmul_stacked_plain(x, *ops)
    FQ.fake_quant = FQ.fake_quant_plain
    SI.ssd_intra_chunk = SI.ssd_intra_chunk_plain
    if attention:
        DA.decode_attention = DA.decode_attention_plain
    try:
        yield
    finally:
        (K._run, FQ.fake_quant, SI.ssd_intra_chunk,
         DA.decode_attention) = saved


def da_inputs(torch, cfg, t, sv, gen, dtype, slots=N_SLOTS, q_dtype=None):
    """Decode-attention inputs at yi-6b's heads: ``slots`` rows of t query
    tokens over views of sv positions, N_SLOTS rows at four depths (the
    first one's tokens cross a chunk edge of the kernel), a single row at
    the end of the view; K/V in ``dtype``, q in ``q_dtype`` (default the
    same; f32 over bf16 K/V is the compressed serving path's form, where q
    comes out of the block-sparse kernel in f32)."""
    q = torch.randn((slots, t, cfg.n_heads, cfg.dh), generator=gen,
                    device=DEV).to(q_dtype or dtype)
    k, v = (torch.randn((slots, sv, cfg.n_kv_heads, cfg.dh), generator=gen,
                        device=DEV).to(dtype) for _ in range(2))
    depths = ([min(254, sv - t), sv // 3, sv // 2, sv - t] if slots > 1
              else [sv - t])
    pos = torch.tensor(depths, dtype=torch.int32, device=DEV)
    return q, k, v, pos


def check_decode_attention(torch, DA, cfg):
    """Phase 2: the paged decode-attention kernel against its plain
    version at yi-6b's heads over DA_VIEWS, decode (T = 1) and verify
    (T = SPEC_K + 1) rows, and a prefix-suffix row (one slot, T =
    DA_PREFIX_T over DA_PREFIX_VIEW positions), bf16 within DA_TOL of max
    |plain| (f32 within DA_F32_TOL at the main view, and f32 q over bf16
    K/V, the serving path's form, within DA_F32_TOL at every view), a
    sliding window and zero-padded heads at the main view; every call
    repeated bit for bit; each multi-token launch against T one-token
    launches over views cut
    just past each position, bit for bit; the k_new/v_new path bit for bit
    equal to the view with them spliced in, at every view; at the longest
    view (more chunks than a cluster has CTAs) the launch under other plans
    (smaller clusters, partials added in rounds, scores recomputed from K)
    bit for bit equal to the wrapper's plan. Then the paged pass's norm
    (``layers.rmsnorm_rows`` at d_model) on every row count from 1 to
    NORM_ROWS, each row equal to the row alone; beside it, printed and not
    held, the first row count at which the library norm
    (``layers.rmsnorm``) is not. Returns the largest |kernel - plain|."""
    from repro_torch.models import layers as L
    gen = torch.Generator(device=DEV).manual_seed(21)
    DA.reset_launches()
    n, worst = 0, 0.0
    bf16, f32 = torch.bfloat16, torch.float32
    rows = [(q_dt, tol, sv, t, N_SLOTS) for q_dt, tol in ((bf16, DA_TOL),
                                                          (f32, DA_F32_TOL))
            for sv in DA_VIEWS for t in (1, SPEC_K + 1)]
    rows += [(q_dt, tol, DA_PREFIX_VIEW, DA_PREFIX_T, 1)
             for q_dt, tol in ((bf16, DA_TOL), (f32, DA_F32_TOL))]
    rows = [(q_dt, bf16, tol, sv, t, slots)
            for q_dt, tol, sv, t, slots in rows]
    rows += [(f32, f32, DA_F32_TOL, DA_VIEWS[0], t, N_SLOTS)
             for t in (1, SPEC_K + 1)]
    plans = {}
    for q_dt, dtype, tol, sv, t, slots in rows:
        q, k, v, pos = da_inputs(torch, cfg, t, sv, gen, dtype, slots, q_dt)
        padded = cfg.n_heads - cfg.n_kv_heads  # true heads
        cases = [(0, 0)] + ([(64, 0), (0, padded)]
                            if sv == DA_VIEWS[0] else [])
        for window, n_true in cases:
            got = DA.decode_attention(q, k, v, pos, window, n_true)
            again = DA.decode_attention(q, k, v, pos, window, n_true)
            n += 2
            assert torch.equal(got, again), (sv, t, window, n_true)
            want = DA.decode_attention_plain(q, k, v, pos, window,
                                             n_true).float()
            err = float((got.float() - want).abs().max())
            scale = max(1.0, float(want.abs().max()))
            assert err <= tol * scale, (q_dt, dtype, sv, t, window, err)
            worst = max(worst, err)
        full = got  # the last case's
        if t > 1:
            for ti in range(t):
                cut = int(pos.max()) + ti + 1
                one = DA.decode_attention(q[:, ti:ti + 1], k[:, :cut],
                                          v[:, :cut], pos + ti, window,
                                          n_true)
                n += 1
                assert torch.equal(one[:, 0], full[:, ti]), (sv, ti)
        # the step's own K/V from k_new / v_new, not spliced into the view
        b = q.shape[0]
        kn, vn = (torch.randn((b, t, cfg.n_kv_heads, cfg.dh), generator=gen,
                              device=DEV).to(dtype) for _ in range(2))
        at = (torch.arange(b, device=DEV)[:, None],
              pos.long()[:, None] + torch.arange(t, device=DEV)[None])
        assert torch.equal(
            DA.decode_attention(q, k, v, pos, 0, 0, kn, vn),
            DA.decode_attention(q, k.index_put(at, kn), v.index_put(at, vn),
                                pos)), ("k_new", sv, t)
        n += 2
        pl = DA.launch_plan(q, k, cfg.n_heads, q_dt, dtype)
        form = {(bf16, bf16): "", (f32, bf16): " f32q", (f32, f32): " f32"}
        plans[f"{sv}x{t}{form[q_dt, dtype]}"] = [
            pl.tokens, pl.cluster, pl.cache, pl.slots]
        if sv == DA_VIEWS[-1]:
            # more chunks than CTAs; other plans change no bit
            chunks = -(-sv // DA.chunk_keys(k.element_size()))
            assert chunks > pl.cluster, (chunks, pl)
            small = DA.plan(q.shape[0], t, cfg.n_heads, cfg.n_kv_heads, sv,
                            cfg.dh, q.element_size(), k.element_size(), 24)
            wrapper_plan = DA.launch_plan
            for other in (dataclasses.replace(pl, cache=0),  # recomputed
                          dataclasses.replace(pl, slots=1),  # rounds
                          small):  # other tiles and clusters
                DA.launch_plan = lambda *_, other=other: other
                try:
                    got = DA.decode_attention(q, k, v, pos, window, n_true)
                finally:
                    DA.launch_plan = wrapper_plan
                assert torch.equal(got, full), (sv, t, other)
                n += 1
        del q, k, v, full
    assert DA.LAUNCHES == n, (DA.LAUNCHES, n)
    g = torch.randn(cfg.d_model, generator=gen, device=DEV).to(
        cfg.param_dtype)
    x = (torch.randn((NORM_ROWS, cfg.d_model), generator=gen,
                     device=DEV) * 3).to(cfg.param_dtype)
    lib_first = "none"
    for norm in (L.rmsnorm, L.rmsnorm_rows):
        alone = torch.cat([norm(x[i:i + 1], g) for i in range(NORM_ROWS)])
        for rows in range(1, NORM_ROWS + 1):
            same = torch.equal(norm(x[:rows], g), alone[:rows])
            if norm is L.rmsnorm_rows:
                assert same, rows
            elif not same:
                lib_first = rows
                break
    log(f"[kernel] decode_attention: {n} launches at yi-6b's heads "
        f"({cfg.n_heads} over {cfg.n_kv_heads} kv heads, dh {cfg.dh}), "
        f"views {list(DA_VIEWS)}, T 1 and {SPEC_K + 1}, and T "
        f"{DA_PREFIX_T} over {DA_PREFIX_VIEW} in one slot, bf16, f32 q over "
        f"bf16 K/V and f32: "
        f"within tolerance of the plain version (max |diff| {worst:.4g}), "
        f"repeats bit for bit, multi-token rows bit for bit equal to "
        f"one-token launches, k_new/v_new bit for bit equal to the spliced "
        f"view, other plans at {DA_VIEWS[-1]} bit for bit equal; plans "
        f"[tokens, cluster, cache, slots] {plans}; rmsnorm_rows at d_model "
        f"{cfg.d_model}: every row equal alone and in batches of 1 to "
        f"{NORM_ROWS} rows (the library rmsnorm first differs at "
        f"{lib_first} rows)")
    return worst


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


def own_packing(st, i):
    """Layer ``i`` of a stacked packing as the loop runtime holds it: its
    own nnz_max (its largest count, at most the envelope's), contiguous."""
    blocks, scales, rows, counts = st
    nmax = max(min(int(counts[i].max()), blocks.shape[2]), 1)
    return [blocks[i, :, :nmax].contiguous(), scales[i, :, :nmax].contiguous(),
            rows[i, :, :nmax].contiguous(), counts[i].contiguous()]


def x_for(torch, Q, kind, m, k, gen):
    """Phase 2's activations: "eq5" f32 on the eq. 5 grid (as the serving
    path feeds the kernel: one MMA plane), "f32" raw normals (off the grid:
    three planes), "bf16" raw normals."""
    x = torch.randn((m, k), generator=gen, device=DEV)
    if kind == "eq5":
        return Q.quantize_activation(x, 8, signed=True)
    return x.to(torch.bfloat16) if kind == "bf16" else x


def check_kernels(torch, K, Q, shapes, mars_shapes):
    """Phase 2: every kernel entry point against the plain version, at
    full-width yi-6b shapes (the 16-byte path), at tiles that miss the
    16-byte conditions (the masked path) and at every MARS tile of the
    schedule searches over ``mars_shapes``, with eq. 5, off-grid f32 and
    bf16 inputs (off-grid f32 within 1e-5 of the plain version's function
    evaluated in f64, whose f32 evaluation is off it by more than that at
    these widths, as the log shows); per call, a second call equal bit for bit, and each
    layer's own packing (the loop runtime's) equal bit for bit to the
    envelope (the scan runtime's). The per-path launch counts must show
    the yi-6b shapes on the 16-byte path and the other tiles masked."""
    gen = torch.Generator(device=DEV).manual_seed(1)
    err = {}  # (entry, x kind) -> max |kernel - plain|
    exact = {}  # result -> max |result - f64 product| over off-grid f32 x
    tol = {"eq5": 1e-5, "f32": 1e-5, "bf16": 2e-2}
    n = 0

    def compare(entry, got, want, kind, what, want64=None):
        """Kernel against the plain version; off the eq. 5 grid (f32 x)
        against the plain version's function in f64 as well."""
        nonlocal n
        torch.cuda.synchronize()
        ref = want if want64 is None else want64
        torch.testing.assert_close(got.to(ref.dtype), ref, rtol=tol[kind],
                                   atol=tol[kind],
                                   msg=lambda m: f"{what}: {m}")
        key = (entry, kind)
        err[key] = max(err.get(key, 0.0), float((got - want).abs().max()))
        if want64 is not None:
            for side, v in ((entry, got), ("plain f32", want)):
                exact[side] = max(exact.get(side, 0.0), float(
                    (v.double() - want64).abs().max()))
        n += 1

    def run_cases(name, d_in, d_out, tile, cases, rows, kinds):
        bk, bn = tile
        for label, nmax, poison, *density in cases:
            st = random_packing(torch, 2, d_in // bk, d_out // bn, bk, bn,
                                density[0] if density else 0.4, gen,
                                nnz_max=nmax, poison=poison)
            own = [own_packing(st, i) for i in range(2)]
            for m in rows:
                for kind in kinds:
                    x = x_for(torch, Q, kind, m, d_in, gen)
                    what = f"{name} {tile} {label} M={m} {kind}"
                    for i in range(2):
                        lid = torch.tensor([i], dtype=torch.int32, device=DEV)
                        got = K.bsr_matmul_stacked(x, *st, lid)
                        again = K.bsr_matmul_stacked(x, *st, lid)
                        single = K.bsr_matmul(x, *own[i])
                        torch.cuda.synchronize()
                        assert torch.equal(got, again), f"{what}: repeat"
                        assert torch.equal(got, single), \
                            f"{what}: layer {i} packing != envelope"
                        want = K.bsr_matmul_stacked_plain(x, *st, i)
                        want64 = (x.double() @ K.dense_weight(
                            *st, i, d_in, torch.float64)
                            if kind == "f32" else None)
                        compare("bsr_matmul_stacked", got, want, kind, what,
                                want64)
                        compare("bsr_matmul", single, want, kind, what,
                                want64)
            del st, own

    K.reset_launches()
    for name, d_in, d_out in shapes:
        # the draft tier's density: many block columns hold 0-2 blocks
        cases = [("", None, False),
                 ("draft tier", None, False, 1.0 - SPEC_DRAFT_SPARSITY)]
        if name in ("wq", "w_down"):
            cases += [("poisoned", None, True), ("truncated", 3, False)]
        run_cases(name, d_in, d_out, TILE, cases,
                  (N_SLOTS, VERIFY_ROWS, PROMPT_ROWS), ("eq5", "f32", "bf16"))
    aligned = dict(K.LAUNCHES_BY_PATH)
    assert aligned["single masked"] == aligned["split masked"] == 0, aligned
    K.reset_launches()
    for d_in, d_out, tile in MASKED_TILES:
        run_cases("masked", d_in, d_out, tile,
                  [("poisoned", None, True), ("truncated", 3, False)],
                  (1, 17, 129), ("eq5", "f32", "bf16"))
    masked = dict(K.LAUNCHES_BY_PATH)
    assert masked["single aligned"] == masked["split aligned"] == 0, masked
    mars = {}
    for path in ("aligned", "masked"):
        K.reset_launches()
        for bk in MARS_SIDES:
            for bn in MARS_SIDES:
                if (bn % 16 == 0) != (path == "aligned"):
                    continue
                for d_in, d_out, _ in mars_shapes:
                    run_cases(f"{d_in}x{d_out}", d_in, d_out, (bk, bn),
                              [("", None, False)], MARS_ROWS,
                              ("eq5", "f32", "bf16"))
        mars[path] = dict(K.LAUNCHES_BY_PATH)
        other = "masked" if path == "aligned" else "aligned"
        assert mars[path][f"single {other}"] == mars[path][
            f"split {other}"] == 0, mars
    log(f"[kernel] {n} comparisons within tolerance (f32 1e-5, off-grid f32 "
        f"1e-5, bf16 2e-2) at rows {(N_SLOTS, VERIFY_ROWS, PROMPT_ROWS)} "
        "(decode, speculative verify, prefill), with a draft-tier packing "
        f"at density {1.0 - SPEC_DRAFT_SPARSITY:.1f} beside each yi-6b "
        "shape, each call repeated bit for bit and each layer's "
        "own packing bit for bit equal to the envelope; launches by path: "
        f"yi-6b shapes {aligned}, tiles {[t for _, _, t in MASKED_TILES]} "
        f"{masked}; MARS tiles {MARS_SIDES} x {MARS_SIDES} at "
        f"{[(i, o) for i, o, _ in mars_shapes]}, rows {MARS_ROWS}: "
        f"bn % 16 == 0 {mars['aligned']}, bn = 8 {mars['masked']}; "
        "max |kernel - plain|: " + ", ".join(
            f"{e} {d} {v:.3e}" for (e, d), v in sorted(err.items()))
        + "; off-grid f32 x held against the f64 product, max |result - "
        "f64|: " + ", ".join(f"{e} {v:.3e}" for e, v in sorted(exact.items())))
    return {e: max(v for (e2, _), v in err.items() if e2 == e)
            for e, _ in err}


def check_fake_quant(torch, FQ):
    """Phase 2: fake_quant against its plain version, bit for bit: NaN
    where the plain version has NaN, every other value equal, for every
    (input, output) pair of f32 and bf16. Inputs are 1.5-scaled normals
    salted with NaN, +-inf and exact half-levels (values whose product with
    the level count is k + 0.5 in f32); then views that start off a 16-byte
    boundary (``x[k:]``) at odd lengths."""
    gen = torch.Generator(device=DEV).manual_seed(2)
    shapes = [(1,), (3, 100, 130), (MAMBA_BATCH, 1536), (4096, 1536),
              (1536, 6448), (1_000_003,)]
    dtypes = (torch.float32, torch.bfloat16)
    n = ties = 0

    def compare(x, bits, signed, out, what):
        nonlocal n
        got = FQ.fake_quant(x, bits, signed, out_dtype=out)
        torch.cuda.synchronize()
        want = FQ.fake_quant_plain(x, bits, signed, out_dtype=out)
        assert got.dtype == out and got.shape == x.shape, what
        assert torch.equal(got.isnan(), want.isnan()), what
        assert torch.equal(got.nan_to_num(), want.nan_to_num()), what
        n += 1

    for bits in (2, 4, 8):
        for signed in (False, True):
            q = 2.0 ** (bits - 1) - 1.0 if signed else 2.0 ** bits - 1.0
            for dt in dtypes:
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
                    for out in dtypes:
                        compare(x, bits, signed, out,
                                (bits, signed, dt, out, shape))
    odd = 0
    for length in (7, 4099, 65_537, 1_000_003):
        buf = torch.randn((length + 3,), generator=gen, device=DEV) * 1.5
        buf[::89] = float("nan")
        for dt in dtypes:
            for k in (1, 3):
                x = buf.to(dt)[k:k + length]
                assert x.data_ptr() % 16 != 0
                for out in dtypes:
                    compare(x, 8, True, out, ("misaligned", length, k, dt,
                                              out))
                    odd += 1
    log(f"[kernel] fake_quant: {n} comparisons bit for bit (tolerance 0) "
        f"over every (in, out) pair of f32 and bf16, {odd} of them on "
        f"misaligned views at odd lengths; {ties} exact half-levels among "
        "the inputs")
    return 0.0


def ssd_f64(torch, a, b, c, x):
    """The intra-chunk function evaluated in float64 (the plain version's
    formula with every operand widened to f64)."""
    l = a.shape[-1]
    cum = a.double().cumsum(-1)
    causal = torch.ones((l, l), dtype=torch.bool, device=a.device).tril()
    diff = (cum[..., :, None] - cum[..., None, :]).masked_fill(
        ~causal, float("-inf"))
    s = torch.einsum("cin,cjn->cij", c.double(), b.double())
    return torch.einsum("chij,cjhp->cihp", torch.exp(diff) * s[:, None],
                        x.double())


def check_ssd_intra(torch, SI, cfg):
    """Phase 2: ssd_intra_chunk against its plain version at the serving
    shape (C = batch x chunks, H, l, N, P of mamba2-780m), the ragged one
    (l, N, P off the tile grid: the masked load path), l < 16, H = 1 and l
    past one pass over the kernel's 256 S columns, with two decay draws:
    test_kernels.py's (-|N(0,1)| x 0.1) and the serving path's
    (-softplus(N(0,1)), a = dt * A with A = -1). Every call repeated bit
    for bit; bf16 in, f32 out also against the function in f64 (within
    SSD_F64_TOL of max |f64|, or no farther than the f32 plain version).
    The per-path launch counts show which shapes took which load path."""
    gen = torch.Generator(device=DEV).manual_seed(4)
    serve_shape = (MAMBA_BATCH * MAMBA_PROMPT // cfg.ssm_chunk,
                   cfg.n_ssm_heads, cfg.ssm_chunk, cfg.ssm_state,
                   cfg.d_inner // cfg.n_ssm_heads)
    err, exact = {}, {}
    f32, bf16 = torch.float32, torch.bfloat16
    SI.reset_launches()
    for C, H, l, N, P in (serve_shape,) + SSD_SHAPES:
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
                what = f"ssd_intra {(C, H, l, N, P)} {draw} {dt} -> {out}"
                got = SI.ssd_intra_chunk(*args, out_dtype=out)
                again = SI.ssd_intra_chunk(*args, out_dtype=out)
                torch.cuda.synchronize()
                assert torch.equal(got, again), f"{what}: repeat"
                want = SI.ssd_intra_chunk_plain(*args, out_dtype=out)
                torch.testing.assert_close(
                    got, want, rtol=tol, atol=tol,
                    msg=lambda m: f"{what}: {m}")
                key = f"{str(dt)[6:]}->{str(out)[6:]}"
                err[key] = max(err.get(key, 0.0),
                               float((got.float() - want.float()).abs().max()))
                if (dt, out) == (bf16, f32):
                    ref = ssd_f64(torch, *args)
                    scale = float(ref.abs().max())
                    d_k = float((got.double() - ref).abs().max()) / scale
                    d_p = float((want.double() - ref).abs().max()) / scale
                    assert d_k <= max(SSD_F64_TOL, d_p), (what, d_k, d_p)
                    exact[(C, H, l, N, P), draw] = (d_k, d_p)
                    del ref
            del args, got, again, want
    log(f"[kernel] ssd_intra_chunk at {serve_shape} (C, H, l, N, P) and "
        f"{list(SSD_SHAPES)}: within tolerance (f32 1e-4, bf16 in 2e-2), "
        "each call repeated bit for bit; max |kernel - plain|: " + ", ".join(
            f"{k} {v:.3e}" for k, v in sorted(err.items()))
        + f"; bf16 in, f32 out against f64 (bar {SSD_F64_TOL} of max |f64|"
        ", or the plain f32 version's distance), max |result - f64| / max "
        "|f64| kernel / plain f32: " + ", ".join(
            f"{shape} {draw} {k:.3e} / {p:.3e}"
            for (shape, draw), (k, p) in exact.items())
        + f"; launches by path {dict(SI.LAUNCHES_BY_PATH)}; plan at the "
        f"serving shape {SI.plan(*serve_shape[:3], bf16, True)}")
    assert SI.LAUNCHES_BY_PATH["bf16 masked"] > 0, SI.LAUNCHES_BY_PATH
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
    |kernel - plain| within QM_TOL of max |plain|, and a second call equal
    bit for bit (split-K sums its slices in a fixed order); in the
    QM_POISONED cases x is a slice of a NaN-poisoned buffer (a read past
    the ragged row or column edge would put NaN into y). The per-path
    counts show QM_ALIGNED's shapes on the 16-byte path and the poisoned
    slices on the masked one."""
    gen = torch.Generator(device=DEV).manual_seed(7)
    worst_abs = worst_rel = 0.0
    n = 0
    for m, k, nn, dt in QM_SHAPES:
        for poison in (False, True) if (m, k, nn) in QM_POISONED else (False,):
            x, w, scale = qm_inputs(torch, m, k, nn, dt, gen, poison)
            before = dict(QM.LAUNCHES_BY_PATH)
            got = QM.quant_matmul(x, w, scale)
            path = [p for p, c in QM.LAUNCHES_BY_PATH.items()
                    if c != before[p]]
            if poison:
                assert path == ["masked"], (m, k, nn, dt, path)
            elif (m, k, nn) in QM_ALIGNED:
                assert path == ["aligned"], (m, k, nn, dt, path)
            again = QM.quant_matmul(x, w, scale)
            torch.cuda.synchronize()
            assert torch.equal(got, again), (m, k, nn, dt, poison)
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
        f"buffer, on the masked path), each repeated bit for bit; max "
        f"|kernel - plain| {worst_abs:.3e}, at most {worst_rel:.3e} of max "
        f"|plain|")
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
        want = compressed_launches(cfg, engine, forwards, paged_passes(rep))
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
            f"fake_quant; by path {dict(K.LAUNCHES_BY_PATH)})")
    scan, loop = reports["scan"], reports["loop"]
    assert scan.prefix["hits"] >= 1
    for rid, toks in scan.outputs.items():
        assert len(toks) == 16 and ((0 <= toks) & (toks < cfg.vocab)).all()
        assert (toks == loop.outputs[rid]).all(), f"{rid}: scan != loop"
    log(f"[serve] scan and loop tokens equal on all {scan.n_requests} "
        "requests")
    return counts, scan


def verify_exact(torch, kern, cfg, sxp):
    """One verify pass of SPEC_K + 1 tokens over N_SLOTS rows against
    SPEC_K + 1 one-token decode steps over a shorter view, on the card:
    logits and K/V equal bit for bit (the property the accept rule stands
    on: the decode-attention kernel takes each query row's sums in one
    order, the norm reduces each row alone, and the block-sparse sums of
    eq. 5 data are exact in any order). For contrast, printed and not
    held: the same comparison with the library attention
    (``layers.attention_scores`` over the masked, head-expanded view, as
    the port computed it before the kernel), and a decode step's host-clock
    time with each, taken in turns."""
    from repro_torch.models import layers as L
    from repro_torch.serve import stacked as ST
    DA = kern[4]
    gen = torch.Generator(device=DEV).manual_seed(11)
    t = SPEC_K + 1
    shape = (cfg.n_layers, N_SLOTS, 160, cfg.n_kv_heads, cfg.dh)
    vk = torch.randn(shape, generator=gen, device=DEV).to(cfg.param_dtype)
    vv = torch.randn(shape, generator=gen, device=DEV).to(cfg.param_dtype)
    pos = torch.tensor([3, 40, 77, 120], dtype=torch.int32, device=DEV)
    toks = torch.randint(0, cfg.vocab, (N_SLOTS, t), generator=gen,
                         device=DEV, dtype=torch.int32)
    rows = torch.arange(N_SLOTS, device=DEV)

    def compare():
        logits, ks, vs = ST.verify_step(sxp, vk, vv, pos, toks, cfg)
        k_seq, v_seq = vk[:, :, :128].clone(), vv[:, :, :128].clone()
        equal, diff = True, 0.0
        for i in range(t):
            lg, kn, vn = ST.decode_step_paged(sxp, k_seq, v_seq, pos + i,
                                              toks[:, i:i + 1], cfg)
            equal &= bool(torch.equal(lg, logits[:, i])
                          and torch.equal(kn, ks[:, :, i])
                          and torch.equal(vn, vs[:, :, i]))
            diff = max(diff, float((lg.float() - logits[:, i].float())
                                   .abs().max()))
            k_seq[:, rows, (pos + i).long()] = kn.to(k_seq.dtype)
            v_seq[:, rows, (pos + i).long()] = vn.to(v_seq.dtype)
        return equal, diff

    def step_secs(n):
        secs = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ST.decode_step_paged(sxp, vk, vv, pos, toks[:, :1], cfg)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        return secs

    def library_attention(q, k, v, p, window=0, n_true=0, k_new=None,
                          v_new=None):
        pp = p.long()[:, None] + torch.arange(q.shape[1], device=DEV)[None]
        if k_new is not None:  # the step's K/V spliced into copies
            at = (torch.arange(q.shape[0], device=DEV)[:, None], pp)
            k, v = k.index_put(at, k_new), v.index_put(at, v_new)
        kj = torch.arange(k.shape[1], device=DEV)[None, None, None, :]
        mask = kj <= pp[:, None, :, None]
        if window > 0:
            mask = mask & (kj > pp[:, None, :, None] - window)
        h = q.shape[2]
        return L.attention_scores(q, L._expand_kv(k, h, n_true or h),
                                  L._expand_kv(v, h, n_true or h), mask)

    kernel = DA.decode_attention

    def use(name):
        DA.decode_attention = kernel if name == "kernel" else \
            library_attention

    try:
        equal, _ = compare()
        assert equal, "verify pass != one-token steps"
        use("library")
        lib_equal, lib_diff = compare()
        # decode-step host time in turns (kernel, library, library,
        # kernel), 20 steps a turn after 5 untimed ones
        times = {"kernel": [], "library": []}
        for name in ("kernel", "library", "library", "kernel"):
            use(name)
            step_secs(5)
            times[name] += step_secs(20)
    finally:
        use("kernel")
    step_ms = statistics.median(times["kernel"]) * 1e3
    lib_ms = statistics.median(times["library"]) * 1e3
    log(f"[spec] verify pass of {t} tokens x {N_SLOTS} rows ({VERIFY_ROWS} "
        f"rows a projection) over a 160-position view equals {t} one-token "
        f"steps over a 128-position view, logits and K/V bit for bit; "
        f"decode step {step_ms:.3f} ms (host clock, median of 40 taken in "
        f"turns). With the library attention: equal {lib_equal}, max "
        f"|logit diff| {lib_diff:.4g}, decode step {lib_ms:.3f} ms")


def serve_spec(torch, kern, cfg, sp, scan, card):
    """Phase 3, speculative part: a draft tier re-pruned to
    SPEC_DRAFT_SPARSITY, the verify exactness check, then the trace through
    the spec engine (reprune and layerskip drafts) and through an
    instrumented scan engine. Each run is driven with the launch counts at
    0 and read after; tokens must equal the plain scan run's bit for bit."""
    import shutil
    import tempfile
    from repro_torch.obs import (MetricsRegistry, Tracer,
                                 validate_chrome_trace_file,
                                 validate_metrics_snapshot)
    from repro_torch.serve import BatchConfig, BatchServer, Request
    from repro_torch.serve import ServeConfig
    from repro_torch.serve import spec as SPM
    from repro_torch.serve import stacked as ST
    t0 = time.perf_counter()
    draft = SPM.draft_serving(cfg, sp, SPEC_DRAFT_SPARSITY)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    dens = [dw.density for dw in draft.deployed().values()]
    log(f"[spec] draft tier re-pruned to sparsity {SPEC_DRAFT_SPARSITY} in "
        f"{pack_s:.1f} s (host); compression_x "
        f"{draft.report()['compression_x']:.3f} (target "
        f"{sp.report()['compression_x']:.3f}); block density per projection "
        f"{min(dens):.4f}-{max(dens):.4f}")
    verify_exact(torch, kern, cfg, ST.stack(sp))
    bcfg = BatchConfig(n_slots=N_SLOTS, block_size=16, n_blocks=96)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    # the agreeing drafts: a budget of AGREE_NEW tokens (1 + 5 + 5 + 3 at
    # k = 4: the last round is cut by the budget), and an EOS id for the
    # layer-skip run, the plain scan run's token at position 6 of r0 (a
    # run is cut at EOS where one is emitted)
    agree_new = 14
    eos = int(scan.outputs["r0"][6])
    spec = lambda **kw: SPM.SpecConfig(k=SPEC_K, **kw)
    cases = {
        "reprune": dict(engine="spec", draft=draft, spec=spec(
            draft_sparsity=SPEC_DRAFT_SPARSITY)),
        "layerskip": dict(engine="spec", spec=spec(draft="layerskip",
                                                   keep=SPEC_KEEP)),
        "scan traced": dict(engine="scan", tracer=Tracer(),
                            metrics=MetricsRegistry()),
        "reprune agree": dict(engine="spec", draft=sp, spec=spec(
            draft_sparsity=SPARSITY)),
        "layerskip agree": dict(engine="spec", scfg=ServeConfig(eos_id=eos),
                                spec=spec(draft="layerskip", keep=1.0))}
    counts, runs = {}, {}
    try:
        for label, kw in cases.items():
            agree = label.endswith("agree")
            srv = BatchServer(cfg, sp, bcfg=bcfg, device=DEV, **kw)
            srv.run(make_trace(Request, cfg.vocab, seed=9)[:1])  # warm-up
            if label == "scan traced":
                srv.tracer.clear()
                srv.metrics.clear()
                srv.timer.clear()
            trace = make_trace(Request, cfg.vocab)
            if agree:
                for r in trace:
                    r.max_new_tokens = agree_new
            torch.cuda.synchronize()
            reset_launches(kern)
            t0 = time.perf_counter()
            rep = srv.run(trace)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts[f"spec {label}"] = got = launch_counts(kern)
            runs[label] = rep
            for rid, toks in scan.outputs.items():
                if agree:  # the plain scan run's tokens, cut where this
                    toks = toks[:agree_new]  # run's budget or EOS cuts
                    if srv.scfg.eos_id in toks:
                        toks = toks[: list(toks).index(srv.scfg.eos_id) + 1]
                assert (rep.outputs[rid] == toks).all(), \
                    f"{label} {rid}: tokens != the plain scan run's"
            if agree:
                # the draft is the target bit for bit: every proposal
                # agrees, so a slot-round accepts its whole run unless the
                # budget or EOS cuts it; from each request's own output
                proposed = accepted = 0
                for toks in rep.outputs.values():
                    done = 1  # the prefill's token
                    while done < len(toks):
                        e = min(SPEC_K + 1, len(toks) - done)
                        proposed += SPEC_K
                        accepted += min(SPEC_K, e - 1)
                        done += e
                j = rep.spec
                assert (j["proposed"], j["accepted"]) == (proposed,
                                                          accepted), j
                assert set(j["round_k"]) == {SPEC_K}, j["round_k"]
            if label == "scan traced":
                forwards = rep.n_requests + rep.n_decode_steps
                want = compressed_launches(cfg, "scan", forwards,
                                           paged_passes(rep))
                path = os.path.join(tmp, "trace.json")
                srv.tracer.save(path)
                n_ev = validate_chrome_trace_file(path)
                snap = json.loads(json.dumps(rep.metrics))
                n_inst = validate_metrics_snapshot(snap)
                names = {e["name"] for e in srv.tracer.events}
                phases = {"prefill", "step.admit", "decode_step",
                          "step.gather", "step.dispatch", "step.writeback",
                          "step.sample"}
                assert phases <= names, phases - names
                disp = snap["kernel_dispatch"][0]
                assert disp["backend"] == torch.device(DEV).type, disp
                log(f"[spec] scan with Tracer + MetricsRegistry: tokens "
                    f"equal the plain scan run's on all {rep.n_requests} "
                    f"requests; tokens_per_s {rep.tokens_per_s:.2f} "
                    f"(plain {scan.tokens_per_s:.2f}); Chrome trace "
                    f"{n_ev} events valid, metrics snapshot {n_inst} "
                    f"instruments valid; decode dispatch p50 "
                    f"{disp['p50_ms']} ms over {disp['calls']} steps; "
                    f"prefix_hits {snap['counters'].get('prefix_hits')}; "
                    f"launches {got} ({card})")
            else:
                masks = srv.spec_masks
                want = spec_launches(cfg, rep, masks)
                j = rep.spec
                log(f"[spec] engine=spec draft={label} k={SPEC_K}"
                    + (f" masks attn={list(masks[0])} mlp={list(masks[1])}"
                       if masks else
                       f" draft_sparsity={j['draft_sparsity']}")
                    + (f" budget {agree_new} eos_id {srv.scfg.eos_id}: "
                       f"every proposal accepted but where the budget or "
                       f"EOS cuts ({j['accepted']} of {j['proposed']})"
                       if agree else "")
                    + f": tokens equal the plain scan run's on all "
                    f"{rep.n_requests} requests; acceptance_rate "
                    f"{j['acceptance_rate']} tokens_per_verify "
                    f"{j['tokens_per_verify']} rounds {j['n_rounds']} "
                    f"round_p50_ms {j['round_p50_ms']} draft_p50_ms "
                    f"{j.get('draft_p50_ms')} verify_p50_ms "
                    f"{j.get('verify_p50_ms')} tokens_per_s "
                    f"{rep.tokens_per_s:.2f} (scan {scan.tokens_per_s:.2f})"
                    f" wall_s {secs:.3f}; round k {j['round_k']}; launches "
                    f"{got} ({card})")
            assert got == want, (label, got, want)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return counts, draft


def plain_path_agreement(torch, kern, cfg, sp, sxp):
    """One prefill and one decode step through the kernels (loop and scan
    runtimes) against the same forward with every kernel swapped for its
    plain version, on the card. fake_quant is bit-exact, and the
    projections' f32 sums are exact here (eq. 5 activations and int8 levels
    are multiples of 2^-7, their products of 2^-14, and no partial sum
    nears 2^10), so the order of summation cannot show, every other op is
    the same torch op (the decode step's attention on its kernel on both
    sides), and the logits must agree. Then the decode-attention kernel
    swapped too, printed and not held: its bf16 scores and probabilities
    round differently from its plain version's where their f32 sums,
    taken in other orders, straddle a rounding edge (phase 2 holds the
    kernel to DA_TOL), and four bf16 layers carry that into the logits;
    greedy tokens by the margin rule. Then the same packing on the CPU
    (``card_vs_cpu``)."""
    from repro_torch.serve import parity as PA
    toks = torch.randint(0, cfg.vocab, (1, 32), device=DEV,
                         generator=torch.Generator(device=DEV).manual_seed(3))
    loop, scan = (PA.prefill_and_step(p, toks, 29, cfg) for p in (sp, sxp))
    with plain_kernels(kern):
        plain = PA.prefill_and_step(sp, toks, 29, cfg)
    with plain_kernels(kern, attention=True):
        plain_all = PA.prefill_and_step(sp, toks, 29, cfg)
    assert loop.shape == (2, cfg.vocab) and torch.isfinite(loop).all()
    assert torch.equal(loop, scan)
    diff = float((loop - plain).abs().max())
    diff_all = (loop.float() - plain_all.float()).abs().max(-1).values
    rule = PA.greedy_margins(loop, plain_all, MARGIN_TOL)
    log(f"[serve] prefill + decode logits, kernel path vs plain path on the "
        f"card: max |diff| {diff:.3e} (max |logit| "
        f"{float(plain.abs().max()):.3e}); loop == scan. With the "
        f"decode-attention kernel swapped too: max |diff| prefill "
        f"{float(diff_all[0]):.4e}, decode {float(diff_all[1]):.4e}; greedy "
        f"tokens {rule['equal']}/{rule['rows']} equal, divergences (row, "
        f"margin) {rule['differ']}")
    assert diff <= 1e-3, diff
    card_vs_cpu(torch, cfg, sp, toks, loop)


def card_vs_cpu(torch, cfg, sp, toks, card_logits):
    """The same packing served on the card and on the CPU: saved with
    ``save_artifact``, booted with ``load_artifact(device="cpu")`` (the
    same integers, no second random stream), and the same prefill and
    decode step run on the CPU port, whose wrappers take the plain
    versions (the decode step's input is the card's greedy token on both
    sides). Prints the max |logit difference| in f32, the greedy tokens
    under the margin rule (a divergence is a fault where the card's top-2
    margin exceeds MARGIN_TOL), and, to attribute the gap, the eq. 5 levels
    that differ per projection (every compressed projection's activations
    recorded on both sides) with the first projection where one does."""
    import shutil
    import tempfile
    from repro_torch.serve import deployed as DP
    from repro_torch.serve import parity as PA
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cpu_")
    t0 = time.perf_counter()
    try:
        DP.save_artifact(os.path.join(tmp, "yi-6b"), sp, cfg)
        cpu_sp, _ = DP.load_artifact(os.path.join(tmp, "yi-6b"),
                                     device="cpu")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec_card, rec_cpu = [], []
    with PA.record_eq5(sp, rec_card):
        card = PA.prefill_and_step(sp, toks, 29, cfg)
    torch.cuda.synchronize()
    assert torch.equal(card, card_logits)  # recording changes nothing
    nxt = card[:1].argmax(-1, keepdim=True).to(torch.int32)
    with PA.record_eq5(cpu_sp, rec_cpu):
        cpu = PA.prefill_and_step(cpu_sp, toks.cpu(), 29, cfg, nxt.cpu())
    secs = time.perf_counter() - t0
    assert cpu.shape == card.shape and torch.isfinite(cpu).all()
    d = (card.float().cpu() - cpu.float()).abs().max(-1).values
    flips = PA.level_flips(rec_card, rec_cpu)
    rule = PA.greedy_margins(card, cpu, MARGIN_TOL)
    flipped = {k: (e["off_by_one"], e["more"], e["levels"])
               for k, e in flips["per_projection"].items()
               if e["off_by_one"] or e["more"]}
    log(f"[serve] card vs CPU on the same packing (saved, booted on the CPU "
        f"in {secs:.1f} s with the forward): max |logit diff| f32 prefill "
        f"{float(d[0]):.4e}, decode {float(d[1]):.4e} (max |logit| "
        f"{float(cpu.float().abs().max()):.4e}); greedy tokens "
        f"{rule['equal']}/{rule['rows']} equal, divergences (row, card "
        f"top-2 margin) {rule['differ']}, faults above {MARGIN_TOL}: "
        f"{rule['faults']}; eq. 5 levels one apart {flips['off_by_one']}, "
        f"further apart {flips['more']}, of "
        f"{sum(e['levels'] for e in flips['per_projection'].values())}; "
        f"first flip at {flips['first']} (block {flips['first_layer']}); "
        f"per projection (one apart, further, levels): {flipped}")


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
    by_path = dict(QM.LAUNCHES_BY_PATH)
    assert by_path == {"aligned": want["quant_matmul"], "masked": 0}, by_path
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
        f"launches {counts}, by load path {by_path}")
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
        rec["masks"] = self.spec_masks
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
            want = compressed_launches(cfg, runtime, forwards, sum(
                paged_passes(r) for r in rec["reports"]))
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
        from repro_torch.obs import (validate_chrome_trace_file,
                                     validate_metrics_snapshot)
        trace_out = os.path.join(tmp, "trace.json")
        metrics_out = os.path.join(tmp, "metrics.json")
        rep = drive("yi-6b batch spec layerskip",
                    yi + CLI_BATCH + CLI_SPEC + ["--trace-out", trace_out,
                                                 "--metrics-out",
                                                 metrics_out])
        rec.pop("booted")
        got = counts["cli yi-6b batch spec layerskip"]
        want = {}
        for r in rec["reports"]:  # warm-up and measured runs
            for key, n in spec_launches(cfg, r, rec["masks"]).items():
                want[key] = want.get(key, 0) + n
        assert got == want, (got, want)
        assert rec["deploy_weight"] == 0
        for rid, toks in batch["scan"].outputs.items():
            assert (rep.outputs[rid] == toks).all(), \
                f"{rid}: --spec tokens != the booted scan run's"
        n_ev = validate_chrome_trace_file(trace_out)
        with open(metrics_out) as f:
            n_inst = validate_metrics_snapshot(json.load(f))
        j = rep.spec
        log(f"[cli] yi-6b batch spec layerskip: boot_s "
            f"{rec['secs']['boot']:.2f} deploy_weight 0; tokens equal the "
            f"booted scan run's on all {rep.n_requests} requests; masks "
            f"attn={list(rec['masks'][0])} mlp={list(rec['masks'][1])}; "
            f"acceptance_rate {j['acceptance_rate']} tokens_per_verify "
            f"{j['tokens_per_verify']} rounds {j['n_rounds']} round_p50_ms "
            f"{j['round_p50_ms']} tokens_per_s {rep.tokens_per_s:.2f} "
            f"(scan {batch['scan'].tokens_per_s:.2f}); --trace-out "
            f"{n_ev} events and --metrics-out {n_inst} instruments valid; "
            f"launches {got} ({card})")
        legacy = {}
        for runtime in ("scan", "loop"):
            out = drive(f"yi-6b legacy {runtime}",
                        yi + CLI_LEGACY + ["--runtime", runtime])
            new = int(CLI_LEGACY[CLI_LEGACY.index("--new-tokens") + 1])
            # one prefill and ``new`` decode steps over the contiguous cache
            want = compressed_launches(cfg, runtime, new + 1, new)
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


def full_search() -> None:
    """The sched phase's full-depth search, in a process of its own that
    ``start_full_search`` starts before the build, so that its minutes of
    host numpy overlap phases 1-6: ``default_schedule`` over full yi-6b
    (32 layers, the CLI's defaults), printed as one JSON line."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.models import registry
    from repro_torch.serve import deployed as DP
    cfg = registry.get_config("yi-6b", dtype="bfloat16")
    t0, c0 = time.perf_counter(), time.process_time()
    sched = DP.default_schedule(cfg)
    print(json.dumps({
        "seconds": time.perf_counter() - t0,
        "cpu_seconds": time.process_time() - c0,
        "n_layers": cfg.n_layers, "n_nodes": len(sched.layers),
        "fps": sched.fps, "cycles": sched.cycles,
        "tiles": {s.name: list(s.tile) for s in sched.layers}}), flush=True)


def start_full_search():
    """``full_search`` in a child process (one thread: it is pure Python)."""
    return subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.full_search()"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1"))


class Tee:
    """stdout that also keeps what was written (the CLI's report lines)."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def text(self) -> str:
        return "".join(self.parts)


def sched(torch, kern, card, search):
    """Phase 9 (runs after phase 6; phase 8 times its tiles): the MARS
    schedule search and the CLI paths it drives, yi-6b at full width.
    The full-depth ``default_schedule`` comes from ``search`` (started
    before the build); the CLI runs, ``repro_torch.launch.serve.main``
    in-process, cut to SCHED_LAYERS layers by wrapping
    ``registry.get_config`` (their searches simulate 7 x SCHED_LAYERS
    nodes, not 224): ``--autotune`` on a fresh pack (the table, the winner
    never slower than the simulated pick, the timing launches counted),
    the same artifact booted (a cache hit, no ``autotune.*`` timer record,
    the fresh run's tokens), ``--compressed`` with no ``--tile`` on the
    loop runtime (every single-layer launch at its projection's schedule
    tile), then ``executor.verify_layer`` and ``obs.gap.kernel_gap`` on
    the card and ``--spec auto`` over the booted artifact (the scan run's
    tokens, whether it serves spec or declines). Returns the launch counts
    of the CLI runs and the tiles phase 8 times."""
    import shutil
    import tempfile
    from repro_torch.core import deploy as D
    from repro_torch.kernels import timing as TIM
    from repro_torch.launch import serve as CLI
    from repro_torch.models import registry
    from repro_torch.obs import gap as GAP
    from repro_torch.sched import autotune as AT
    from repro_torch.sched import executor as EX
    from repro_torch.serve import deployed as DP
    from repro_torch.serve.server import BatchServer
    K = kern[0]
    out, err = search.communicate(timeout=SEARCH_TIMEOUT)
    assert search.returncode == 0, err[-4000:]
    full = json.loads(out.strip().splitlines()[-1])
    full_tiles = sorted({tuple(t) for t in full["tiles"].values()})
    assert full["n_nodes"] == 7 * full["n_layers"] == 224, full["n_nodes"]
    assert len(full_tiles) == 1, full_tiles
    full_tile = full_tiles[0]
    log(f"[sched] default_schedule over full-depth yi-6b ({full['n_layers']}"
        f" layers, {full['n_nodes']} projections, seq_len 128, groups and "
        f"alphas 16-64): {full['seconds']:.2f} s on the host clock "
        f"({full['cpu_seconds']:.2f} s of CPU) in a process of its own "
        f"beside phases 1-6; tile {full_tile[0]}x{full_tile[1]} for every "
        f"projection; simulated {full['fps']:.4f} fps ({card})")

    rec = {"reports": [], "autotune": [], "measure_tile": 0, "timed": [],
           "tiles": {}, "deploy_weight": 0}
    orig = {"run": (BatchServer, BatchServer.run),
            "autotune": (AT, AT.autotune),
            "measure_tile": (AT, AT.measure_tile),
            "timed": (TIM.DispatchTimer, TIM.DispatchTimer.timed),
            "bsr_matmul": (K, K.bsr_matmul),
            "compress": (DP, DP.compress),
            "default_schedule": (DP, DP.default_schedule),
            "deploy_weight": (D, D.deploy_weight),
            "get_config": (registry, registry.get_config)}

    def keep(name, count=False):
        fn = orig[name][1]

        def wrapped(*a, **k):
            res = fn(*a, **k)
            if count:
                rec[name] += 1
            else:
                rec.setdefault(f"last_{name}", []).append(res)
            return res
        return wrapped

    def run(self, requests):
        rep = orig["run"][1](self, requests)
        rec["reports"].append(rep)
        rec["masks"] = self.spec_masks
        return rep

    def timed(self, name, *a, **k):
        rec["timed"].append(name)
        return orig["timed"][1](self, name, *a, **k)

    def bsr_matmul(x, blocks, *a):
        tile = tuple(int(d) for d in blocks.shape[-2:])
        rec["tiles"][tile] = rec["tiles"].get(tile, 0) + 1
        return orig["bsr_matmul"][1](x, blocks, *a)

    BatchServer.run = run
    AT.autotune = keep("autotune")
    AT.measure_tile = keep("measure_tile", count=True)
    TIM.DispatchTimer.timed = timed
    K.bsr_matmul = bsr_matmul
    DP.compress = keep("compress")
    DP.default_schedule = keep("default_schedule")
    D.deploy_weight = keep("deploy_weight", count=True)
    registry.get_config = lambda arch, **k: orig["get_config"][1](
        arch, **{"n_layers": SCHED_LAYERS, **k})
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sched_")
    art = os.path.join(tmp, "yi-6b-tuned")
    counts = {}

    def drive(label, argv):
        for key in ("reports", "timed", "autotune"):
            rec[key] = []
        rec.update(measure_tile=0, deploy_weight=0, tiles={})
        for key in [k for k in rec if k.startswith("last_")]:
            del rec[key]
        torch.cuda.synchronize()
        reset_launches(kern)
        log(f"[sched] {label}: main({' '.join(argv)})")
        tee = Tee(sys.stdout)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            rep = CLI.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts[f"sched {label}"] = launch_counts(kern)
        return rep, tee.text(), secs

    def forwards_paged():
        return (sum(r.n_requests + r.n_decode_steps for r in rec["reports"]),
                sum(paged_passes(r) for r in rec["reports"]))

    try:
        cfg = registry.get_config("yi-6b", dtype="bfloat16")
        assert cfg.n_layers == SCHED_LAYERS
        shapes = AT.projection_shapes(cfg)
        tuned = CLI_SCHED + ["--autotune", str(SCHED_TOPN), "--artifact", art,
                             "--runtime", "scan"]
        fresh, text, secs = drive("autotune pack", tuned)
        res = rec["last_autotune"][-1]
        assert not res.cache_hit and res.backend == AT.backend_name(DEV), res
        assert len(res.table) == SCHED_TOPN == rec["measure_tile"]
        by_tile = {tuple(r["tile"]): r for r in res.table}
        assert res.simulated_tile in by_tile
        assert (by_tile[res.best_tile]["total_s"]
                <= by_tile[res.simulated_tile]["total_s"]), res.table
        n_timed = SCHED_TOPN * len(shapes) * 2  # phases per tile and shape
        assert sum(n.startswith("autotune.") for n in rec["timed"]) == \
            2 * n_timed  # measure_tile's default repeats
        for r in res.table:
            log(f"[sched] autotune tile {r['tile'][0]}x{r['tile'][1]}: "
                f"prefill_ms {r['prefill_s'] * 1e3:.4f} decode_ms "
                f"{r['decode_s'] * 1e3:.4f} total_ms "
                f"{r['total_s'] * 1e3:.4f} sim_fps {r['sim_fps']} "
                f"(host clock, fenced, best of 2, count-weighted over "
                f"{[(i, o, n) for i, o, n in shapes]}; {card})")
        forwards, paged = forwards_paged()
        want = compressed_launches(cfg, "scan", forwards, paged)
        # measure_tile: per tile, shape and phase one warm call and two
        # timed ones, on the stacked entry
        want["bsr_matmul_stacked"] += 3 * n_timed
        got = counts["sched autotune pack"]
        assert got == want, (got, want)
        packed = rec["last_compress"][-1]
        assert DP.packed_tiles(packed) == [D.uniform_fit_tile(
            DP._projection_shapes(packed), *res.best_tile)]
        log(f"[sched] autotune pack: winner {res.best_tile[0]}x"
            f"{res.best_tile[1]} (simulated pick {res.simulated_tile[0]}x"
            f"{res.simulated_tile[1]}), the winner's total "
            f"{by_tile[res.best_tile]['total_s'] * 1e3:.4f} ms <= the "
            f"simulated pick's {by_tile[res.simulated_tile]['total_s'] * 1e3:.4f}"
            f"; packed uniform {DP.packed_tiles(packed)}; {secs:.2f} s in all "
            f"(search, timing, pack, save, two serves); tokens_per_s "
            f"{fresh.tokens_per_s:.2f}; launches {got} ({n_timed * 3} of "
            "them measure_tile's)")
        del packed

        booted, text, secs = drive("autotune boot", tuned)
        assert "no re-packing" in text and "autotune: cache hit" in text
        assert rec["measure_tile"] == 0 and rec["deploy_weight"] == 0
        assert not any(n.startswith("autotune.") for n in rec["timed"])
        forwards, paged = forwards_paged()
        got = counts["sched autotune boot"]
        assert got == compressed_launches(cfg, "scan", forwards, paged), got
        for rid, toks in fresh.outputs.items():
            assert (booted.outputs[rid] == toks).all(), rid
        log(f"[sched] autotune boot: cache hit, no autotune.* timer record, "
            f"no packing; tokens equal the fresh run's on all "
            f"{booted.n_requests} requests; {secs:.2f} s; launches {got}")

        loop, text, secs = drive("no tile", CLI_SCHED + ["--runtime", "loop"])
        schedule = rec["last_default_schedule"][-1]
        tiles = {s.name: s.tile for s in schedule.layers}
        packed = rec["last_compress"][-1]
        head_fallback = (cfg.cim_alpha, cfg.cim_alpha)
        want_tiles = {}
        for name, dw in packed.deployed().items():
            tile = D.fit_tile(dw.d_in, dw.d_out,
                              *tiles.get(name, head_fallback))
            assert dw.tile == tile, (name, dw.tile, tile)
            want_tiles[tile] = want_tiles.get(tile, 0) + 1
        forwards, paged = forwards_paged()
        got = counts["sched no tile"]
        assert got == compressed_launches(cfg, "loop", forwards, paged), got
        want_tiles = {t: n * forwards for t, n in want_tiles.items()}
        assert rec["tiles"] == want_tiles, (rec["tiles"], want_tiles)
        for rid, toks in loop.outputs.items():
            assert ((0 <= toks) & (toks < cfg.vocab)).all(), rid
        log(f"[sched] no tile: default_schedule over {len(tiles)} "
            f"projections picked {sorted(set(tiles.values()))} (the head, "
            f"not in lm_graph, {head_fallback}); every single-layer launch "
            f"at its projection's tile: {rec['tiles']} over {forwards} "
            f"forwards; {secs:.2f} s; tokens_per_s {loop.tokens_per_s:.2f}; "
            f"launches {got}")
        del packed

        gen = torch.Generator(device=DEV).manual_seed(3)
        errs = []
        for proj, d_in, d_out in (("wq", cfg.d_model, cfg.n_heads * cfg.dh),
                                  ("wk", cfg.d_model, cfg.n_kv_heads * cfg.dh),
                                  ("w_gate", cfg.d_model, cfg.d_ff),
                                  ("w_down", cfg.d_ff, cfg.d_model)):
            s = next(s for s in schedule.layers if s.name == f"blk0_{proj}")
            w = torch.randn((d_in, d_out), generator=gen, device=DEV) * 0.02
            x = torch.randn((MARS_ROWS[1], d_in), generator=gen, device=DEV)
            ref = D.reference_matmul(x, w, cfg.cim, SPARSITY,
                                     *D.fit_tile(d_in, d_out, *s.tile))
            tol = VERIFY_TOL * float(ref.abs().max())
            n0 = K.LAUNCHES_BY_ENTRY["bsr_matmul"]
            e = EX.verify_layer(x, w, s, cfg.cim, SPARSITY, atol=tol)
            assert K.LAUNCHES_BY_ENTRY["bsr_matmul"] == n0 + 1
            errs.append(f"{proj} ({d_in}x{d_out}, tile {s.tile}) {e:.3e} "
                        f"<= {tol:.3e}")
            del w, ref
        log(f"[sched] executor.verify_layer on the card, {MARS_ROWS[1]} "
            f"rows, kernel vs the dense oracle within {VERIFY_TOL} x "
            f"max |ref|: " + "; ".join(errs))
        n0 = K.LAUNCHES_BY_ENTRY["bsr_matmul"]
        gap = GAP.kernel_gap(N_SLOTS, cfg.d_model, cfg.d_ff, full_tile,
                             SPARSITY, device=DEV)
        assert K.LAUNCHES_BY_ENTRY["bsr_matmul"] == n0 + 4  # warm + 3
        assert gap["backend"] == torch.device(DEV).type and gap["measured_s"] > 0
        log(f"[sched] obs.gap.kernel_gap: {json.dumps(gap)} ({card})")

        spec, text, secs = drive("spec auto", CLI_SCHED + [
            "--artifact", art, "--runtime", "scan", "--spec", "auto"])
        line = next(ln for ln in text.splitlines()
                    if ln.startswith("spec auto: {"))
        decision = json.loads(line[len("spec auto: "):])
        got = counts["sched spec auto"]
        if spec.spec is None:
            assert decision["verdict"] == "declined", decision
            forwards, paged = forwards_paged()
            want = compressed_launches(cfg, "scan", forwards, paged)
        else:
            assert decision["verdict"] == "spec", decision
            want = {}
            for r in rec["reports"]:  # warm-up and measured runs
                for key, n in spec_launches(cfg, r, rec["masks"]).items():
                    want[key] = want.get(key, 0) + n
        assert got == want, (got, want)
        for rid, toks in fresh.outputs.items():
            assert (spec.outputs[rid] == toks).all(), \
                f"{rid}: --spec auto tokens != the scan run's"
        j = spec.spec or {}
        log(f"[sched] spec auto: decision {json.dumps(decision)}; served "
            f"{'spec' if spec.spec else 'scan'}; tokens equal the scan "
            f"run's on all {spec.n_requests} requests; acceptance_rate "
            f"{j.get('acceptance_rate')} tokens_per_s "
            f"{spec.tokens_per_s:.2f} (scan {booted.tokens_per_s:.2f}); "
            f"{secs:.2f} s; launches {got}")
    finally:
        for name, (owner, fn) in orig.items():
            setattr(owner, name, fn)
        shutil.rmtree(tmp, ignore_errors=True)
    return counts, [("default_schedule", full_tile),
                    ("autotune", res.best_tile), ("MARS GROUP x alpha",
                                                   (16, 16))]


def profile_run(torch, label, run, kernels, per_call=None):
    """Phase 5: where ``run`` spends the card's time, from torch.profiler
    (its own overhead slows the host, so the busy share it reports is a
    lower bound for an unprofiled run). ``kernels`` maps a name to a
    substring of the kernel's symbol. ``per_call`` (symbol, module with
    LAUNCHES and reset_launches): the device must run exactly one kernel
    of that symbol per wrapper call of the run."""
    from torch.profiler import ProfilerActivity, profile
    if per_call:
        per_call[1].reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        extra = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    rows = [e for e in prof.key_averages() if dev_us(e) > 0]
    # the device's own rows: an operator's row carries the device time of
    # the kernels it launched, which have rows of their own
    events = [e for e in rows if e.device_type == DeviceType.CUDA]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:6]
    out = {"run": label, "wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / (wall * 1e3), **extra,
           "copy_ms_calls": [sum(dev_us(e) for e in rows
                                 if e.key == "aten::copy_") / 1e3,
                             sum(e.count for e in rows
                                 if e.key == "aten::copy_")],
           **{f"{name}_ms": sum(dev_us(e) for e in events if sym in e.key)
              / 1e3 for name, sym in kernels.items()},
           "top": [[e.key[:60], dev_us(e) / 1e3, e.count] for e in top]}
    if per_call and events:
        sym, mod = per_call
        ran = sum(e.count for e in events if sym in e.key)
        assert ran == mod.LAUNCHES > 0, (label, sym, ran, mod.LAUNCHES)
        out[f"{sym}_kernels_per_call"] = [ran, mod.LAUNCHES]
    if not events:
        out = {"run": label,
               "device_time": "not measured (profiler saw no device time)"}
    log(json.dumps({"profile": out}))


def profile_serve(torch, cfg, sp):
    """A scan-engine serve run of 4 requests; one decode-attention kernel
    on the device per wrapper call."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.serve import BatchConfig, BatchServer, Request
    srv = BatchServer(cfg, sp, engine="scan", device=DEV,
                      bcfg=BatchConfig(n_slots=N_SLOTS, block_size=16,
                                       n_blocks=96))
    reqs = make_trace(Request, cfg.vocab, seed=5)[:N_SLOTS]
    srv.run(reqs[:1])  # warm-up
    torch.cuda.synchronize()
    profile_run(torch, "yi-6b scan serve", lambda: {
        "decode_steps": srv.run(reqs).n_decode_steps},
        {"bsr_kernel": "bsr_matmul_kernel", "bsr_reduce": "bsr_split_reduce",
         "bsr_copy": "bsr_x_to_bf16", "fake_quant_kernel": "fake_quant",
         "decode_attention_kernel": "decode_attention"},
        ("decode_attention_kernel", DA))


def profile_spec(torch, cfg, sp, draft):
    """A spec-engine serve run of 4 requests (reprune draft); one
    decode-attention kernel on the device per wrapper call."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.serve import BatchConfig, BatchServer, Request
    from repro_torch.serve import spec as SPM
    srv = BatchServer(cfg, sp, engine="spec", device=DEV, draft=draft,
                      spec=SPM.SpecConfig(k=SPEC_K,
                                          draft_sparsity=SPEC_DRAFT_SPARSITY),
                      bcfg=BatchConfig(n_slots=N_SLOTS, block_size=16,
                                       n_blocks=96))
    reqs = make_trace(Request, cfg.vocab, seed=5)[:N_SLOTS]
    srv.run(reqs[:1])  # warm-up
    torch.cuda.synchronize()
    profile_run(torch, "yi-6b spec (reprune) serve", lambda: {
        "rounds": srv.run(reqs).spec["n_rounds"]},
        {"bsr_kernel": "bsr_matmul_kernel", "bsr_reduce": "bsr_split_reduce",
         "bsr_copy": "bsr_x_to_bf16", "fake_quant_kernel": "fake_quant",
         "decode_attention_kernel": "decode_attention"},
        ("decode_attention_kernel", DA))


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


def device_split(torch, fn, flush, names, iters=10):
    """Mean device time (ms) per launch of each kernel whose symbol holds
    one of ``names`` over ``iters`` calls of ``fn``, L2 flushed before
    each, from torch.profiler (over the launches the profiler recorded): 0
    for a kernel the calls did not launch (one split: no reduce), "not
    measured" for all if the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "self_device_time_total", 0.0) > 0]
    if not events:
        return {name: "not measured" for name in names}
    out = {}
    for name in names:
        mine = [e for e in events if name in e.key]
        launches = sum(e.count for e in mine)
        out[name] = (sum(e.self_device_time_total for e in mine) / launches
                     / 1e3 if launches else 0.0)
    return out


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
    indices, x and y; 2 FLOPs per multiply-add of a valid block, at the
    bf16 tensor-core rate (the timed x is eq. 5 data, exact in bf16, which
    the kernel multiplies in one bf16 MMA a step; see
    BF16_TC_FLOPS_PER_S)."""
    blocks = nnz * bk * bn
    return bound_ms(blocks + nnz * 8 + go * 4 + m * k * 4 + m * n * 4,
                    2 * m * blocks, BF16_TC_FLOPS_PER_S)


def bsr_rows(torch, K, Q, flush, name, entry, ops, run, k_in, extra=None,
             ms=None):
    """Phase 8's rows of one block-sparse packing (layer 0 of ``ops``) at
    decode and prefill rows (or at ``ms`` rows): kernel / bound / plain /
    library times, and the kernel's device time split into its launches
    (the bf16 copy of x, the main kernel, the split reduce)."""
    _, go, nmax, bk, bn = ops[0].shape
    nnz = int(ops[3][0].clamp(max=nmax).sum())
    w_dense = K.dense_weight(*ops, 0, k_in)  # the library call's weight
    rows = []
    for m in ms or (N_SLOTS, PROMPT_ROWS):
        x = Q.quantize_activation(torch.randn((m, k_in), device=DEV),
                                  8, signed=True)
        b_ms, b_by = bound(m, k_in, go * bn, nnz, bk, bn, go)
        label = (f"{name} {m} rows" if ms else f"{name} decode"
                 if m == N_SLOTS else f"{name} prefill")
        row = {"shape": label, "entry": entry, "M": m,
               "K": k_in, "N": go * bn, "tile": [bk, bn],
               "nnz_blocks": nnz, **(extra or {}),
               "kernel_ms": time_ms(torch, lambda: run(x), flush),
               "bound_ms": b_ms, "bound_by": b_by,
               "plain_ms": time_ms(torch, lambda: K.bsr_matmul_stacked_plain(
                   x, *ops, 0), flush),
               "library_ms": time_ms(
                   torch, lambda: torch.matmul(x, w_dense), flush),
               "device_ms": device_split(
                   torch, lambda: run(x), flush,
                   ("bsr_x_to_bf16", "bsr_matmul_kernel",
                    "bsr_split_reduce"))}
        rows.append(row)
        log(json.dumps(row))
    return rows


def times(torch, K, Q, sp, stacked):
    """Phase 8: the block-sparse rows on the packed model's own weights."""
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
        rows += bsr_rows(torch, K, Q, flush, name, entry, ops, run, k_in)
    return rows


def times_mars(torch, K, Q, cfg, tiles):
    """Phase 8's rows at the schedule searches' tiles (``tiles``: (source,
    (bk, bn)) pairs; a tile two sources share is timed once): full-width
    w_gate and w_down, random weights from a seed pruned to SPARSITY and
    packed at the tile (deploy_weight), as a one-layer envelope on the
    stacked entry."""
    from repro_torch.core import deploy as D
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=DEV)
    layer0 = torch.zeros(1, dtype=torch.int32, device=DEV)
    sources = {}
    for source, tile in tiles:
        sources.setdefault(tuple(tile), []).append(source)
    gen = torch.Generator(device=DEV).manual_seed(4)
    rows = []
    for (bk, bn), src in sources.items():
        for name, d_in, d_out in (("w_gate", cfg.d_model, cfg.d_ff),
                                  ("w_down", cfg.d_ff, cfg.d_model)):
            w = torch.randn((d_in, d_out), generator=gen, device=DEV) * 0.02
            sw = D.stack_deployed([D.deploy_weight(
                w, cfg.cim, bk=bk, bn=bn, target_sparsity=SPARSITY)])
            del w
            assert sw.tile == (bk, bn), sw.tile
            ops = [sw.blocks, sw.scales, sw.row_idx, sw.nnz]
            rows += bsr_rows(
                torch, K, Q, flush, f"{name} {bk}x{bn}",
                "bsr_matmul_stacked", ops,
                lambda x, ops=ops: K.bsr_matmul_stacked(x, *ops, layer0),
                d_in, {"tile_from": src})
    return rows


def times_decode_attention(torch, DA, cfg):
    """Phase 8: the decode-attention kernel at decode and verify rows over
    DA_VIEWS and the prefix-suffix row (one slot, DA_PREFIX_T tokens over
    DA_PREFIX_VIEW positions), bf16, then the decode and verify rows again
    in the serving path's form (f32 q over bf16 K/V; the library call then
    takes K/V widened to f32 ahead of the timing), with its mean device
    time per launch (``device_ms``). Bound: q read and the output written
    once, and the K and V rows each slot's queries attend (positions 0 to
    its deepest query) read once, over the HBM rate; or 4 dh FLOPs per
    (query row, attended key) at the bf16 tensor-core rate, f32 q too (the
    kernel runs it on the tensor cores as three exact bf16 planes, whose
    extra products are its own overhead). Library: one
    scaled_dot_product_attention over the same inputs, the KV heads
    expanded to the query heads and the causal mask made ahead."""
    F = torch.nn.functional
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(23)
    rows = []
    shapes = [(sv, t, label, N_SLOTS) for sv in DA_VIEWS
              for t, label in ((1, "decode"), (SPEC_K + 1, "verify"))]
    shapes += [(DA_PREFIX_VIEW, DA_PREFIX_T, "prefix", 1)]
    # the serving path's form (f32 q over bf16 K/V) at decode and verify
    shapes += [(sv, t, label + " f32q", N_SLOTS) for sv, t, label, _ in
               shapes[:2 * len(DA_VIEWS)]]
    for sv, t, label, slots in shapes:
        q_dt = torch.float32 if label.endswith("f32q") else torch.bfloat16
        q, k, v, pos = da_inputs(torch, cfg, t, sv, gen, torch.bfloat16,
                                 slots, q_dt)
        pe = pos.long()[:, None] + torch.arange(t, device=DEV)[None]
        keys = int((pe + 1).sum()) * cfg.n_heads  # (row, key) pairs
        kv_rows = int(pe.max(dim=1).values.add(1).sum())
        nbytes = (2 * q.numel() * q.element_size() + pos.numel() * 4
                  + 2 * kv_rows * cfg.n_kv_heads * cfg.dh * 2)
        b_ms, b_by = bound_ms(nbytes, 4 * cfg.dh * keys, BF16_TC_FLOPS_PER_S)
        grp = cfg.n_heads // cfg.n_kv_heads
        kh, vh = (a.to(q_dt).repeat_interleave(grp, dim=2).transpose(1, 2)
                  for a in (k, v))
        qh = q.transpose(1, 2)
        kj = torch.arange(sv, device=DEV)[None, None, None, :]
        mask = kj <= pe[:, None, :, None]
        row = {"shape": f"decode_attention {label} {sv}",
               "entry": "decode_attention", "B": slots, "T": t,
               "Sv": sv, "H": cfg.n_heads, "KV": cfg.n_kv_heads,
               "dh": cfg.dh, "attended_pairs": keys,
               "kernel_ms": time_ms(torch, lambda: DA.decode_attention(
                   q, k, v, pos), flush),
               "bound_ms": b_ms, "bound_by": b_by,
               "plain_ms": time_ms(
                   torch, lambda: DA.decode_attention_plain(q, k, v, pos),
                   flush, iters=5, warm=1),
               "library_ms": time_ms(
                   torch, lambda: F.scaled_dot_product_attention(
                       qh, kh, vh, attn_mask=mask), flush),
               "device_ms": device_split(
                   torch, lambda: DA.decode_attention(q, k, v, pos),
                   flush, ("decode_attention_kernel",))[
                       "decode_attention_kernel"],
               "plan": list(dataclasses.astuple(DA.launch_plan(
                   q, k, cfg.n_heads, q_dt, torch.bfloat16)))}
        rows.append(row)
        log(json.dumps(row))
        del q, k, v, kh, vh, qh
    return rows


def times_mamba(torch, kern, cfg, params):
    """Phase 8: fake_quant as the QAT path calls it, on the in_proj input at
    prefill and decode (bf16 in and out) and on the in_proj weight (each
    QAT call re-quantizes it: the tanh-normalized f32 weight in, bf16 out),
    and ssd_intra_chunk at the serving shape (bf16 in, f32 out); beside the
    event times, each kernel's mean device time per launch
    (``device_ms``)."""
    from repro_torch.core import quant as Q
    _, FQ, SI, _, _ = kern
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(6)
    bf16, f32 = torch.bfloat16, torch.float32
    d = cfg.d_model
    rows = []
    w = Q.tanh_normalize(params["layers"]["in_proj"][0].float(),
                         cfg.cim_alpha)
    for name, x, out in (
            ("act prefill", torch.randn((MAMBA_BATCH * MAMBA_PROMPT, d),
                                        generator=gen, device=DEV).to(bf16),
             bf16),
            ("act decode", torch.randn((MAMBA_BATCH, d), generator=gen,
                                       device=DEV).to(bf16), bf16),
            ("weight in_proj", w, bf16)):
        # read each element once and write it once in the output type; 5
        # f32 ops (2 compares, 2 multiplies, 1 rint) each
        b_ms, b_by = bound_ms(x.numel() * (x.element_size()
                                           + out.itemsize), 5 * x.numel())
        run = lambda: FQ.fake_quant(x, 8, True, out_dtype=out)
        row = {"shape": f"fake_quant {name}", "entry": "fake_quant",
               "dims": list(x.shape),
               "dtype": f"{str(x.dtype)[6:]} in, {str(out)[6:]} out",
               "kernel_ms": time_ms(torch, run, flush),
               "bound_ms": b_ms, "bound_by": b_by,
               "plain_ms": time_ms(torch, lambda: FQ.fake_quant_plain(
                   x, 8, True, out_dtype=out), flush),
               "library_ms": None,
               "device_ms": device_split(torch, run, flush,
                                         ("fake_quant",))["fake_quant"]}
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
    # of them, 2 FLOPs per multiply-add of bf16 operands with f32 sums, at
    # the bf16 tensor-core rate; a, b, c, x read once and y (f32) written
    # once. The f32 CUDA-core rate (the first kernel's FFMA) is printed
    # beside it, labelled, for the record.
    pairs = l * (l + 1) // 2
    nbytes = (4 * C * H * l + 2 * 2 * C * l * N + 2 * C * l * H * P
              + 4 * C * l * H * P)
    flops = C * (2 * pairs * N + H * 2 * pairs * P)
    b_ms, b_by = bound_ms(nbytes, flops, BF16_TC_FLOPS_PER_S)
    run = lambda: SI.ssd_intra_chunk(a, b, c, x, out_dtype=f32)
    row = {"shape": "ssd_intra serve", "entry": "ssd_intra_chunk",
           "dims": {"C": C, "H": H, "l": l, "N": N, "P": P},
           "dtype": "bfloat16 in, float32 out",
           "kernel_ms": time_ms(torch, run, flush),
           "bound_ms": b_ms, "bound_by": b_by,
           "bound_ms_at_f32_cuda_core_rate_first_kernel": bound_ms(
               nbytes, flops)[0],
           "plain_ms": time_ms(torch, lambda: SI.ssd_intra_chunk_plain(
               a, b, c, x, out_dtype=f32), flush),
           "library_ms": None,
           "device_ms": device_split(torch, run, flush,
                                     ("ssd_intra",))["ssd_intra"],
           "plan": dataclasses.asdict(SI.launch_plan(a, b, c, x))}
    rows.append(row)
    log(json.dumps(row))
    return rows


def times_quant_matmul(torch, QM, cfg, mlp, bench):
    """Phase 8: quant_matmul at the baseline path's yi-6b shapes (w_gate
    and w_down at decode and prefill rows, bf16 x) and kernel_bench's.
    Bound: x read once, the int8 weight, the scales, f32 y written once,
    or the products at the bf16 tensor-core rate (exact: see
    BF16_TC_FLOPS_PER_S): 2 MKN FLOPs for bf16 x, and 3 x 2 MKN for f32 x,
    which the kernel multiplies as three bf16 planes (x = x0 + x1 + x2,
    exact; TF32 would round x). Counted as 2 MKN at the f32 CUDA-core rate,
    the f32 row's bound would be work the kernel does not do, and a time
    the kernel can beat. Library: torch.matmul of x.float() with the f32
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
        planes = 1 if x.dtype == torch.bfloat16 else 3
        b_ms, b_by = bound_ms(m * k * x.element_size() + k * n + 4 * n
                              + 4 * m * n, planes * 2 * m * k * n,
                              BF16_TC_FLOPS_PER_S)
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


def check_fake_quant_bwd(torch, FQ):
    """Phase 2: the straight-through backward kernel against its plain
    version, bit for bit (NaN where the plain version has NaN): both modes
    (clip: eq. 5 activations; noclip: eq. 8 weights, x unread), bits
    2/4/8, signed and unsigned, every (x, grad) pair of f32 and bf16. x
    holds 1.5-scaled normals salted with both clamp bounds, the values one
    step inside and outside them, NaN and +-inf; grad holds normals salted
    with +-inf; then views off a 16-byte boundary at odd lengths."""
    gen = torch.Generator(device=DEV).manual_seed(12)
    dtypes = (torch.float32, torch.bfloat16)
    n = 0

    def salted(shape, lo, dt):
        x = torch.randn(shape, generator=gen, device=DEV) * 1.5
        flat = x.view(-1)
        if flat.numel() > 16:
            tiny = torch.finfo(torch.float32).tiny
            one = torch.tensor(1.0, device=DEV)
            edges = [lo, 1.0, float("nan"), float("inf"), -float("inf"),
                     lo - (2 ** -7 if lo else tiny),
                     lo + (2 ** -9 if lo else tiny),
                     float(torch.nextafter(one, 2 * one)) if dt ==
                     torch.float32 else 1 + 2 ** -7,
                     float(torch.nextafter(one, 0 * one)) if dt ==
                     torch.float32 else 1 - 2 ** -9]
            for k, v in enumerate(edges):
                flat[k::len(edges) + 7] = v
        return x.to(dt)

    def compare(g, x, bits, signed, ste, dt, what):
        nonlocal n
        got = FQ.fake_quant_bwd(g, x, bits, signed, ste, dt)
        torch.cuda.synchronize()
        want = FQ.fake_quant_bwd_plain(g, x, bits, signed, ste, dt)
        assert got.dtype == dt and got.shape == g.shape, what
        assert torch.equal(got.isnan(), want.isnan()), what
        assert torch.equal(got.nan_to_num(), want.nan_to_num()), what
        n += 1

    shapes = [(1,), (3, 100, 130), (TRAIN_YI_ROWS, 4096), (4096, 1536),
              (1_000_003,)]
    for bits in (2, 4, 8):
        for signed in (False, True):
            lo = -1.0 if signed else 0.0
            for dt in dtypes:
                for gdt in dtypes:
                    for shape in shapes:
                        x = salted(shape, lo, dt)
                        g = torch.randn(shape, generator=gen, device=DEV)
                        g.view(-1)[5::211] = float("inf")
                        g.view(-1)[6::223] = -float("inf")
                        g = g.to(gdt)
                        for ste in FQ.STE_MODES:
                            compare(g, x if ste == "clip" else None, bits,
                                    signed, ste, dt,
                                    (bits, signed, dt, gdt, shape, ste))
    odd = 0
    for length in (7, 4099, 65_537, 1_000_003):
        xb = salted((length + 3,), -1.0, torch.float32)
        gb = torch.randn((length + 5,), generator=gen, device=DEV)
        for dt in dtypes:
            for gdt in dtypes:
                for k in (1, 3):
                    x = xb.to(dt)[k:k + length]
                    g = gb.to(gdt)[k + 1:k + 1 + length]
                    assert x.data_ptr() % 16 != 0
                    for ste in FQ.STE_MODES:
                        compare(g, x if ste == "clip" else None, 8, True,
                                ste, dt, ("misaligned", length, k, dt, gdt))
                        odd += 1
    log(f"[kernel] fake_quant_bwd: {n} comparisons bit for bit (tolerance "
        "0) over both straight-through modes, bits 2/4/8, signed and "
        f"unsigned, every (x, grad) pair of f32 and bf16, {odd} of them on "
        "misaligned views at odd lengths; x salted with both bounds, one "
        "step inside and outside them, NaN and +-inf")
    return 0.0


def check_ssd_intra_bwd(torch, SI, cfg):
    """Phase 2: the SSD intra-chunk backward kernel against its plain
    version (autograd through ``ssd_intra_chunk_plain``) at the training
    shape of the train phase's mamba2-780m run, the serving shape and
    SSD_SHAPES: da, db, dc and dx within SSD_BWD_TOL (f32) or 2e-2 (bf16
    b, c, x) of each gradient's max |plain|, each call repeated bit for
    bit. Returns the largest |kernel - plain| of the f32 cases."""
    gen = torch.Generator(device=DEV).manual_seed(13)
    H, l, N = cfg.n_ssm_heads, cfg.ssm_chunk, cfg.ssm_state
    P = cfg.d_inner // H
    train_shape = (TRAIN_MAMBA_BATCH * TRAIN_MAMBA_SEQ // l, H, l, N, P)
    serve_shape = (MAMBA_BATCH * MAMBA_PROMPT // l, H, l, N, P)
    err, rel = 0.0, {}
    for C, H_, l_, N_, P_ in (train_shape, serve_shape) + SSD_SHAPES:
        a = -torch.nn.functional.softplus(
            torch.randn((C, H_, l_), generator=gen, device=DEV))
        b, c = (torch.randn((C, l_, N_), generator=gen, device=DEV) * 0.3
                for _ in range(2))
        x = torch.randn((C, l_, H_, P_), generator=gen, device=DEV) * 0.3
        dy = torch.randn((C, l_, H_, P_), generator=gen, device=DEV)
        for dt, tol in ((torch.float32, SSD_BWD_TOL),
                        (torch.bfloat16, 2e-2)):
            args = (a, b.to(dt), c.to(dt), x.to(dt))
            what = f"ssd_intra_bwd {(C, H_, l_, N_, P_)} {dt}"
            got = SI.ssd_intra_chunk_bwd(*args, dy)
            again = SI.ssd_intra_chunk_bwd(*args, dy)
            torch.cuda.synchronize()
            want = SI.ssd_intra_chunk_bwd_plain(*args, dy)
            for name, g, g2, w, t in zip(("da", "db", "dc", "dx"), got,
                                         again, want, args):
                assert torch.equal(g, g2), f"{what} {name}: repeat"
                assert g.dtype == t.dtype, f"{what} {name}: dtype"
                d = float((g.float() - w.float()).abs().max())
                r = d / float(w.float().abs().max())
                assert r <= tol, f"{what} {name}: {r:.3e} > {tol}"
                key = f"{name} {str(dt)[6:]}"
                rel[key] = max(rel.get(key, 0.0), r)
                if dt == torch.float32:
                    err = max(err, d)
            del got, again, want
    log(f"[kernel] ssd_intra_chunk_bwd at {train_shape} (train), "
        f"{serve_shape} (serve) and {list(SSD_SHAPES)} (C, H, l, N, P): "
        f"within tolerance (f32 {SSD_BWD_TOL}, bf16 2e-2 of max |plain|), "
        "each call repeated bit for bit; max |kernel - plain| / max "
        "|plain|: " + ", ".join(f"{k} {v:.3e}" for k, v in sorted(
            rel.items())))
    return err


def train_launches(cfg, steps) -> dict:
    """The launches of ``steps`` QAT training steps (one microbatch each):
    fake_quant on the activations and the weight of every projection (7 a
    dense layer, in_proj and out_proj a mamba2 layer) and of the head in
    every forward, each layer's twice under ``remat`` (run again in the
    backward), and fake_quant_bwd once for each in the backward;
    ssd_intra_chunk once a mamba2 layer a forward, its backward once."""
    proj = 7 if cfg.family == "dense" else 2
    again = 2 if cfg.remat in ("full", "dots") else 1
    ssm = cfg.family == "ssm"
    return {"bsr_matmul": 0, "bsr_matmul_stacked": 0, "quant_matmul": 0,
            "decode_attention": 0,
            "fake_quant": 2 * (proj * cfg.n_layers * again + 1) * steps,
            "fake_quant_bwd": 2 * (proj * cfg.n_layers + 1) * steps,
            "ssd_intra_chunk": cfg.n_layers * again * steps * ssm,
            "ssd_intra_chunk_bwd": cfg.n_layers * steps * ssm}


def train_counts(kern) -> dict:
    _, FQ, SI, _, _ = kern
    return dict(launch_counts(kern), fake_quant_bwd=FQ.BWD_LAUNCHES,
                ssd_intra_chunk_bwd=SI.BWD_LAUNCHES)


def grad_gap(torch, g, want):
    """Per leaf, |g - want|_2 / |want|_2; the largest and its leaf."""
    from repro_torch.train.checkpoint import flatten
    from repro_torch.train.optimizer import leaves
    gaps = {k: float((a.double() - b.double()).norm()
                     / b.double().norm().clamp_min(1e-300))
            for (k, a), (_, b) in zip(flatten(g), flatten(want))}
    worst = max(gaps, key=gaps.get)
    assert len(leaves(g)) == len(gaps)
    return gaps[worst], worst


def train_grads(torch, kern, cfg, tokens):
    """One step's gradients on the kernel path against the plain path
    (wrappers swapped for their plain versions, every other op unchanged),
    on fresh weights from seed 0: with fake_quant (forward and backward)
    swapped the gradients must be equal bit for bit, and with the SSD
    kernels swapped too, in f32 cim_mode "dense" on the same weights (no
    eq. 5 level to flip), within TRAIN_GRAD_TOL per leaf (relative L2):
    the SSD kernels sum in f32 in another order. The QAT path with both
    swapped is printed: a one-ulp difference flips an eq. 5 level, which
    moves every gradient upstream of it."""
    from repro_torch.models import registry
    from repro_torch.train import trainer as TR
    from repro_torch.train.optimizer import leaves
    _, FQ, SI, _, _ = kern
    params = registry.model_fns(cfg).init_params(
        cfg, torch.Generator(device=DEV).manual_seed(0), DEV)
    params = TR.train_state(TR.TrainConfig(), params,
                            opt_state={})["params"]
    batch = {"tokens": tokens}

    def grads(c):
        (_, ce), g = TR.value_and_grad(TR.make_loss_fn(c), params, batch)
        return float(ce), g

    out = {}
    ce, g = grads(cfg)
    saved = FQ.fake_quant, SI.ssd_intra_chunk
    try:
        FQ.fake_quant = FQ.fake_quant_plain
        ce_fq, g_fq = grads(cfg)
        same = all(torch.equal(a, b) for a, b in zip(
            leaves(g), leaves(g_fq)))
        assert same and ce == ce_fq, (cfg.name, "fake_quant swapped")
        out["fake_quant_swapped"] = "bit for bit"
        del g_fq
        if cfg.family == "ssm":
            SI.ssd_intra_chunk = SI.ssd_intra_chunk_plain
            _, g_plain = grads(cfg)
            out["qat_all_swapped_max_rel_l2"] = grad_gap(torch, g, g_plain)
            del g_plain
            dense = dataclasses.replace(cfg, cim_mode="dense")
            SI.ssd_intra_chunk = saved[1]
            FQ.fake_quant = saved[0]
            _, g_k = grads(dense)
            FQ.fake_quant = FQ.fake_quant_plain
            SI.ssd_intra_chunk = SI.ssd_intra_chunk_plain
            _, g_p = grads(dense)
            gap, leaf = grad_gap(torch, g_k, g_p)
            assert gap <= TRAIN_GRAD_TOL, (cfg.name, leaf, gap)
            out["dense_all_swapped_max_rel_l2"] = [gap, leaf]
            del g_k, g_p
    finally:
        FQ.fake_quant, SI.ssd_intra_chunk = saved
    del g, params
    return out


def train(torch, kern, card):
    """Phase "train": ``repro_torch.launch.train.main(argv)`` in-process,
    QAT (--cim) with the group lasso, AdamW, f32, on TokenPipeline, for
    yi-6b at full width with depth cut to TRAIN_YI_LAYERS and mamba2-780m
    at full width and depth (each config's depth cut by wrapping
    ``registry.get_config``, which the CLI reads), under
    ``torch.use_deterministic_algorithms(True)``. Each model:

    a. one step's gradients against the plain path (``train_grads``);
    b. a straight run: the loss finite and falling (the mean of the last
       5 steps under the first step's), launch counts exact
       (``train_launches``: every projection's forward and backward
       through fake_quant and fake_quant_bwd, every mamba2 layer's
       through both SSD kernels), step ms and tokens/s;
    c. the same run stopped by SIGTERM after its step ``stop`` (it
       checkpoints and exits 0), then ``--resume``: the same losses from
       there and the same parameters and moments as the straight run, bit
       for bit;
    d. one more step profiled (torch.profiler): the busy share and the top
       kernels.

    Checkpoints go to a temporary directory, removed afterwards. Returns
    the launch counts of the straight runs."""
    import shutil
    import signal
    import tempfile
    from repro_torch.launch import train as CLI
    from repro_torch.data import TokenPipeline
    from repro_torch.models import registry
    from repro_torch.train.optimizer import leaves
    counts = {}
    get_config = registry.get_config
    make_step = CLI.make_train_step
    t_phase = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    try:
        for arch, argv, stop, layers in (
                ("yi-6b", TRAIN_YI, TRAIN_YI_STOP, TRAIN_YI_LAYERS),
                ("mamba2-780m", TRAIN_MAMBA, TRAIN_MAMBA_STOP, None)):
            registry.get_config = (
                (lambda a, **k: get_config(a, **dict(k, n_layers=layers)))
                if layers else get_config)
            cfg = registry.get_config(
                arch, dtype="float32", cim_mode="qat", w_bits=8, a_bits=8,
                lambda_g=float(argv[argv.index("--lambda-g") + 1]),
                cim_alpha=16, cim_n=16)
            steps = int(argv[argv.index("--steps") + 1])
            batch = int(argv[argv.index("--batch") + 1])
            seq = int(argv[argv.index("--seq") + 1])
            tmp = tempfile.mkdtemp(prefix=f"train-{arch}-")
            rec = {"arch": arch, "layers": cfg.n_layers, "batch": batch,
                   "seq": seq, "steps": steps, "argv": " ".join(argv)}
            try:
                toks = torch.as_tensor(TokenPipeline(
                    cfg.vocab, batch, seq, seed=0).next_batch()["tokens"],
                    device=DEV)
                t0 = time.perf_counter()
                rec["grads"] = train_grads(torch, kern, cfg, toks)
                rec["grads_s"] = time.perf_counter() - t0
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                torch.cuda.synchronize()
                reset_launches(kern)
                log(f"[train] {arch}: main({' '.join(argv)})")
                t0 = time.perf_counter()
                straight = CLI.main(argv + ["--ckpt-dir", f"{tmp}/a"])
                torch.cuda.synchronize()
                rec["wall_s"] = time.perf_counter() - t0
                counts[f"train {arch}"] = got = train_counts(kern)
                want = train_launches(cfg, steps)
                assert got == want, (arch, got, want)
                losses = straight.losses
                assert all(math.isfinite(v) for v in losses), losses
                assert statistics.mean(losses[-5:]) < losses[0], losses
                n_params = sum(p.numel() for p in leaves(
                    straight.state["params"]))
                steady = statistics.median(straight.step_s[1:])
                rec.update(params=n_params, losses=losses,
                           first_step_s=straight.step_s[0],
                           step_ms_median=steady * 1e3,
                           tokens_per_s=batch * seq / steady,
                           peak_mem_gb=torch.cuda.max_memory_allocated()
                           / 2 ** 30, launches=got)
                final = [t.detach().clone() for t in
                         leaves(straight.state["params"])
                         + leaves(straight.state["opt"])]
                del straight
                shutil.rmtree(f"{tmp}/a")
                torch.cuda.empty_cache()

                def stopping(c, t):
                    step = make_step(c, t)

                    def run(state, b):
                        out = step(state, b)
                        if state["step"] == stop:
                            signal.raise_signal(signal.SIGTERM)
                        return out
                    return run

                CLI.make_train_step = stopping
                try:
                    CLI.main(argv + ["--ckpt-dir", f"{tmp}/b"])
                    raise AssertionError(f"{arch}: SIGTERM did not stop it")
                except SystemExit as e:
                    assert e.code == 0, e.code
                finally:
                    CLI.make_train_step = make_step
                resumed = CLI.main(argv + ["--ckpt-dir", f"{tmp}/b",
                                           "--resume"])
                assert resumed.start_step == stop
                assert resumed.losses == losses[stop:], (resumed.losses,
                                                         losses)
                after = (leaves(resumed.state["params"])
                         + leaves(resumed.state["opt"]))
                assert all(torch.equal(a, b) for a, b in zip(final, after))
                rec["resume"] = (f"SIGTERM after step {stop}, --resume to "
                                 f"{steps}: parameters and moments bit for "
                                 "bit equal to the straight run's")
                del final, after
                log(json.dumps({"train": rec}))
                profile_train(torch, cfg, resumed.state, toks)
                del resumed
            finally:
                registry.get_config = get_config
                shutil.rmtree(tmp, ignore_errors=True)
                torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    log(f"[train] phase {time.perf_counter() - t_phase:.1f} s")
    return counts


def profile_train(torch, cfg, state, tokens):
    """Phase 7 for training: one more optimizer step of ``state`` (warmed
    up by the runs before it) under torch.profiler."""
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import trainer as TR
    tcfg = TR.TrainConfig(opt=OPT.OptConfig(lr=3e-3, warmup_steps=10,
                                            total_steps=100))
    step = TR.make_train_step(cfg, tcfg)
    profile_run(torch, f"{cfg.name} train step ({cfg.n_layers} layers)",
                lambda: {"loss": float(step(state, {"tokens": tokens})[1][
                    "loss"])},
                {"fake_quant_fwd": "fake_quant_kernel",
                 "fake_quant_bwd": "fake_quant_bwd_kernel",
                 "ssd_intra_fwd": "ssd_intra",
                 "ssd_intra_bwd": "ssd_bwd_",
                 "gemm": "gemm"})


def times_train(torch, kern, cfg_yi, cfg_mamba):
    """Phase 8: the two backward kernels at the train phase's shapes, in
    f32: fake_quant_bwd on yi-6b's widest activation (B S, d_ff) in the
    clip mode and its w_gate weight (d_model, d_ff) in the noclip mode;
    the SSD intra-chunk backward at the mamba2-780m training shape. Kernel
    ms (CUDA events, L2 flushed), the least time for the same work, the
    plain version's ms, no library call (no one PyTorch call computes
    either), the per-launch device ms."""
    _, FQ, SI, _, _ = kern
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(14)
    rows = []
    for name, shape, ste in (
            ("act train", (TRAIN_YI_ROWS, cfg_yi.d_ff), "clip"),
            ("weight train", (cfg_yi.d_model, cfg_yi.d_ff), "noclip")):
        x = torch.randn(shape, generator=gen, device=DEV)
        g = torch.randn(shape, generator=gen, device=DEV)
        xs = x if ste == "clip" else None
        # grad read and grad_in written (and x read in the clip mode), 4
        # bytes each; 2 multiplies, and in the clip mode 4 compares and a
        # multiply by the slope's mask, each an f32 operation
        reads = 2 if ste == "clip" else 1
        b_ms, b_by = bound_ms(x.numel() * 4 * (reads + 1),
                              x.numel() * (7 if ste == "clip" else 2))
        run = lambda: FQ.fake_quant_bwd(g, xs, 8, True, ste, torch.float32)
        row = {"shape": f"fake_quant_bwd {name}", "entry": "fake_quant_bwd",
               "dims": list(shape), "dtype": f"float32, {ste}",
               "kernel_ms": time_ms(torch, run, flush),
               "bound_ms": b_ms, "bound_by": b_by,
               "plain_ms": time_ms(torch, lambda: FQ.fake_quant_bwd_plain(
                   g, xs, 8, True, ste, torch.float32), flush),
               "library_ms": None,
               "device_ms": device_split(torch, run, flush, (
                   "fake_quant_bwd",))["fake_quant_bwd"]}
        rows.append(row)
        log(json.dumps(row))
    H, l, N = cfg_mamba.n_ssm_heads, cfg_mamba.ssm_chunk, cfg_mamba.ssm_state
    P = cfg_mamba.d_inner // H
    C = TRAIN_MAMBA_BATCH * TRAIN_MAMBA_SEQ // l
    a = -torch.nn.functional.softplus(torch.randn((C, H, l), generator=gen,
                                                  device=DEV))
    b, c = (torch.randn((C, l, N), generator=gen, device=DEV)
            for _ in range(2))
    x = torch.randn((C, l, H, P), generator=gen, device=DEV)
    dy = torch.randn((C, l, H, P), generator=gen, device=DEV)
    # the least work over the causal pairs i >= j, l (l + 1) / 2 of them:
    # S = C B^T (N multiply-adds a pair), dM = dy x^T and dx = M^T dy (P
    # each a pair and head), dC = dS B and dB = dS^T C (N each a pair), 2
    # FLOPs a multiply-add; a, b, c, x, dy read once and da, db, dc, dx
    # written once, f32. The kernel multiplies on the bf16 tensor cores,
    # each f32 operand as three exact planes and SSD_BWD_PASSES plane
    # products a multiply-add, so its operations take that many passes of
    # the work at the bf16 tensor-core rate; the same work at the CUDA
    # cores' f32 rate (the first kernel's bound) is printed beside it
    pairs = l * (l + 1) // 2
    nbytes = 4 * (2 * C * H * l + 4 * C * l * N + 3 * C * l * H * P)
    flops = 2 * C * pairs * (3 * N + 2 * H * P)
    b_ms, b_by = bound_ms(nbytes, SSD_BWD_PASSES * flops,
                          BF16_TC_FLOPS_PER_S)
    f32_ms, f32_by = bound_ms(nbytes, flops)
    run = lambda: SI.ssd_intra_chunk_bwd(a, b, c, x, dy)
    row = {"shape": "ssd_intra_bwd train", "entry": "ssd_intra_chunk_bwd",
           "dims": {"C": C, "H": H, "l": l, "N": N, "P": P},
           "dtype": "float32",
           "kernel_ms": time_ms(torch, run, flush),
           "bound_ms": b_ms, "bound_by": b_by,
           "tc_passes": SSD_BWD_PASSES,
           "bound_ms_f32_cuda_cores": f32_ms, "bound_by_f32_cuda_cores":
           f32_by,
           "plain_ms": time_ms(torch, lambda: SI.ssd_intra_chunk_bwd_plain(
               a, b, c, x, dy), flush, iters=10),
           "library_ms": None,
           "device_ms": device_split(torch, run, flush, (
               "ssd_bwd_scores", "ssd_bwd_main", "ssd_bwd_finish"))}
    rows.append(row)
    log(json.dumps(row))
    return rows


def cnn_loss(torch, net, cim, plan=None, train=True):
    """test_system's loss: cross entropy + the model's regularization;
    returns (loss, (ce, new_state, logits))."""
    from repro_torch.models import cnn
    apply = ((lambda p, s, x: cnn.vgg_apply(p, s, x, cim, plan, train))
             if net == "vgg16" else
             (lambda p, s, x: cnn.resnet_apply(p, s, x, cim, train)))

    def loss(p, s, images, labels):
        logits, s2 = apply(p, s, images)
        ce = -torch.log_softmax(logits, -1).gather(
            1, labels[:, None]).mean()
        return ce + cnn.regularization(p, cim), (ce, s2, logits)
    return loss


def cnn_step(loss, p, s, images, labels):
    """The reference's update (``cnn.sgd_step`` at CNN_LR); returns
    (params, state, ce)."""
    from repro_torch.models import cnn
    p, (ce, s2, _) = cnn.sgd_step(loss, p, s, images, labels, lr=CNN_LR)
    return p, s2, float(ce.detach())


def cnn_launches(n_convs, steps, train=True) -> dict:
    """The launches of ``steps`` QAT steps (or forwards) of a CNN: eq. 5 on
    every conv's input and eqs. 7-8 on its weight, one fake_quant each, in
    every forward; in training fake_quant_bwd on every weight and on every
    conv input that needs a gradient (all but the first conv's, whose
    input is the images)."""
    return {"bsr_matmul": 0, "bsr_matmul_stacked": 0, "quant_matmul": 0,
            "decode_attention": 0, "ssd_intra_chunk": 0,
            "ssd_intra_chunk_bwd": 0, "fake_quant": 2 * n_convs * steps,
            "fake_quant_bwd": (2 * n_convs - 1) * steps * train}


def cnn_batch(torch, pipe):
    b = pipe.next_batch()
    return (torch.as_tensor(b["images"], device=DEV),
            torch.as_tensor(b["labels"], device=DEV).long())


def cnn_plain_equal(torch, FQ, run):
    """``run()`` on the kernel path and with fake_quant (forward and
    backward) swapped for its plain version: every tensor of the two
    results equal bit for bit."""
    from repro_torch.core.sparsity import tensor_leaves
    got = run()
    saved = FQ.fake_quant
    FQ.fake_quant = FQ.fake_quant_plain
    try:
        want = run()
    finally:
        FQ.fake_quant = saved
    a, b = tensor_leaves(got), tensor_leaves(want)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    return len(a)


def cnn_net(torch, kern, net, card):
    """Phase 11 for one full-width network (see ``cnn``)."""
    from repro_torch.configs import resnet18_cifar, vgg16_cifar
    from repro_torch.core import cim_layer as CL
    from repro_torch.core import sparsity as S
    from repro_torch.data import ImagePipeline
    from repro_torch.models import cnn
    _, FQ, _, _, _ = kern
    cim = vgg16_cifar.cim_config()
    gen = torch.Generator(device=DEV).manual_seed(0)
    if net == "vgg16":
        plan = vgg16_cifar.FULL_PLAN
        params, state = cnn.vgg_init(gen, cim, plan, n_classes=10,
                                     device=DEV)
    else:
        plan = None
        params, state = cnn.resnet_init(gen, cim, resnet18_cifar.FULL_STAGES,
                                        n_classes=10, device=DEV)
    n_convs = len(list(cnn.iter_conv_params(params)))
    n_params = sum(t.numel() for t in S.tensor_leaves(params)
                   if t.is_floating_point()) - sum(
        p["mask"].numel() for p in cnn.iter_conv_params(params))
    loss = cnn_loss(torch, net, cim, plan)
    pipe = ImagePipeline(n_classes=10, hw=32, batch=CNN_BATCH, seed=0)
    rec = {"net": net, "convs": n_convs, "params": n_params,
           "batch": CNN_BATCH, "cim": "qat w8a4, alpha = N = 16, "
           "lambda_g 1e-4", "card": card}

    # a. one train step, kernel path against plain path
    images, labels = cnn_batch(torch, pipe)
    rec["plain_path_tensors_equal"] = cnn_plain_equal(
        torch, FQ, lambda: cnn.grads(loss, params, state, images, labels))

    # b. CNN_STEPS steps of the reference's update
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_launches(kern)
    ces, step_s = [], []
    for _ in range(CNN_STEPS):
        images, labels = cnn_batch(torch, pipe)
        t0 = time.perf_counter()
        params, state, ce = cnn_step(loss, params, state, images,
                                     labels)
        step_s.append(time.perf_counter() - t0)  # float(ce) synchronized
        ces.append(ce)
    got, want = train_counts(kern), cnn_launches(n_convs, CNN_STEPS)
    assert got == want, (net, got, want)
    assert all(math.isfinite(v) for v in ces), ces
    steady = statistics.median(step_s[1:])
    rec.update(losses=ces, first_step_ms=step_s[0] * 1e3,
               step_ms_median=steady * 1e3, images_per_s=CNN_BATCH / steady,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=got)
    counts = {f"cnn {net}": got}
    profile_run(torch, f"{net} QAT train step (batch {CNN_BATCH})",
                lambda: {"ce": cnn_step(loss, params, state, images,
                                        labels)[2]},
                {"fake_quant_fwd": "fake_quant_kernel",
                 "fake_quant_bwd": "fake_quant_bwd_kernel"})

    # c. prune, masked retraining, masked weights dead
    cim_p = dataclasses.replace(cim, sparsity=dataclasses.replace(
        cim.sparsity, target_sparsity=CNN_TARGET))
    pruned = cnn.prune_all(params, cim_p)
    masks = [p["mask"].clone() for p in cnn.iter_conv_params(pruned)]
    zg = []
    for p in cnn.iter_conv_params(pruned):
        kh, kw, ci, co = p["mask"].shape
        zg.append(float(torch.stack([
            S.zero_groupset_proportion(m, 16, 16)
            for m in p["mask"].reshape(kh * kw, ci, co)]).mean()))
    rec["zero_groupset_proportion"] = zg
    reset_launches(kern)
    for _ in range(CNN_RETRAIN):
        images, labels = cnn_batch(torch, pipe)
        pruned, state, ce = cnn_step(loss, pruned, state, images,
                                     labels)
    got = train_counts(kern)
    assert got == cnn_launches(n_convs, CNN_RETRAIN), (net, got)
    counts[f"cnn {net} retrain"] = got
    dead = 0
    for p, m in zip(cnn.iter_conv_params(pruned), masks):
        co = p["w"].shape[-1]
        assert torch.equal(p["mask"], m), net
        w_eff = CL.effective_weight({"w": p["w"].reshape(-1, co),
                                     "mask": m.reshape(-1, co)}, cim_p)
        off = m.reshape(-1, co) == 0
        assert bool((w_eff[off] == 0).all()), net
        dead += int(off.sum())
    rec.update(retrain_final_ce=ce, masked_weights_dead=dead)

    # d. eval on a held-out batch
    held = ImagePipeline(n_classes=10, hw=32, batch=CNN_BATCH, seed=1)
    images, labels = cnn_batch(torch, held)
    ev = cnn_loss(torch, net, cim, plan, train=False)
    reset_launches(kern)
    with torch.no_grad():
        _, (_, _, logits) = ev(pruned, state, images, labels)
    torch.cuda.synchronize()
    got = train_counts(kern)
    assert got == cnn_launches(n_convs, 1, train=False), (net, got)
    counts[f"cnn {net} eval"] = got
    with torch.no_grad():
        cnn_plain_equal(torch, FQ, lambda: ev(pruned, state, images,
                                              labels)[1][2])
    rec["eval_accuracy"] = float((logits.argmax(-1) == labels).float()
                                 .mean())
    log(json.dumps({"cnn": rec}))
    return counts, pruned


def cnn_deploy(torch, kern, params, card):
    """VGG16's deepest conv, pruned and retrained, deployed: its (3 3 512,
    512) matrix through eqs. 6-8 at 8 bits with its mask, packed at 16x16
    and multiplied by the block-sparse kernel at CNN_DEPLOY_ROWS rows of
    eq. 5 activations and of off-grid f32 x, against the plain version and
    x @ w2d within phase 2's f32 tolerance (1e-5)."""
    from repro_torch.core import quant as Q
    from repro_torch.kernels import ops
    from repro_torch.models import cnn
    K = kern[0]
    deep = list(cnn.iter_conv_params(params))[-1]
    co = deep["w"].shape[-1]
    w2d = Q.mars_weight_quant((deep["w"] * deep["mask"]).reshape(-1, co),
                              8, 16)
    packed = ops.pack_for_kernel(w2d, bits=8, bk=16, bn=16)
    gen = torch.Generator(device=DEV).manual_seed(11)
    xs = {(m, kind): (ops.fake_quant(torch.rand((m, w2d.shape[0]),
                                                generator=gen, device=DEV),
                                     4) if kind == "eq5" else
                      torch.randn((m, w2d.shape[0]), generator=gen,
                                  device=DEV))
          for m in CNN_DEPLOY_ROWS for kind in ("eq5", "f32")}
    reset_launches(kern)
    ys = {key: ops.bsr_matmul(x, packed) for key, x in xs.items()}
    torch.cuda.synchronize()
    got = dict(K.LAUNCHES_BY_ENTRY)
    assert got == {"bsr_matmul": len(xs), "bsr_matmul_stacked": 0}, got
    err = 0.0
    for key, x in xs.items():
        want = K.bsr_matmul_stacked_plain(
            x, packed["blocks"][None], packed["scales"][None],
            packed["row_idx"][None], packed["nnz"][None], 0)
        for ref in (want, x @ w2d):
            torch.testing.assert_close(ys[key], ref, rtol=1e-5, atol=1e-5)
        err = max(err, float((ys[key] - want).abs().max()))
    log(json.dumps({"cnn_deploy": {
        "conv": list(deep["w"].shape), "matrix": list(w2d.shape),
        "tile": [16, 16], "density": packed["density"],
        "rows": list(CNN_DEPLOY_ROWS), "x": ["eq5", "f32"],
        "max_abs_err_vs_plain": err, "launches": got["bsr_matmul"],
        "card": card}}))
    single = [packed[k] for k in ("blocks", "scales", "row_idx", "nnz")]
    rows = bsr_rows(torch, K, Q, torch.empty(64 * 2 ** 20, dtype=torch.int32,
                                             device=DEV),
                    "cnn deploy vgg16 conv13 16x16", "bsr_matmul",
                    [a[None] for a in single],
                    lambda x: K.bsr_matmul(x, *single), w2d.shape[0],
                    ms=CNN_DEPLOY_ROWS)
    return {"cnn deploy": {"bsr_matmul": got["bsr_matmul"]}}, err, rows


def times_cnn(torch, kern):
    """Phase 8 at the cnn phase's shapes, f32: fake_quant on VGG16's widest
    conv input (CNN_BATCH, 32, 32, 64) at 4 bits and on its deepest weight
    (3 3 512, 512) at 8 bits signed, and the straight-through backward of
    both (the clamped rule, which reads x): kernel, bound and plain times
    and the device time per launch."""
    _, FQ, _, _, _ = kern
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(15)
    rows = []
    for name, shape, bits, signed in (
            ("act", (CNN_BATCH, 32, 32, 64), 4, False),
            ("weight", (3 * 3 * 512, 512), 8, True)):
        x = torch.rand(shape, generator=gen, device=DEV) * 1.4 - 0.2
        g = torch.randn(shape, generator=gen, device=DEV)
        n = x.numel()
        for entry, run, plain, nbytes, ops in (
                ("fake_quant", lambda: FQ.fake_quant(x, bits, signed),
                 lambda: FQ.fake_quant_plain(x, bits, signed), 8 * n, 5 * n),
                # grad and x read, grad_in written; 2 multiplies, 4
                # compares and the slope's multiply
                ("fake_quant_bwd",
                 lambda: FQ.fake_quant_bwd(g, x, bits, signed, "clip"),
                 lambda: FQ.fake_quant_bwd_plain(g, x, bits, signed, "clip"),
                 12 * n, 7 * n)):
            b_ms, b_by = bound_ms(nbytes, ops)
            row = {"shape": f"{entry} cnn {name}", "entry": entry,
                   "dims": list(shape), "dtype": "float32",
                   "bits": bits, "signed": signed,
                   "kernel_ms": time_ms(torch, run, flush),
                   "bound_ms": b_ms, "bound_by": b_by,
                   "plain_ms": time_ms(torch, plain, flush),
                   "library_ms": None,
                   "device_ms": device_split(torch, run, flush, (
                       f"{entry}_kernel",))[f"{entry}_kernel"]}
            rows.append(row)
            log(json.dumps(row))
    return rows


def cnn_small(torch, kern, card):
    """tests/test_system.py's CNN learning check on the card: SMALL_PLAN,
    4 classes, 16x16 images, batch 16, QAT w4a4 with lambda_g 1e-3, seed
    0 weights drawn on the host; the mean of the last 5 cross entropies
    under the mean of the first 5 by 0.05."""
    from repro_torch.configs import vgg16_cifar
    from repro_torch.data import ImagePipeline
    from repro_torch.models import cnn
    cim = vgg16_cifar.cim_config(w_bits=4, a_bits=4, lambda_g=1e-3)
    params, state = cnn.vgg_init(torch.Generator().manual_seed(0), cim,
                                 vgg16_cifar.SMALL_PLAN, n_classes=4,
                                 device="cpu")
    params, state = cnn.map_tensors(lambda t: t.to(DEV), (params, state))
    loss = cnn_loss(torch, "vgg16", cim, vgg16_cifar.SMALL_PLAN)
    pipe = ImagePipeline(n_classes=4, batch=16, hw=16)
    reset_launches(kern)
    ces = []
    for _ in range(CNN_SMALL_STEPS):
        images, labels = cnn_batch(torch, pipe)
        params, state, ce = cnn_step(loss, params, state, images,
                                     labels)
        ces.append(ce)
    got = train_counts(kern)
    assert got == cnn_launches(3, CNN_SMALL_STEPS), got
    first, last = statistics.mean(ces[:5]), statistics.mean(ces[-5:])
    assert last < first - 0.05, ("the small CNN did not learn", ces)
    log(json.dumps({"cnn_small": {"plan": vgg16_cifar.SMALL_PLAN,
                                  "steps": CNN_SMALL_STEPS,
                                  "first5_ce": first, "last5_ce": last,
                                  "card": card}}))
    return {"cnn small": got}


def cnn(torch, kern, card):
    """Phase "cnn": the paper's CNNs through ``repro_torch.models.cnn``,
    driven as tests/test_system.py and examples/compress_cnn.py drive the
    reference's, under ``torch.use_deterministic_algorithms(True)`` in f32
    (TF32 off). For VGG16-CIFAR and ResNet18-CIFAR at full width (random
    weights, seed 0; cim_config()'s QAT w8a4):

    a. one train step's loss, gradients and new BN state on the kernel
       path equal bit for bit to the plain path's (fake_quant and its
       backward swapped for their plain versions);
    b. CNN_STEPS steps of the reference's update: the loss finite, step ms
       (median) and images/s, peak memory, launch counts exact a step
       (``cnn_launches``);
    c. ``prune_all`` at CNN_TARGET, each conv's zero group-set proportion,
       CNN_RETRAIN masked steps (launches exact), the masks unchanged and
       every masked weight's effective weight exactly 0;
    d. an eval forward on a held-out batch: 2 fake_quant launches a conv,
       equal bit for bit to the plain path's, the accuracy printed.

    Then VGG16's deepest conv deployed (``cnn_deploy``) and the small
    net's learning check (``cnn_small``). Returns the launch counts, the
    deployed conv's max |kernel - plain| and its phase 8 rows."""
    t_phase = time.perf_counter()
    counts = {}
    torch.use_deterministic_algorithms(True)
    try:
        for net in ("vgg16", "resnet18"):
            got, params = cnn_net(torch, kern, net, card)
            counts.update(got)
            if net == "vgg16":
                got, err, rows = cnn_deploy(torch, kern, params, card)
                counts.update(got)
            del params
            torch.cuda.empty_cache()
        counts.update(cnn_small(torch, kern, card))
    finally:
        torch.use_deterministic_algorithms(False)
    log(f"[cnn] phase {time.perf_counter() - t_phase:.1f} s ({card})")
    return counts, err, rows


def main() -> int:
    # the train phase runs under torch.use_deterministic_algorithms, whose
    # cuBLAS needs a fixed workspace, read when cuBLAS starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    search = start_full_search()
    try:
        return run_all(torch, search)
    finally:
        if search.poll() is None:
            search.kill()
            search.wait()


def run_all(torch, search) -> int:
    """Phases 1-11 (see the module docstring); ``search`` is the full-depth
    schedule search's process, read by phase 9."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import quant as Q
    from repro_torch.kernels import _build
    from repro_torch.kernels import cim_bsr_matmul as K
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import fake_quant as FQ
    from repro_torch.kernels import quant_matmul as QM
    from repro_torch.kernels import ssd_intra as SI
    from repro_torch.models import registry
    from repro_torch.models.transformer import init_params
    from repro_torch.sched import autotune as AT
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
    kern = (K, FQ, SI, QM, DA)
    mcfg = registry.get_config("mamba2-780m", cim_mode="qat")
    max_err = check_kernels(torch, K, Q, shapes, AT.projection_shapes(
        registry.get_config("yi-6b")))
    max_err["fake_quant"] = check_fake_quant(torch, FQ)
    max_err["ssd_intra_chunk"] = check_ssd_intra(torch, SI, mcfg)
    max_err["quant_matmul"] = check_quant_matmul(torch, QM)
    max_err["decode_attention"] = check_decode_attention(torch, DA, cfg)
    max_err["fake_quant_bwd"] = check_fake_quant_bwd(torch, FQ)
    max_err["ssd_intra_chunk_bwd"] = check_ssd_intra_bwd(torch, SI, mcfg)

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
    counts, scan = serve(torch, kern, cfg, sp)
    sxp = ST.stack(sp)
    plain_path_agreement(torch, kern, cfg, sp, sxp)
    spec_counts, draft = serve_spec(torch, kern, cfg, sp, scan, card)
    counts.update(spec_counts)

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
    sched_counts, sched_tiles = sched(torch, kern, card, search)
    counts.update(sched_counts)
    counts.update(train(torch, kern, card))
    cnn_counts, deploy_err, cnn_rows = cnn(torch, kern, card)
    counts.update(cnn_counts)
    max_err["bsr_matmul"] = max(max_err["bsr_matmul"], deploy_err)

    profile_serve(torch, cfg, sp)
    profile_spec(torch, cfg, sp, draft)
    del draft
    profile_mamba(torch, mcfg, mparams)
    rows = (times(torch, K, Q, sp, sxp)
            + times_mars(torch, K, Q, cfg, sched_tiles
                         + [("the masked path (bn = 8)", (8, 8))])
            + times_mamba(torch, kern, mcfg, mparams)
            + times_quant_matmul(torch, QM, cfg, mlp, bench)
            + times_decode_attention(torch, DA, cfg)
            + times_train(torch, kern, registry.get_config("yi-6b"), mcfg)
            + cnn_rows + times_cnn(torch, kern))
    pick = {"bsr_matmul_stacked": "w_gate decode", "bsr_matmul": "head decode",
            "fake_quant": "fake_quant act prefill",
            "ssd_intra_chunk": "ssd_intra serve",
            "quant_matmul": "quant_matmul w_gate decode",
            "decode_attention": f"decode_attention decode {DA_VIEWS[0]}",
            "fake_quant_bwd": "fake_quant_bwd act train",
            "ssd_intra_chunk_bwd": "ssd_intra_bwd train"}
    source = {"bsr_matmul_stacked": "bsr_matmul.cu",
              "bsr_matmul": "bsr_matmul.cu", "fake_quant": "fake_quant.cu",
              "ssd_intra_chunk": "ssd_intra.cu",
              "quant_matmul": "quant_matmul.cu",
              "decode_attention": "decode_attention.cu",
              "fake_quant_bwd": "fake_quant.cu",
              "ssd_intra_chunk_bwd": "ssd_intra_bwd.cu"}
    replaces = {"bsr_matmul": "src/repro/kernels/cim_bsr_matmul.py:83",
                "bsr_matmul_stacked": "src/repro/kernels/cim_bsr_matmul.py:138",
                "fake_quant": "src/repro/kernels/fake_quant.py:28",
                "ssd_intra_chunk": "src/repro/kernels/ssd_intra.py:47",
                "quant_matmul": "src/repro/kernels/quant_matmul.py:40",
                # no Pallas kernel: the reference's XLA attention of the
                # paged pass (decode_attention_multi)
                "decode_attention": "src/repro/models/layers.py:281",
                # no Pallas kernel: JAX's autodiff of the reference's plain
                # jnp (round_ste and jnp.clip; the SSD's intra-chunk einsum)
                "fake_quant_bwd": "src/repro/core/quant.py:45",
                "ssd_intra_chunk_bwd": "src/repro/models/ssm.py:29"}
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
        if entry in ("bsr_matmul_stacked", "bsr_matmul",
                     "decode_attention"):
            # the entry's timed row that fares worst against its library
            # call, so that a losing row cannot hide behind the picked one
            own = [r for r in rows if r.get("entry") == entry]
            worst = max(own, key=lambda r: r["kernel_ms"] / r["library_ms"])
            kernels[-1].update(
                worst_row=worst["shape"],
                worst_kernel_over_library=worst["kernel_ms"]
                / worst["library_ms"])
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
