#!/usr/bin/env python3
"""Time the paged decode step of full-width yi-6b at serving context lengths
on one NVIDIA GPU.

    python3 tools/bench_paged_decode.py [--src DIR] [--label NAME]
        [--layers 32] [--pack-layers 1] [--contexts 1024,2048,4096]
        [--steps 20] [--profile-steps 5] [--seed 0]

Builds yi-6b at full width in bf16 with random weights from ``--seed``,
compresses ``--pack-layers`` layers on the host (uniform 128x128 tile, 60%
tile sparsity, as chip_smoke.py does) and repeats them up to ``--layers``
layers: the stacked envelope then has the depth of the real model, and every
layer does the work of a real one (its weights repeat the first layers').
For each context length C it times ``serve.stacked.decode_step_paged``, the
scan runtime's decode step, for 4 slots all at position C - 1 over random
bf16 K/V views of C positions: the median of ``--steps`` steps by CUDA
events and by the host clock (each step synchronized), the 4 slots'
tokens per second that the host time allows, and the device's busy time
per step from torch.profiler (the sum of its kernels' own device time over
``--profile-steps`` steps; host noise does not reach it).

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (default:
this checkout's), so one script times two trees of the package, e.g. a
parent commit unpacked beside the working tree, in one call on one card.
Prints the card's name and power limit, then one JSON line per context.
Exits 2 without a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

SLOTS = 4
TILE = (128, 128)
SPARSITY = 0.6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--pack-layers", type=int, default=1)
    ap.add_argument("--contexts", default="1024,2048,4096")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--profile-steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("bench_paged_decode: no CUDA device", file=sys.stderr)
        return 2
    if args.layers % args.pack_layers:
        ap.error("--layers must be a multiple of --pack-layers")
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.models import registry
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import deployed as DP
    from repro_torch.serve import stacked as ST

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = "cuda"
    pcfg = registry.get_config("yi-6b", n_layers=args.pack_layers)
    cfg = registry.get_config("yi-6b", n_layers=args.layers)
    params = init_params(pcfg, torch.Generator(device=dev).manual_seed(
        args.seed))
    t0 = time.perf_counter()
    sp = DP.compress(pcfg, params, target_sparsity=SPARSITY, tile=TILE,
                     uniform=True)
    del params
    pack_s = time.perf_counter() - t0
    reps = args.layers // args.pack_layers
    sxp = ST.stack(DP.ServingParams(
        embed=sp.embed, final_ln=sp.final_ln, layers=sp.layers * reps,
        head=sp.head, head_t=sp.head_t))
    del sp
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    toks = torch.randint(0, cfg.vocab, (SLOTS, 1), generator=gen, device=dev,
                         dtype=torch.int32)
    for ctx in (int(c) for c in args.contexts.split(",")):
        shape = (cfg.n_layers, SLOTS, ctx, cfg.n_kv_heads, cfg.dh)
        vk, vv = (torch.randn(shape, generator=gen, device=dev).to(
            cfg.param_dtype) for _ in range(2))
        pos = torch.full((SLOTS,), ctx - 1, dtype=torch.int32, device=dev)
        step = lambda: ST.decode_step_paged(sxp, vk, vv, pos, toks, cfg)
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        ev, host = [], []
        for _ in range(args.steps):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            s.record()
            step()
            e.record()
            e.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
            ev.append(s.elapsed_time(e))
        host_ms = statistics.median(host)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.profile_steps):
                step()
            torch.cuda.synchronize()
        busy_us = sum(getattr(e, "self_device_time_total", 0.0)
                      for e in prof.key_averages())
        print(json.dumps({
            "bench": "paged_decode_step", "tree": args.label,
            "arch": "yi-6b", "layers": cfg.n_layers, "slots": SLOTS,
            "context": ctx, "tile": list(TILE), "sparsity": SPARSITY,
            "pack_s": pack_s, "step_ms_events": statistics.median(ev),
            "step_ms_host": host_ms,
            "tokens_per_s": SLOTS / (host_ms / 1e3),
            "device_busy_ms_per_step": (busy_us / 1e3 / args.profile_steps
                                        if busy_us else "not measured"),
            "card": card}),
            flush=True)
        del vk, vv
    return 0


if __name__ == "__main__":
    sys.exit(main())
