"""Serving CLI: continuous batching (default) or the static Engine.

  # continuous batching over a synthetic mixed-length trace, on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke \\
      --device cpu

  # weights BSR-compressed with one tile, on the GPU (the default device)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke \\
      --compressed --tile 16x16 --target-sparsity 0.5

  # stacked runtime: one layer-indexed kernel per projection over the
  # uniform envelope, the layer id on the card (tokens equal the loop's)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke \\
      --compressed --tile 16x16 --runtime scan

  # offline artifact: the first run packs + saves, later runs boot from
  # disk (the reference's format: artifacts either side wrote load here)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke \\
      --compressed --tile 16x16 --artifact /path/to/yi6b-artifact

  # static-batch Engine (dense and ssm families)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \\
      --smoke --engine legacy --batch 4 --prompt-len 16 --new-tokens 32

The subset of ``repro.launch.serve`` whose modules are ported, with the
same defaults and the same numpy-seeded traces and prompts. Weights come
from a ``torch.Generator`` seeded by ``--seed`` (other numbers than
``jax.random``'s), or from ``--artifact``. Not ported yet, so argparse
refuses them: ``--spec``, ``--parity-check``, ``--mesh``, ``--autotune``,
``--trace-out``, ``--metrics-out``, ``--profile``, ``--gateway``,
``--gateway-parity-check``, ``--prefill-chunk``, ``--prefill-device``,
``--max-backlog-s``, ``--max-pending``. ``--compressed`` needs ``--tile``:
the schedule search that picks a tile otherwise is not ported. Beside the
reference's flags: ``--device`` (default cuda).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from ..device import resolve_device
from ..models import registry
from ..serve import (BatchConfig, BatchServer, Engine, Request, ServeConfig,
                     deployed, stacked)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _legacy(args, cfg, params, dev, fns=None) -> np.ndarray:
    rng = np.random.default_rng(args.seed)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)),
        dtype=torch.int32, device=dev)}
    eng = Engine(cfg, params, ServeConfig(max_new_tokens=args.new_tokens,
                                          temperature=args.temperature,
                                          seed=args.seed), fns=fns)
    t0 = time.perf_counter()
    out = eng.generate(batch)
    dt = time.perf_counter() - t0
    tps = args.batch * out.shape[1] / dt
    print(f"generated {out.shape} in {dt:.2f}s ({tps:.1f} tok/s)")
    for row in out[: min(4, args.batch)]:
        print("  ", row.tolist())
    return out


def synthetic_trace(cfg, n_requests: int, max_prompt: int, max_new: int,
                    seed: int = 0, long_every: int = 4):
    """Mixed-length trace: every ``long_every``-th request decodes the full
    ``max_new`` tokens, the rest draw short lengths - the skew that makes
    static batching idle its lanes."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n_requests):
        plen = int(rng.integers(2, max(3, max_prompt)))
        n_new = max_new if i % long_every == 0 else int(
            rng.integers(1, max(2, max_new // 6)))
        reqs.append(Request(f"r{i}", rng.integers(0, cfg.vocab, plen), n_new))
    return reqs


def prefix_skew_trace(cfg, n_requests: int, shared_len: int, suffix_max: int,
                      max_new: int, seed: int = 0,
                      shared_frac: float = 0.9):
    """Prefix-skewed trace: ``shared_frac`` of the requests open with the
    SAME ``shared_len``-token prefix and a short unique suffix, the rest are
    unique prompts of comparable length. Which requests share is fixed
    (position mod 10), so the hit rate is a property of the trace."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, cfg.vocab, shared_len).astype(np.int32)
    cut = int(round(shared_frac * 10))
    reqs = []
    for i in range(n_requests):
        if i % 10 < cut:
            sfx = rng.integers(0, cfg.vocab,
                               int(rng.integers(1, max(2, suffix_max + 1))))
            p = np.concatenate([system, sfx.astype(np.int32)])
        else:
            p = rng.integers(0, cfg.vocab,
                             shared_len + max(1, suffix_max // 2)
                             ).astype(np.int32)
        reqs.append(Request(f"r{i}", p, max_new))
    return reqs


def _parse_tile(spec):
    if not spec:
        return None
    bk, _, bn = spec.lower().partition("x")
    if not (bk.isdigit() and bn.isdigit() and int(bk) > 0 and int(bn) > 0):
        raise SystemExit(f"--tile expects BKxBN (e.g. 16x16), got {spec!r}")
    return (int(bk), int(bn))


def _serving_params(args, cfg, init, dev) -> deployed.ServingParams:
    """Boot the serving weights from ``--artifact`` when it holds one (no
    re-packing, no random init), else build them from ``init()`` - packed
    with ``--tile`` under ``--compressed`` - and save them there. A stored
    draft tier is left unused: speculative decoding is not ported."""
    if args.artifact:
        t0 = time.perf_counter()
        try:
            sp, _, meta = deployed.load_artifact_tiers(args.artifact,
                                                       device=dev)
        except FileNotFoundError:
            sp = None
        if sp is not None:
            _sync(dev)
            if meta.get("arch") not in (None, cfg.name):
                raise SystemExit(
                    f"--artifact {args.artifact} holds arch "
                    f"{meta.get('arch')!r}, not {cfg.name!r} - point it at a "
                    "fresh directory to re-pack")
            if bool(meta.get("compressed", args.compressed)) != args.compressed:
                print(f"note: artifact was saved with compressed="
                      f"{meta.get('compressed')} - serving it as stored "
                      "(packing flags only apply when building)")
            print(f"artifact: loaded {args.artifact} "
                  f"(arch={meta.get('arch')}, no re-packing) in "
                  f"{time.perf_counter() - t0:.2f}s")
            return sp
    tile = _parse_tile(args.tile)
    if args.compressed and tile is None:
        raise SystemExit(
            "--compressed needs --tile BKxBN here: the schedule search that "
            "picks the tile otherwise (sched/) is not ported yet")
    params = init()
    t0 = time.perf_counter()
    sp = (deployed.compress(cfg, params, target_sparsity=args.target_sparsity,
                            tile=tile)
          if args.compressed else deployed.from_params(cfg, params))
    _sync(dev)
    print(f"packed in {time.perf_counter() - t0:.2f}s")
    if args.artifact:
        t0 = time.perf_counter()
        out = deployed.save_artifact(args.artifact, sp, cfg,
                                     extra={"compressed": args.compressed})
        print(f"artifact: packed + saved to {out} in "
              f"{time.perf_counter() - t0:.2f}s")
    return sp


def _batch(args, cfg, init, dev):
    sp = _serving_params(args, cfg, init, dev)
    if args.compressed:
        print("compression:", json.dumps(sp.report()))
    bcfg = BatchConfig(n_slots=args.slots, block_size=args.block_size,
                       n_blocks=args.kv_blocks,
                       prefix_cache=not args.no_prefix_cache)
    print(f"runtime: {args.runtime}"
          + {"scan": " (layer-indexed kernels over the stacked envelope, "
                     "the layer id on the card)",
             "loop": " (python loop over per-layer weights)"}[args.runtime])
    scfg = ServeConfig(temperature=args.temperature, seed=args.seed)
    srv = BatchServer(cfg, sp, scfg, bcfg,
                      continuous=(args.engine == "batch"),
                      engine=args.runtime, device=dev)
    if args.shared_prefix > 0:
        # align the shared span up to a block multiple: the trie matches in
        # whole blocks
        shared_len = -(-args.shared_prefix // args.block_size) \
            * args.block_size
        trace = lambda: prefix_skew_trace(
            cfg, args.requests, shared_len, max(2, args.block_size // 2),
            args.new_tokens, seed=args.seed)
    else:
        trace = lambda: synthetic_trace(cfg, args.requests, args.prompt_len,
                                        args.new_tokens, seed=args.seed)
    srv.run(trace())  # warm-up: kernel libraries, allocator
    rep = srv.run(trace())
    out = rep.to_json()
    if args.prefix_parity_check and rep.prefix is not None:
        # sharing-exactness audit: the same engine with the prefix cache
        # OFF must emit identical tokens over the same trace
        ref = BatchServer(cfg, sp, scfg,
                          dataclasses.replace(bcfg, prefix_cache=False),
                          continuous=(args.engine == "batch"),
                          engine=args.runtime, device=dev).run(trace())
        out["tokens_match_unshared"] = bool(all(
            np.array_equal(rep.outputs[r.rid], ref.outputs[r.rid])
            for r in trace()))
    print(json.dumps(out, indent=1))
    for rid in list(rep.outputs)[:3]:
        print(f"  {rid}:", rep.outputs[rid].tolist())
    return rep


def main(argv=None):
    """Parse ``argv`` and serve. Returns the measured ``ServeReport``
    (``--engine batch|static``) or the generated (batch, new_tokens) array
    (``--engine legacy``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, help="registry architecture")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--engine", choices=["batch", "static", "legacy"],
                    default="batch",
                    help="batch = continuous batching (default); static = "
                    "same server, whole-batch admission; legacy = Engine")
    ap.add_argument("--compressed", action="store_true",
                    help="serve deploy_weight-packed (BSR) projections")
    ap.add_argument("--runtime", choices=["loop", "scan"], default="loop",
                    help="loop = python loop over per-layer weights; scan = "
                    "layer-indexed kernels over the stacked uniform envelope "
                    "(identical tokens)")
    ap.add_argument("--artifact", default="",
                    help="serving-artifact directory: boot from it when it "
                    "exists (no re-packing), else pack once and save there")
    ap.add_argument("--tile", default="",
                    help="BKxBN packing tile (e.g. 16x16); required with "
                    "--compressed unless --artifact boots a packing")
    ap.add_argument("--shared-prefix", type=int, default=0, metavar="N",
                    help="serve a prefix-skewed trace: 90%% of requests "
                    "share an N-token system prompt (aligned up to a block "
                    "multiple) plus a short unique suffix")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable radix-tree prefix KV reuse (default on; "
                    "tokens are identical either way)")
    ap.add_argument("--prefix-parity-check", action="store_true",
                    help="also serve the trace with the prefix cache OFF "
                    "and report tokens_match_unshared")
    ap.add_argument("--target-sparsity", type=float, default=0.5)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--kv-blocks", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu (the "
                    "kernels' plain PyTorch versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (registry.get_smoke_config(args.arch, dtype=args.dtype)
           if args.smoke else registry.get_config(args.arch, dtype=args.dtype))
    fns = registry.model_fns(cfg)
    init = lambda: fns.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)

    use_legacy = args.engine == "legacy"
    if not use_legacy and cfg.family not in ("dense", "moe"):
        print(f"note: no batch-server path for the {cfg.family} family yet; "
              "falling back to the legacy Engine")
        use_legacy = True
    if not use_legacy:
        return _batch(args, cfg, init, dev)
    if not args.compressed:
        # uncompressed legacy serving runs the registry's forward; both
        # --runtime values coincide
        return _legacy(args, cfg, init(), dev)
    sp = _serving_params(args, cfg, init, dev)
    print("compression:", json.dumps(sp.report()))
    if args.runtime == "scan":
        return _legacy(args, cfg, stacked.stack(sp), dev,
                       fns=stacked.model_fns(cfg))
    return _legacy(args, cfg, sp, dev, fns=deployed.model_fns(cfg))


if __name__ == "__main__":
    main()
