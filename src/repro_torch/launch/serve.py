"""Serving CLI: continuous batching (default) or the static Engine.

  # continuous batching over a synthetic mixed-length trace, on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke \\
      --device cpu

  # weights BSR-compressed with the MARS schedule search's per-projection
  # tiles (sched/, numpy on the host), on the GPU (the default device)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke \\
      --compressed --target-sparsity 0.5

  # ... or with one given tile
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke \\
      --compressed --tile 16x16

  # ... or with the tile the block-sparse kernel runs fastest: the top 3
  # simulated tiles timed on the card, the measurement cached in the
  # artifact's manifest (a later boot reuses it, never re-times)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke \\
      --compressed --autotune 3 --artifact /path/to/yi6b-tuned

  # stacked runtime: one layer-indexed kernel per projection over the
  # uniform envelope, the layer id on the card (tokens equal the loop's)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke \\
      --compressed --tile 16x16 --runtime scan

  # offline artifact: the first run packs + saves, later runs boot from
  # disk (the reference's format: artifacts either side wrote load here)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke \\
      --compressed --tile 16x16 --artifact /path/to/yi6b-artifact

  # self-speculative decode: a 0.9-sparsity draft packing of the SAME
  # weights proposes 4 tokens per target verify (greedy tokens equal
  # target-only decode), or a layer-skip draft over the target's own
  # envelope (no second packing)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke \\
      --compressed --tile 16x16 --spec k=4,draft_sparsity=0.9
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke \\
      --compressed --tile 16x16 --spec draft=layerskip,keep=0.5,k=4

  # --spec auto: family, k and knob from the simulated draft/verify cost
  # and the acceptance calibration stored in the artifact (a spec run with
  # --artifact folds its measured acceptance in); it serves the scan
  # engine when the best candidate models a loss
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke \\
      --compressed --tile 16x16 --artifact /path/to/yi6b-artifact \\
      --spec auto

  # instrumented serve: Perfetto-loadable trace + metrics snapshot of the
  # measured (post-warm-up) run
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke \\
      --compressed --tile 16x16 --runtime scan \\
      --trace-out /tmp/serve-trace.json --metrics-out /tmp/serve-metrics.json

  # macro-sharded serving: every packed projection's block columns split
  # over 4 macros by surviving-block count (on one card), the KV heads too
  # where 4 divides them; the tokens are the unsharded run's
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke \\
      --compressed --tile 16x16 --mesh macro=4

  # static-batch Engine (any family; the ssm, hybrid, encdec and vlm
  # families have no batch-server path and take it without the flag)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \\
      --smoke --engine legacy --batch 4 --prompt-len 16 --new-tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
      --smoke --engine legacy
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \\
      --smoke --engine legacy
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llava-next-34b \\
      --smoke --engine legacy --compressed --tile 16x16 --runtime scan

  # a torch.profiler Chrome trace of the measured run, and the
  # speculative run audited against target-only scan decode
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke \\
      --compressed --tile 16x16 --runtime scan --profile /tmp/serve-prof
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke \\
      --compressed --tile 16x16 --spec draft=layerskip --parity-check

  # multi-tenant gateway: several tenants (artifacts or seeded inits)
  # behind ONE shared KV pool on the device, priced admission, optional
  # mid-run hot-swaps; see the README's "Multi-tenant gateway" for
  # tenants.json
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke \\
      --gateway tenants.json --gateway-parity-check

``repro.launch.serve``'s flags, with the same defaults and the same
numpy-seeded traces and prompts. Weights come from a ``torch.Generator``
seeded by ``--seed`` (other numbers than ``jax.random``'s), or from
``--artifact``. ``--mesh macro=N`` puts its N macros on ``--device``;
``--prefill-device`` takes a CUDA device index (only 0, the pool's own,
on the CPU). ``--profile DIR`` writes a ``torch.profiler`` Chrome trace
(CPU activity, and CUDA on the card) into DIR. Beside the reference's
flags: ``--device`` (default cuda). ``--autotune`` times on that device
and keys its cache ``torch-cuda`` or ``torch-cpu``, so a cache the
reference wrote reads as a miss.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time

import numpy as np
import torch

from ..device import resolve_device
from ..models import registry
from ..obs import MetricsRegistry, Tracer
from ..serve import (BatchConfig, BatchServer, Engine, Request, ServeConfig,
                     deployed, stacked)
from ..serve import spec as spec_mod


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _legacy(args, cfg, params, dev, fns=None) -> np.ndarray:
    """The static Engine over ``--batch`` prompts; the vlm family's patch
    embeddings and the encdec family's frames are the frontend stubs, drawn
    after the tokens from the same numpy stream as the reference CLI's."""
    rng = np.random.default_rng(args.seed)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)),
        dtype=torch.int32, device=dev)}
    stub = {"vlm": ("patch_embeds", cfg.n_patches),
            "encdec": ("frames", cfg.enc_seq)}.get(cfg.family)
    if stub is not None:
        batch[stub[0]] = torch.as_tensor(
            rng.standard_normal((args.batch, stub[1], cfg.d_model)) * 0.02,
            dtype=cfg.param_dtype, device=dev)
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


def _parse_mesh(spec, device=None):
    """'macro=N' -> a macro_mesh(N) on ``device``; '' -> None (one
    macro)."""
    if not spec:
        return None
    from .shardings import macro_mesh
    axis, _, n = spec.partition("=")
    if axis != "macro" or not n.isdigit():
        raise SystemExit(f"--mesh expects macro=N, got {spec!r}")
    return macro_mesh(int(n), device)


def _parse_tile(spec):
    if not spec:
        return None
    bk, _, bn = spec.lower().partition("x")
    if not (bk.isdigit() and bn.isdigit() and int(bk) > 0 and int(bn) > 0):
        raise SystemExit(f"--tile expects BKxBN (e.g. 16x16), got {spec!r}")
    return (int(bk), int(bn))


def _load_calibration(args):
    """The measured acceptance prior stored in the artifact manifest (the
    autotune cache's slot); an empty SpecCalibration when there is none,
    and search_spec then uses the uncalibrated priors."""
    from ..sched.search import SpecCalibration
    stored = None
    if args.artifact:
        try:
            stored = deployed.load_artifact_extra(
                args.artifact).get("spec_calibration")
        except (OSError, ValueError):
            stored = None
    if stored is None:
        return SpecCalibration()
    try:
        cal = SpecCalibration.from_json(stored)
        print(f"spec: loaded acceptance calibration "
              f"({len(cal.rows)} measured row(s)) from the artifact "
              "manifest")
        return cal
    except ValueError as e:
        print(f"spec: stored calibration unusable ({e}) - using "
              "uncalibrated priors")
        return SpecCalibration()


def _parse_spec(arg, cfg, target_sparsity, calibration=None):
    """'k=4,draft_sparsity=0.9' or 'draft=layerskip,keep=0.5,k=4' ->
    SpecConfig; 'auto' picks (family, k, knob) from the simulated cost and
    the calibrated acceptance prior, and returns None (serve the scan
    engine) when even the best candidate models a loss; '' -> None (no
    speculation)."""
    if not arg:
        return None
    if arg == "auto":
        from ..sched import search_spec
        d = search_spec(cfg, target_sparsity=target_sparsity,
                        calibration=calibration, arch=cfg.name).decision
        print("spec auto:", json.dumps(d))
        if d["accept_source"] != "calibrated":
            print(f"spec auto: acceptance {d['accept']} is a MODELED prior "
                  "(sched.search uncalibrated fallback), not a measurement "
                  "- serve one spec run with --artifact and the measured "
                  "rate is persisted for the next pick")
        if d["verdict"] == "declined":
            print(f"spec auto: declined: scan wins (best candidate "
                  f"{d['family']} k={d['k']} models "
                  f"{d['predicted_speedup']}x vs target-only decode) - "
                  "serving the scan engine")
            return None
        print(f"spec auto: serving {d['family']} k={d['k']} "
              f"({'keep' if d['family'] == 'layerskip' else 'draft_sparsity'}"
              f"={d['knob']}, predicted {d['predicted_speedup']}x, "
              f"accept={d['accept']} [{d['accept_source']}])")
        if d["family"] == "layerskip":
            return spec_mod.SpecConfig(k=int(d["k"]), draft="layerskip",
                                       keep=float(d["knob"]))
        return spec_mod.SpecConfig(k=int(d["k"]),
                                   draft_sparsity=float(d["knob"]))
    usage = (f"--spec expects 'auto' or comma-joined k=INT, "
             f"draft=reprune|layerskip, draft_sparsity=FLOAT, keep=FLOAT, "
             f"adaptive_k=0|1, got {arg!r}")
    kw = {}
    for part in arg.split(","):
        key, _, val = part.partition("=")
        key = key.strip()
        try:
            if key == "k":
                kw["k"] = int(val)
            elif key == "draft_sparsity":
                kw["draft_sparsity"] = float(val)
            elif key == "draft":
                kw["draft"] = val.strip()
            elif key == "keep":
                kw["keep"] = float(val)
            elif key == "adaptive_k":
                kw["adaptive_k"] = bool(int(val))
            else:
                raise SystemExit(usage)
        except ValueError:
            raise SystemExit(usage) from None
    try:
        return spec_mod.SpecConfig(**kw)
    except ValueError as e:
        raise SystemExit(f"--spec: {e}") from None


def _run_autotune(args, cfg, dev):
    """Measured-latency tile pick for a fresh pack: the top-N simulated
    tiles, each timed through the stacked block-sparse kernel on ``dev``.
    Returns (AutotuneResult, AutotuneCache); the cache goes into the
    artifact manifest so later boots reuse the measurement."""
    from ..sched import autotune as AT

    cache = AT.AutotuneCache()
    res = AT.autotune(cfg, top_n=args.autotune,
                      target_sparsity=args.target_sparsity, cache=cache,
                      device=dev)
    bk, bn = res.best_tile
    sbk, sbn = res.simulated_tile
    print(f"autotune: measured tile {bk}x{bn} over {len(res.table)} "
          f"candidate(s) on {res.backend} (simulated pick {sbk}x{sbn})")
    for row in res.table:
        print(f"autotune:   tile {row['tile'][0]}x{row['tile'][1]} "
              f"total {row['total_s'] * 1e3:.2f} ms "
              f"(prefill {row['prefill_s'] * 1e3:.2f}, "
              f"decode {row['decode_s'] * 1e3:.2f}; "
              f"sim {row['sim_fps']} fps)")
    return res, cache


def _report_artifact_autotune(cfg, meta, dev):
    """Boot-path cache report: the stored packing is served either way;
    this only says whether the stored autotune measurement covers THIS
    (arch, shapes, backend). Never re-times."""
    from ..sched import autotune as AT

    stored = meta.get("autotune")
    if not stored:
        print("autotune: artifact carries no autotune cache - serving "
              "stored packing unchanged (re-pack with --autotune to tune)")
        return
    try:
        cache = AT.AutotuneCache.from_json(stored)
    except ValueError as e:
        print(f"autotune: stored cache unusable ({e}) - serving stored "
              "packing unchanged")
        return
    hit = cache.get(AT.autotune_key(cfg, AT.backend_name(dev)))
    if hit is None:
        print("autotune: cache MISS for this (arch, shapes, backend) - the "
              "stored packing was tuned elsewhere; serving as stored "
              "(point --artifact at a fresh directory to re-tune here)")
    else:
        bt = hit["best_tile"]
        print(f"autotune: cache hit ({bt[0]}x{bt[1]}, measured on "
              f"{hit.get('backend')}) - boot reuses the measurement, "
              "no re-timing")


def _serving_params(args, cfg, init, dev, spec_cfg=None):
    """Boot the serving weights from ``--artifact`` when it holds one (no
    re-packing, no random init), else build them from ``init()`` - packed
    under ``--compressed`` with ``--tile``, ``--autotune``'s measured tile
    (uniform) or the schedule search's per-projection tiles - and save
    them there. Returns
    (target, draft-or-None, spec_cfg). With a reprune ``spec_cfg`` the
    draft tier rides the same artifact (two-tier): a single-tier artifact
    is upgraded in place (the draft re-packed from the STORED target, then
    re-saved with its manifest extra kept). A stored draft tier is served
    AS STORED: if its sparsity differs from the requested one, the returned
    spec_cfg adopts the stored value so the report names what was served."""
    if args.artifact:
        t0 = time.perf_counter()
        try:
            sp, draft, meta = deployed.load_artifact_tiers(args.artifact,
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
            if args.autotune > 0:
                _report_artifact_autotune(cfg, meta, dev)
            if spec_cfg is None or spec_cfg.draft == "layerskip":
                # the layerskip family drafts with a sublayer subset of the
                # TARGET envelope: no second packing to load or build
                return sp, None, spec_cfg
            if draft is not None:
                stored = meta.get("draft_sparsity")
                if stored is not None and stored != spec_cfg.draft_sparsity:
                    print(f"note: artifact's draft tier was packed at "
                          f"sparsity {stored}, not the requested "
                          f"{spec_cfg.draft_sparsity} - serving it as "
                          "stored (point --artifact at a fresh directory "
                          "to re-pack)")
                    spec_cfg = dataclasses.replace(
                        spec_cfg, draft_sparsity=float(stored))
                return sp, draft, spec_cfg
            t0 = time.perf_counter()
            draft = spec_mod.draft_serving(cfg, sp, spec_cfg.draft_sparsity,
                                           tile=_parse_tile(args.tile))
            out = deployed.save_artifact(
                args.artifact, sp, cfg, draft=draft,
                extra={**meta, "draft_sparsity": spec_cfg.draft_sparsity})
            print(f"artifact: upgraded to two-tier (draft packed at "
                  f"sparsity {spec_cfg.draft_sparsity}) at {out} in "
                  f"{time.perf_counter() - t0:.2f}s")
            return sp, draft, spec_cfg
    at_result = at_cache = schedule = None
    tile = _parse_tile(args.tile)
    if args.compressed and args.autotune > 0 and tile is None:
        at_result, at_cache = _run_autotune(args, cfg, dev)
        tile = at_result.best_tile
    if args.compressed and tile is None:
        t0 = time.perf_counter()
        schedule = deployed.default_schedule(cfg)
        tiles = sorted({s.tile for s in schedule.layers})
        print(f"schedule: searched {len(schedule.layers)} projections in "
              f"{time.perf_counter() - t0:.2f}s, tiles "
              f"{['%dx%d' % t for t in tiles]} (simulated "
              f"{schedule.fps:.2f} fps)")
    params = init()
    t0 = time.perf_counter()
    sp = (deployed.compress(cfg, params, target_sparsity=args.target_sparsity,
                            schedule=schedule, tile=tile,
                            uniform=at_result is not None)
          if args.compressed else deployed.from_params(cfg, params))
    draft = None
    if spec_cfg is not None and spec_cfg.draft == "reprune":
        draft = spec_mod.draft_serving(cfg, sp, spec_cfg.draft_sparsity,
                                       tile=tile)
    _sync(dev)
    print(f"packed in {time.perf_counter() - t0:.2f}s")
    if args.artifact:
        t0 = time.perf_counter()
        extra = {"compressed": args.compressed}
        if draft is not None:
            extra["draft_sparsity"] = spec_cfg.draft_sparsity
        if at_result is not None:
            extra["autotune"] = at_cache.to_json()
            extra["autotune_tile"] = list(at_result.best_tile)
        out = deployed.save_artifact(args.artifact, sp, cfg, draft=draft,
                                     extra=extra)
        print(f"artifact: packed + saved to {out} in "
              f"{time.perf_counter() - t0:.2f}s")
    return sp, draft, spec_cfg


def _batch(args, cfg, init, dev):
    mesh = _parse_mesh(args.mesh, dev)
    calibration = _load_calibration(args) if args.spec else None
    spec_cfg = _parse_spec(args.spec, cfg, args.target_sparsity,
                           calibration=calibration)
    sp, draft, spec_cfg = _serving_params(args, cfg, init, dev, spec_cfg)
    if args.compressed:
        print("compression:", json.dumps(sp.report()))
    if spec_cfg is not None and spec_cfg.draft == "layerskip":
        print(f"spec: layerskip draft over the target envelope, "
              f"keep={spec_cfg.keep}, k={spec_cfg.k} (no second packing)")
    elif spec_cfg is not None:
        print(f"spec: draft tier packed at sparsity "
              f"{spec_cfg.draft_sparsity} "
              f"({json.dumps(draft.report())}), k={spec_cfg.k}")
    if mesh is not None:
        sp = deployed.shard(sp, mesh)
        if draft is not None:
            draft = deployed.shard(draft, mesh)
        n_sharded = sum(1 for dw in sp.deployed().values()
                        if dw.mesh is not None)
        print(f"macro mesh: {mesh.shape} - {n_sharded} projections "
              "column-sharded (rest replicated)")
    bcfg = BatchConfig(n_slots=args.slots, block_size=args.block_size,
                       n_blocks=args.kv_blocks,
                       prefix_cache=not args.no_prefix_cache)
    # a declined --spec auto serves --runtime, as the reference does
    engine = "spec" if spec_cfg is not None else args.runtime
    print(f"runtime: {engine}"
          + {"scan": " (layer-indexed kernels over the stacked envelope, "
                     "the layer id on the card)",
             "loop": " (python loop over per-layer weights)",
             "spec": " (draft-k-verify speculative decode over the stacked "
                     "envelope, greedy-exact)"}[engine])
    scfg = ServeConfig(temperature=args.temperature, seed=args.seed)
    tracer = Tracer() if args.trace_out else None
    metrics = (MetricsRegistry()
               if args.metrics_out or args.trace_out else None)
    srv = BatchServer(cfg, sp, scfg, bcfg,
                      continuous=(args.engine == "batch"), engine=engine,
                      device=dev, mesh=mesh, draft=draft, spec=spec_cfg,
                      tracer=tracer, metrics=metrics)
    if spec_cfg is not None and spec_cfg.draft == "layerskip":
        a_on, m_on = srv.spec_masks
        print(f"spec: layerskip masks attn={list(a_on)} mlp={list(m_on)} "
              f"(executes {spec_mod.kept_fraction(a_on, m_on):.2f} of the "
              "sublayer units; nnz-ranked importance)")
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
    # the warm-up's spans and samples are start-up noise: drop them (the
    # tracer keeps its epoch and track names)
    if tracer is not None:
        tracer.clear()
    if metrics is not None:
        metrics.clear()
    srv.timer.clear()
    with _profiled(args.profile, dev):
        rep = srv.run(trace())
    out = rep.to_json()
    if spec_cfg is not None and args.parity_check:
        # greedy-exactness audit: target-only scan decode over the same
        # trace must emit the same tokens
        ref = BatchServer(cfg, sp, ServeConfig(seed=args.seed), bcfg,
                          continuous=(args.engine == "batch"), engine="scan",
                          device=dev, mesh=mesh).run(trace())
        out["tokens_match_target"] = bool(all(
            np.array_equal(rep.outputs[r.rid], ref.outputs[r.rid])
            for r in trace()))
    if args.prefix_parity_check and rep.prefix is not None:
        # sharing-exactness audit: the same engine with the prefix cache
        # OFF must emit identical tokens over the same trace
        ref = BatchServer(cfg, sp, scfg,
                          dataclasses.replace(bcfg, prefix_cache=False),
                          continuous=(args.engine == "batch"), engine=engine,
                          device=dev, mesh=mesh, draft=draft,
                          spec=spec_cfg).run(trace())
        out["tokens_match_unshared"] = bool(all(
            np.array_equal(rep.outputs[r.rid], ref.outputs[r.rid])
            for r in trace()))
    print(json.dumps(out, indent=1))
    if (spec_cfg is not None and rep.spec is not None
            and rep.spec.get("proposed", 0) > 0):
        # close the calibration loop: fold the MEASURED acceptance into the
        # prior and persist it into the artifact manifest, so the next
        # --spec auto picks from data, not the uncalibrated prior
        gap = (1.0 - spec_cfg.keep if spec_cfg.draft == "layerskip"
               else spec_cfg.draft_sparsity - args.target_sparsity)
        calibration.add(cfg.name, spec_cfg.draft, gap,
                        rep.spec["acceptance_rate"],
                        weight=float(rep.spec["proposed"]))
        if args.artifact:
            deployed.update_artifact_extra(
                args.artifact, {"spec_calibration": calibration.to_json()})
            print(f"spec: measured acceptance "
                  f"{rep.spec['acceptance_rate']} folded into the "
                  f"calibration ({len(calibration.rows)} row(s)) and "
                  "persisted to the artifact manifest")
    for rid in list(rep.outputs)[:3]:
        print(f"  {rid}:", rep.outputs[rid].tolist())
    if tracer is not None:
        tracer.save(args.trace_out)
        print(f"trace: {len(tracer.to_chrome()['traceEvents'])} events -> "
              f"{args.trace_out} (open in Perfetto / chrome://tracing)")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(rep.metrics or {}, f, indent=1)
        print(f"metrics: snapshot -> {args.metrics_out}")
    if args.profile:
        print(f"profile: torch.profiler trace -> {args.profile}")
    return rep


@contextlib.contextmanager
def _profiled(out_dir: str, dev: torch.device):
    """``torch.profiler`` around the measured run (CPU activity, and CUDA
    on the card), its Chrome trace written to ``out_dir/trace.json``; a
    no-op without ``out_dir``."""
    if not out_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))


def _init_params(cfg, seed: int, dev: torch.device):
    fns = registry.model_fns(cfg)
    return fns.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                           device=dev)


def _tenant_cfg_sp(entry, args, dev):
    """One tenants.json entry -> (cfg, ServingParams) on ``dev``. An
    ``artifact`` boots the stored packing (checked against the entry's
    arch and tile); else a seeded init is served dense or uniformly
    compressed."""
    arch = entry.get("arch") or args.arch
    if not arch:
        raise SystemExit(
            f"tenant {entry.get('name')!r}: no 'arch' in tenants.json and "
            "no --arch fallback")
    cfg = (registry.get_smoke_config(arch, dtype=args.dtype) if args.smoke
           else registry.get_config(arch, dtype=args.dtype))
    tile = _parse_tile(entry.get("tile", ""))
    if entry.get("artifact"):
        sp, _, _ = deployed.load_artifact_tiers(
            entry["artifact"], arch=cfg.name, tile=tile, device=dev)
        print(f"gateway: tenant {entry['name']} loaded artifact "
              f"{entry['artifact']} (arch={cfg.name})")
        return cfg, sp
    params = _init_params(cfg, int(entry.get("seed", 0)), dev)
    if entry.get("compressed"):
        sp = deployed.compress(
            cfg, params,
            target_sparsity=float(entry.get("target_sparsity", 0.5)),
            tile=tile if tile else (16, 16), uniform=True)
    else:
        sp = deployed.from_params(cfg, params)
    return cfg, sp


def _gateway(args, dev):
    """Multi-tenant serving: tenants.json -> one Gateway run (and, with
    --gateway-parity-check, each tenant's tokens against a dedicated
    single-tenant scan BatchServer). Returns the GatewayReport."""
    from ..gateway import (AdmissionController, Gateway, GatewayConfig,
                           SwapEvent, TenantRuntime, TenantSLO)
    from ..sched.pricing import Pricer

    with open(args.gateway) as f:
        spec = json.load(f)
    entries = spec.get("tenants")
    if not entries:
        raise SystemExit(f"{args.gateway}: no 'tenants' list")
    tenants, swaps, traces = [], [], {}
    for i, entry in enumerate(entries):
        name = entry.get("name")
        if not name:
            raise SystemExit(f"{args.gateway}: tenants[{i}] has no 'name'")
        cfg, sp = _tenant_cfg_sp(entry, args, dev)
        tenants.append(TenantRuntime(
            name, cfg, sp, priority=int(entry.get("priority", 0)),
            slo=TenantSLO.from_json(entry.get("slo")),
            sparsity=float(entry.get("sparsity", 0.0)),
            artifact=entry.get("artifact", "")))
        n_req = int(entry.get("requests", args.requests))
        reqs = synthetic_trace(cfg, n_req, args.prompt_len, args.new_tokens,
                               seed=args.seed + i)
        deadline_s = entry.get("deadline_s")
        traces[name] = [dataclasses.replace(
            r, rid=f"{name}-{r.rid}", tenant=name,
            priority=int(entry.get("priority", 0)),
            deadline=(r.arrival + float(deadline_s)
                      if deadline_s is not None else None))
            for r in reqs]
        hs = entry.get("hot_swap")
        if hs:
            if hs.get("artifact"):
                sp2, _, _ = deployed.load_artifact_tiers(
                    hs["artifact"], arch=cfg.name, device=dev)
            else:
                sp2 = _tenant_cfg_sp(
                    {**entry, "seed": hs.get("reseed", 1),
                     "artifact": "", "tile": hs.get("tile",
                                                    entry.get("tile", ""))},
                    args, dev)[1]
            swaps.append(SwapEvent(at_step=int(hs.get("at_step", 1)),
                                   tenant=name, sp=sp2))
    gspec = spec.get("gateway", {})
    gcfg = GatewayConfig(
        n_slots=int(gspec.get("n_slots", args.slots)),
        block_size=int(gspec.get("block_size", args.block_size)),
        n_blocks=int(gspec.get("n_blocks", args.kv_blocks)),
        prefill_chunk=int(gspec.get("prefill_chunk", args.prefill_chunk)),
        prefill_device=gspec.get("prefill_device", args.prefill_device),
        max_backlog_s=float(gspec.get("max_backlog_s", args.max_backlog_s)),
        max_pending=(int(gspec["max_pending"]) if "max_pending" in gspec
                     else args.max_pending))
    controller = AdmissionController(pricer=Pricer(),
                                     max_backlog_s=gcfg.max_backlog_s)
    gw = Gateway(tenants, gcfg, ServeConfig(seed=args.seed),
                 controller=controller, device=dev)
    all_reqs = [r for reqs in traces.values() for r in reqs]
    print(f"gateway: {len(tenants)} tenant(s) "
          f"({', '.join(t.name for t in tenants)}), {len(all_reqs)} "
          f"request(s), one shared pool of {gcfg.n_blocks} blocks")
    rep = gw.run(all_reqs, swaps=swaps)
    for ev in rep.shed:
        print(f"gateway: shed rid={ev['rid']} tenant={ev['tenant']} "
              f"priority={ev['priority']} reason={ev['reason']}")
    out = rep.to_json()
    if args.gateway_parity_check:
        # per-tenant exactness audit: each tenant's gateway tokens against
        # a dedicated single-tenant BatchServer over the same requests
        swapped = {ev.tenant for ev in swaps}
        for t in tenants:
            if t.name in swapped:
                # pre-swap tokens came from weights the tenant no longer
                # holds - a re-serve afterwards cannot reproduce them
                print(f"gateway: tenant={t.name} "
                      "tokens_match_dedicated=skipped(hot-swap)")
                continue
            served = rep.per_tenant[t.name].outputs
            bcfg = BatchConfig(n_slots=gcfg.n_slots,
                               block_size=gcfg.block_size,
                               n_blocks=gcfg.n_blocks)
            ded = BatchServer(t.cfg, t.sp, ServeConfig(seed=args.seed),
                              bcfg, engine="scan", device=dev).run(
                [Request(r.rid, r.prompt, r.max_new_tokens)
                 for r in traces[t.name] if r.rid in served])
            match = bool(all(np.array_equal(served[rid], o)
                             for rid, o in ded.outputs.items()))
            out.setdefault("parity", {})[t.name] = match
            print(f"gateway: tenant={t.name} "
                  f"tokens_match_dedicated={match}")
    print(json.dumps(out, indent=1))
    return rep


def main(argv=None):
    """Parse ``argv`` and serve. Returns the measured ``ServeReport``
    (``--engine batch|static``), the generated (batch, new_tokens) array
    (``--engine legacy``) or the ``GatewayReport`` (``--gateway``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="",
                    help="registry architecture (required unless --gateway "
                    "names per-tenant arches)")
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
    ap.add_argument("--spec", default="",
                    help="speculative decode: 'auto' (family, k and knob "
                    "from the simulated cost and the artifact's measured "
                    "acceptance; scan when spec models a loss) or "
                    "comma-joined k=INT, "
                    "draft=reprune|layerskip, draft_sparsity=FLOAT (reprune "
                    "knob: packs a second higher-sparsity tier), keep=FLOAT "
                    "(layerskip knob: the draft runs the nnz-ranked top keep "
                    "fraction of the TARGET envelope's sublayers - no "
                    "second packing), adaptive_k=0|1")
    ap.add_argument("--parity-check", action="store_true",
                    help="with --spec: also run target-only scan decode "
                    "over the trace and report tokens_match_target (the "
                    "greedy exactness contract)")
    ap.add_argument("--artifact", default="",
                    help="serving-artifact directory: boot from it when it "
                    "exists (no re-packing), else pack once and save there")
    ap.add_argument("--tile", default="",
                    help="BKxBN packing tile (e.g. 16x16); without it "
                    "--compressed packs with the schedule search's "
                    "per-projection tiles (or --autotune's measured one)")
    ap.add_argument("--autotune", type=int, default=0, metavar="TOPN",
                    help="with --compressed and no --tile: time the top-TOPN "
                    "simulated tiles through the stacked block-sparse "
                    "kernel on --device and pack (uniform) with the "
                    "measured winner; the measurement is cached in the "
                    "--artifact manifest and a boot reuses it")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome trace-event JSON of the measured "
                    "run (phase spans, request lifecycle tracks, occupancy "
                    "counters) - open in Perfetto / chrome://tracing")
    ap.add_argument("--metrics-out", default="",
                    help="write the measured run's metrics snapshot "
                    "(counters/gauges/phase histograms + fenced dispatch "
                    "table) as JSON")
    ap.add_argument("--profile", default="",
                    help="directory for a torch.profiler Chrome trace of "
                    "the measured run (CPU activity, and CUDA on the card)")
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
    ap.add_argument("--mesh", default="",
                    help="macro=N: shard compressed projections column-wise "
                    "over N macros on --device (balanced by surviving "
                    "blocks) and the paged-KV views by head where N divides "
                    "the KV heads; the tokens do not change")
    ap.add_argument("--gateway", default="", metavar="TENANTS_JSON",
                    help="multi-tenant gateway mode: serve the tenants "
                    "described in TENANTS_JSON behind one shared KV pool "
                    "with simulator-priced admission (see the README's "
                    "'Multi-tenant gateway' for the schema)")
    ap.add_argument("--gateway-parity-check", action="store_true",
                    help="with --gateway: re-serve each tenant's requests "
                    "on a dedicated single-tenant scan server and report "
                    "tokens_match_dedicated")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="gateway: advance pending prefills at most N "
                    "tokens per step, interleaved with decode rounds "
                    "(0 = whole prompt at admission)")
    ap.add_argument("--prefill-device", type=int, default=None,
                    help="gateway: run the prefill dispatches on this CUDA "
                    "device index (prefill/decode disaggregation)")
    ap.add_argument("--max-backlog-s", type=float, default=float("inf"),
                    help="gateway: shed (lowest-priority-first) once the "
                    "simulator-predicted backlog exceeds this many seconds")
    ap.add_argument("--max-pending", type=int, default=None,
                    help="gateway: bound the request queue; overflow sheds "
                    "the lowest-priority pending request (counted, never "
                    "silent)")
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
    if not args.arch and not args.gateway:
        ap.error("--arch is required (unless --gateway names per-tenant "
                 "arches)")

    dev = resolve_device(args.device)
    if args.gateway:
        return _gateway(args, dev)
    cfg = (registry.get_smoke_config(args.arch, dtype=args.dtype)
           if args.smoke else registry.get_config(args.arch, dtype=args.dtype))
    init = lambda: _init_params(cfg, args.seed, dev)

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
    sp, _, _ = _serving_params(args, cfg, init, dev)
    print("compression:", json.dumps(sp.report()))
    if args.runtime == "scan":
        return _legacy(args, cfg, stacked.stack(sp), dev,
                       fns=stacked.model_fns(cfg))
    return _legacy(args, cfg, sp, dev, fns=deployed.model_fns(cfg))


if __name__ == "__main__":
    main()
