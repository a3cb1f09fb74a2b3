"""The training entry point on one device: MARS QAT + group lasso when
asked, with checkpoint/resume that replays the exact data stream,
SIGTERM-safe.

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \\
      --steps 50 --batch 8 --seq 64 --ckpt-dir CKPT [--resume] [--cim] \\
      [--device cpu]

The reference's flags (``repro/launch/train.py``), one for one, plus
``--device`` (default cuda: without a GPU it raises unless ``--device
cpu`` is given). Every family whose batch is tokens alone trains here:
dense, moe, ssm and hybrid. The encdec and vlm families' losses also read
stub frames / patch embeddings, which ``TokenPipeline`` does not make
(the reference's CLI fails at its first step); the CLI refuses them
before it builds a state, and they train through
``trainer.make_train_step`` with those inputs. The reference's mesh and
shardings are not ported: one device. ``--ckpt-dir`` defaults to a
directory under the system's temporary directory. The log lines are the
reference's. ``main`` also returns a :class:`TrainRun` (the final state
and each step's loss and host seconds; the loss is read every step, which
ends each step on the device).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import signal
import sys
import tempfile
import time
from typing import List, Optional

import torch

from ..data import TokenPipeline
from ..device import resolve_device
from ..models import registry
from ..train import checkpoint as ckpt
from ..train import optimizer as optim
from ..train.trainer import TrainConfig, init_train_state, make_train_step


# the families whose train_loss reads an input besides the tokens
BATCH_INPUTS = {"encdec": "frames", "vlm": "patch_embeds"}


@dataclasses.dataclass
class TrainRun:
    state: dict
    start_step: int
    losses: List[float]      # CE of each step run, in order
    step_s: List[float]      # host seconds of each step, loss read included


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--opt", choices=["adamw", "sgdm"], default="adamw")
    ap.add_argument("--cim", action="store_true",
                    help="enable MARS QAT + group lasso (the paper's "
                         "technique)")
    ap.add_argument("--w-bits", type=int, default=8)
    ap.add_argument("--a-bits", type=int, default=8)
    ap.add_argument("--lambda-g", type=float, default=1e-5)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return ap


def main(argv: Optional[List[str]] = None) -> TrainRun:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    over = dict(dtype=args.dtype)
    if args.cim:
        over.update(cim_mode="qat", w_bits=args.w_bits, a_bits=args.a_bits,
                    lambda_g=args.lambda_g, cim_alpha=16, cim_n=16)
    cfg = (registry.get_smoke_config(args.arch, **over) if args.smoke
           else registry.get_config(args.arch, **over))
    if cfg.family in BATCH_INPUTS:
        raise ValueError(
            f"--arch {args.arch}: the {cfg.family} family's loss reads "
            f"batch[{BATCH_INPUTS[cfg.family]!r}], which this CLI's "
            "TokenPipeline (tokens alone) does not make; train it through "
            "repro_torch.train.trainer.make_train_step with that input")
    tcfg = TrainConfig(
        opt=optim.OptConfig(kind=args.opt, lr=args.lr, warmup_steps=10,
                            total_steps=args.steps),
        grad_accum=args.grad_accum,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
    )

    pipe = TokenPipeline(vocab=cfg.vocab, batch=args.batch, seq_len=args.seq,
                         seed=args.seed)
    state = init_train_state(
        cfg, tcfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    start_step = 0
    if args.resume and ckpt.latest_step(args.ckpt_dir) is not None:
        state, manifest = ckpt.restore(args.ckpt_dir, state)
        pipe.restore(manifest["extra"]["pipe"])
        start_step = manifest["step"]
        print(f"resumed from step {start_step}")

    step_fn = make_train_step(cfg, tcfg)
    stop = {"flag": False}
    previous = signal.signal(signal.SIGTERM,
                             lambda *_: stop.update(flag=True))
    run = TrainRun(state, start_step, [], [])
    try:
        t0 = last = time.time()
        for i in range(start_step, args.steps):
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in pipe.next_batch().items()}
            state, metrics = step_fn(state, batch)
            run.losses.append(float(metrics["loss"]))  # ends the step
            now = time.time()
            run.step_s.append(now - last)
            last = now
            if (i + 1) % args.log_every == 0 or i == start_step:
                print(f"step {i+1} loss={run.losses[-1]:.4f} "
                      f"lr={float(metrics['lr']):.2e} "
                      f"gnorm={float(metrics['grad_norm']):.2f} "
                      f"({now - t0:.1f}s)", flush=True)
            if ((i + 1) % tcfg.ckpt_every == 0 or stop["flag"]
                    or i + 1 == args.steps):
                ckpt.save(tcfg.ckpt_dir, i + 1, state,
                          extra={"pipe": pipe.state(), "arch": args.arch},
                          keep=tcfg.ckpt_keep)
            if stop["flag"]:
                print("SIGTERM received: checkpointed and exiting cleanly")
                sys.exit(0)
        if run.losses:
            print(f"done: {args.steps} steps in {time.time()-t0:.1f}s; "
                  f"final loss {run.losses[-1]:.4f}")
    finally:
        signal.signal(signal.SIGTERM, previous)
    run.state = state
    return run


if __name__ == "__main__":
    main()
