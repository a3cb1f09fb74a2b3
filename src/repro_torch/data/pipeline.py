"""Deterministic, checkpointable synthetic data pipelines (numpy).

A copy of the reference's pipelines: the same seed and step give the same
batches, bit for bit.

  * TokenPipeline - order-2 Markov chains over the vocab with Zipfian
    transition tables; each batch is keyed on (seed, step), so a restart
    from a checkpoint replays the exact stream.
  * ImagePipeline - CIFAR-shaped class-conditional patterns + noise for
    the paper's CNN experiments.

State is the step counter and the seed, written into checkpoints.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenPipeline:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    step: int = 0
    order: int = 1

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = min(self.vocab, 512)  # active vocab (keeps tables small)
        probs = rng.zipf(1.5, size=(v, v)).astype(np.float64)
        self._table = probs / probs.sum(1, keepdims=True)
        self._cum = np.cumsum(self._table, axis=1)
        self._v = v

    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def restore(self, state: dict):
        self.step = int(state["step"])
        if int(state["seed"]) != self.seed:
            raise ValueError(f"pipeline seed mismatch: {state['seed']} "
                             f"restored into seed {self.seed}")

    def next_batch(self) -> dict:
        rng = np.random.default_rng((self.seed << 20) ^ self.step)
        u = rng.random((self.batch, self.seq_len))
        toks = np.zeros((self.batch, self.seq_len), np.int64)
        toks[:, 0] = rng.integers(0, self._v, self.batch)
        for t in range(1, self.seq_len):
            toks[:, t] = np.argmax(
                u[:, t, None] < self._cum[toks[:, t - 1]], axis=1
            )
        self.step += 1
        return {"tokens": toks.astype(np.int32)}


@dataclasses.dataclass
class ImagePipeline:
    """Class-conditional frequency patterns: class c has energy at spatial
    frequency (c+1) - linearly separable enough to train, hard enough that
    pruning/quantization accuracy deltas are measurable."""

    n_classes: int = 10
    batch: int = 64
    hw: int = 32
    channels: int = 3
    seed: int = 0
    step: int = 0
    noise: float = 0.35

    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def restore(self, state: dict):
        self.step = int(state["step"])

    def next_batch(self) -> dict:
        rng = np.random.default_rng((self.seed << 20) ^ self.step)
        labels = rng.integers(0, self.n_classes, self.batch)
        xs = np.linspace(0, 2 * np.pi, self.hw, dtype=np.float32)
        xx, yy = np.meshgrid(xs, xs)
        imgs = np.zeros((self.batch, self.hw, self.hw, self.channels),
                        np.float32)
        for i, c in enumerate(labels):
            phase = rng.random() * 2 * np.pi
            base = 0.5 + 0.5 * np.sin((c + 1) * xx + phase) * np.cos(
                (c + 1) * yy)
            for ch in range(self.channels):
                imgs[i, :, :, ch] = base * (
                    0.6 + 0.4 * ch / max(self.channels - 1, 1))
        imgs += rng.standard_normal(imgs.shape).astype(np.float32) * self.noise
        imgs = np.clip(imgs, 0.0, 1.0)
        self.step += 1
        return {"images": imgs, "labels": labels.astype(np.int32)}
