"""Synthetic datasets (offline container -> procedurally generated data).

A copy of ``repro.data.synthetic``, byte-identical to the JAX package's
batches for the same spec and seed.  Plain numpy; the callers move the
batches to their device.

Images: class-conditional structured images (per-class smooth random
template + localized pattern + sample noise).

Tokens: a mixture of per-sequence Markov chains, so next-token loss has
learnable structure for the LM training path.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ImageDatasetSpec:
    n_classes: int = 10
    image_size: int = 32
    noise: float = 0.35
    seed: int = 0


class SyntheticImages:
    """Deterministic, infinite class-conditional image sampler."""

    def __init__(self, spec: ImageDatasetSpec):
        self.spec = spec
        rng = np.random.RandomState(spec.seed)
        s, c = spec.image_size, spec.n_classes
        # smooth low-frequency per-class templates
        low = rng.randn(c, 8, 8, 3).astype(np.float32)
        self.templates = np.stack([
            _upsample(low[i], s) for i in range(c)], axis=0)
        # localized high-frequency signature per class
        self.freqs = rng.uniform(1.0, 4.0, size=(c, 2)).astype(np.float32)
        xx, yy = np.meshgrid(np.linspace(0, np.pi * 2, s),
                             np.linspace(0, np.pi * 2, s))
        self.xx, self.yy = xx.astype(np.float32), yy.astype(np.float32)

    def batch(self, batch_size: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
        rng = np.random.RandomState(seed)
        spec = self.spec
        labels = rng.randint(0, spec.n_classes, size=batch_size)
        imgs = self.templates[labels].copy()
        for i, y in enumerate(labels):
            fx, fy = self.freqs[y]
            wave = 0.5 * np.sin(fx * self.xx + fy * self.yy)
            imgs[i] += wave[..., None]
        imgs += spec.noise * rng.randn(*imgs.shape).astype(np.float32)
        return imgs.astype(np.float32), labels.astype(np.int32)

    def epoch(self, n_batches: int, batch_size: int, *, base_seed: int = 0):
        for i in range(n_batches):
            yield self.batch(batch_size, base_seed * 10_000 + i)


def _upsample(img: np.ndarray, size: int) -> np.ndarray:
    """Nearest+smooth upsample of (h, w, c) to (size, size, c)."""
    h = img.shape[0]
    rep = size // h
    up = np.repeat(np.repeat(img, rep, axis=0), rep, axis=1)
    # light box blur for smoothness
    k = rep
    pad = np.pad(up, ((k, k), (k, k), (0, 0)), mode="edge")
    out = np.zeros_like(up)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            out += pad[k + dy:k + dy + size, k + dx:k + dx + size]
    return (out / 9.0).astype(np.float32)


@dataclasses.dataclass
class TokenDatasetSpec:
    vocab: int = 512
    seq_len: int = 128
    n_modes: int = 8
    seed: int = 0


class SyntheticTokens:
    """Mixture-of-Markov-chains language data."""

    def __init__(self, spec: TokenDatasetSpec):
        self.spec = spec
        rng = np.random.RandomState(spec.seed)
        # sparse-ish transition matrices per mode
        trans = rng.dirichlet(np.ones(spec.vocab) * 0.05,
                              size=(spec.n_modes, spec.vocab))
        self.trans = trans.astype(np.float64)

    def batch(self, batch_size: int, seed: int) -> np.ndarray:
        rng = np.random.RandomState(seed)
        spec = self.spec
        out = np.zeros((batch_size, spec.seq_len), np.int32)
        modes = rng.randint(0, spec.n_modes, size=batch_size)
        state = rng.randint(0, spec.vocab, size=batch_size)
        out[:, 0] = state
        for t in range(1, spec.seq_len):
            for b in range(batch_size):
                p = self.trans[modes[b], state[b]]
                state[b] = rng.choice(spec.vocab, p=p)
            out[:, t] = state
        return out
