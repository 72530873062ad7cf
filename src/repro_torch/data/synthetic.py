"""Synthetic images (offline container -> procedurally generated data).

The image half of ``repro.data.synthetic``, copied: class-conditional
structured images (per-class smooth random template + localized pattern
+ sample noise), byte-identical to the JAX package's for the same spec
and seed.  Plain numpy; the offload gateway's fleet moves them to the
params' device.  The token half waits for the training slice.
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
