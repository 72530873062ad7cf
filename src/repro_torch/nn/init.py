"""Weight initializers drawn from a ``torch.Generator``.

The generator lives on the CPU, so one seed gives the same weights
whatever device they are moved to afterwards.  The draws differ from
``jax.random``'s for the same seed: tests that compare the two packages
move the JAX weights over with ``repro_torch.bridge`` instead.
"""
from __future__ import annotations

import math

import torch


def _truncated_normal(gen: torch.Generator, shape, std: float) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=gen)
    return std * t


def lecun_normal(gen: torch.Generator, shape, fan_in: int | None = None):
    fan = fan_in if fan_in is not None else shape[0]
    return _truncated_normal(gen, shape, 1.0 / math.sqrt(max(1, fan)))


def he_normal(gen: torch.Generator, shape, fan_in: int | None = None):
    fan = fan_in if fan_in is not None else shape[0]
    return _truncated_normal(gen, shape, math.sqrt(2.0 / max(1, fan)))


def normal(gen: torch.Generator, shape, std: float = 0.02):
    return std * torch.randn(shape, generator=gen, dtype=torch.float32)
