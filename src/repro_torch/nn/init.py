"""Weight initializers drawn from a ``torch.Generator``.

A tensor is drawn in float32 on the generator's device, then cast to
``dtype`` and moved to ``device`` (the generator's when None) before the
caller draws the next one, so a model in bf16 never holds its float32
draws at once.  A CPU generator gives the same weights whatever device
they are moved to; a CUDA generator draws other numbers for the same
seed.  The draws differ from ``jax.random``'s for the same seed: tests
that compare the two packages move the JAX weights over with
``repro_torch.bridge`` instead.  On the ``meta`` device nothing is drawn:
the tensor has its shape and dtype and no storage, so a parameter tree of
any size is built in no time (``launch/steps.py::params_specs``).
"""
from __future__ import annotations

import math

import torch


def on_meta(device) -> bool:
    """True where ``device`` names the meta device (shapes only)."""
    return device is not None and torch.device(device).type == "meta"


def _place(t: torch.Tensor, dtype, device) -> torch.Tensor:
    return t.to(device=t.device if device is None else device, dtype=dtype)


def _truncated_normal(gen: torch.Generator, shape, std: float, dtype,
                      device) -> torch.Tensor:
    if on_meta(device):
        return torch.empty(shape, dtype=dtype, device="meta")
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=gen)
    return _place(t.mul_(std), dtype, device)   # in place: one float32 copy at a time


def lecun_normal(gen: torch.Generator, shape, fan_in: int | None = None, *,
                 dtype=torch.float32, device=None):
    fan = fan_in if fan_in is not None else shape[0]
    return _truncated_normal(gen, shape, 1.0 / math.sqrt(max(1, fan)), dtype,
                             device)


def he_normal(gen: torch.Generator, shape, fan_in: int | None = None, *,
              dtype=torch.float32, device=None):
    fan = fan_in if fan_in is not None else shape[0]
    return _truncated_normal(gen, shape, math.sqrt(2.0 / max(1, fan)), dtype,
                             device)


def normal(gen: torch.Generator, shape, std: float = 0.02, *,
           dtype=torch.float32, device=None):
    if on_meta(device):
        return torch.empty(shape, dtype=dtype, device="meta")
    t = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return _place(t.mul_(std), dtype, device)
