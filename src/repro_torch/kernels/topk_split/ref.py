"""Plain PyTorch version of the channel permute / split."""
from __future__ import annotations

import torch


def channel_permute_ref(x: torch.Tensor, perm) -> torch.Tensor:
    return x[..., list(perm)]


def split_ref(x: torch.Tensor, perm, k: int):
    y = channel_permute_ref(x, perm)
    return y[..., :k], y[..., k:]
