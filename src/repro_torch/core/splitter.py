"""Runtime feature split (paper §3, Figure 5).

The disorder loss puts the top-k important features in the FIRST k
channels, so at inference the split is a slice.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.topk_split.ops import channel_permute_op


def split_features(feats: torch.Tensor, k: int):
    """feats: (B, ..., C) -> (local (B, ..., k), remote (B, ..., C-k))."""
    return feats[..., :k], feats[..., k:]


def merge_features(local: torch.Tensor, remote: torch.Tensor) -> torch.Tensor:
    return torch.cat([local, remote], dim=-1)


def apply_channel_permutation(feats: torch.Tensor, perm) -> torch.Tensor:
    """Reorder channels, ``feats[..., perm]`` (the training-time mapping
    layer): the permute kernel on CUDA tensors, differentiable in feats."""
    return channel_permute_op(feats, tuple(int(p) for p in perm))
