"""Runtime feature split (paper §3, Figure 5).

The disorder loss puts the top-k important features in the FIRST k
channels, so at inference the split is a slice.
"""
from __future__ import annotations

import torch


def split_features(feats: torch.Tensor, k: int):
    """feats: (B, ..., C) -> (local (B, ..., k), remote (B, ..., C-k))."""
    return feats[..., :k], feats[..., k:]


def merge_features(local: torch.Tensor, remote: torch.Tensor) -> torch.Tensor:
    return torch.cat([local, remote], dim=-1)
