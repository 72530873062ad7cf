"""Plain PyTorch version of the fused permute->split->quantize pass."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import nearest_center_scan


def offload_fused_ref(x: torch.Tensor, centers: torch.Tensor, perm, k: int):
    """x: (..., C) -> (local, remote, indices int32, dequantized)."""
    y = x[..., list(perm)]
    local, remote = y[..., :k], y[..., k:]
    idx, deq = nearest_center_scan(remote.float(), centers.float())
    return local, remote, idx, deq.to(x.dtype)
