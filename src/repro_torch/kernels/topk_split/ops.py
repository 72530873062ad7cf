"""Dispatch of the channel permute / split: the CUDA kernel for CUDA
tensors, the plain version for CPU tensors, no fallback between them."""
from __future__ import annotations

import torch

from repro_torch.kernels.topk_split.kernel import channel_permute_cuda
from repro_torch.kernels.topk_split.ref import channel_permute_ref


def channel_permute_op(x: torch.Tensor, perm) -> torch.Tensor:
    """x: (..., C) -> contiguous (..., C) with channel c = x[..., perm[c]]."""
    if x.device.type == "cpu":
        return channel_permute_ref(x, perm)
    C = x.shape[-1]
    return channel_permute_cuda(x.reshape(-1, C).contiguous(),
                                perm).reshape(x.shape)


def split_op(x: torch.Tensor, *, perm, k: int):
    """x: (..., C) -> (local (..., k), remote (..., C-k)), views of the
    permuted tensor."""
    y = channel_permute_op(x, perm)
    return y[..., :k], y[..., k:]
