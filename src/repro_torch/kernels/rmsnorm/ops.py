"""Dispatch of the RMSNorm: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors, no fallback between them."""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref


def rmsnorm_op(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6):
    """x: (..., d); scale: (d,).  Returns x's shape."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps=eps)
    d = x.shape[-1]
    return rmsnorm_cuda(x.reshape(-1, d).contiguous(), scale,
                        eps=eps).reshape(x.shape)
