"""Dispatch of the quantizer: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors, no fallback between them."""
from __future__ import annotations

import torch

from repro_torch.kernels import work
from repro_torch.kernels.quantize.kernel import quantize_cuda
from repro_torch.kernels.quantize.ref import quantize_ref


def quantize_op(x: torch.Tensor, centers: torch.Tensor):
    """x: any shape; centers: (L,).  Returns (indices int32, dequantized)."""
    with work.call("quantize", lambda: work.quantize(x, centers)):
        if x.device.type == "cpu":
            return quantize_ref(x, centers)
        return quantize_cuda(x, centers)
