"""Launch wrapper of the nearest-center quantizer CUDA kernel
(csrc/quantize.cu).

Replaces ``repro.kernels.quantize.kernel.quantize_tpu``.  The source note
in the .cu gives its byte bound and design.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel, check_operand

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("quantize", [_P, _P, ctypes.c_longlong, _I, _P, _P])


def quantize_cuda(x: torch.Tensor, centers: torch.Tensor):
    """x: contiguous float32 CUDA tensor of any shape; centers: (L,)
    float32 on the same device, L <= 16.

    Returns (indices int32, dequantized float32), shaped like x.  Raises
    ValueError on any other input."""
    check_operand(x, "x", torch.float32)
    check_operand(centers, "centers", torch.float32, x.device)
    if centers.dim() != 1 or not 1 <= centers.shape[0] <= 16:
        raise ValueError(f"centers must be (L <= 16,), got {tuple(centers.shape)}")
    idx = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    deq = torch.empty_like(x)
    with torch.cuda.device(x.device):
        KERNEL.launch(x.data_ptr(), centers.data_ptr(), x.numel(),
                      centers.shape[0], idx.data_ptr(), deq.data_ptr(),
                      stream=torch.cuda.current_stream().cuda_stream)
    return idx, deq
