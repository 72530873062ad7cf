"""Launch wrapper of the RMSNorm CUDA kernel (csrc/rmsnorm.cu).

Replaces ``repro.kernels.rmsnorm.kernel.rmsnorm_tpu``.  The source note in
the .cu gives its byte bound and design.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel, check_operand

_P = ctypes.c_void_p
KERNEL = CudaKernel("rmsnorm", [_P, _P, ctypes.c_longlong, ctypes.c_int,
                                ctypes.c_float, _P])
MAX_WIDTH = 8192


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6):
    """x: (N, d) contiguous float32 CUDA rows, any N, d <= 8192; scale:
    (d,) float32 on the same device.  Returns (N, d) float32.  Raises
    ValueError on any other input."""
    if x.dim() != 2 or scale.shape != x.shape[-1:] or not 1 <= x.shape[1] <= MAX_WIDTH:
        raise ValueError(f"x must be (N, d <= {MAX_WIDTH}) and scale (d,), got "
                         f"{tuple(x.shape)}, {tuple(scale.shape)}")
    check_operand(x, "x", torch.float32)
    check_operand(scale, "scale", torch.float32, x.device)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        KERNEL.launch(x.data_ptr(), scale.data_ptr(), x.shape[0], x.shape[1],
                      eps, y.data_ptr(),
                      stream=torch.cuda.current_stream().cuda_stream)
    return y
