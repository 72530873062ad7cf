"""Launch wrapper of the static channel-permute CUDA kernel
(csrc/topk_split.cu).

Replaces ``repro.kernels.topk_split.kernel.channel_permute_tpu``.  The
source note in the .cu gives its byte bound and design.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import (CudaKernel, check_aligned, check_operand,
                                        perm_array)

_P = ctypes.c_void_p
KERNEL = CudaKernel("topk_split", [_P, ctypes.POINTER(ctypes.c_int),
                                   ctypes.c_longlong, ctypes.c_int, _P])


def channel_permute_cuda(x: torch.Tensor, perm) -> torch.Tensor:
    """x: (N, C) contiguous, 16-byte aligned float32 CUDA rows; perm: C
    static channel indices.  Returns out (N, C) with out[:, c] =
    x[:, perm[c]].  Raises ValueError on any other input; a misaligned view
    is refused, not copied."""
    check_operand(x, "x", torch.float32)
    check_aligned(x, "x")
    if x.dim() != 2:
        raise ValueError(f"x must be (N, C), got {tuple(x.shape)}")
    N, C = x.shape
    cperm = perm_array(perm, C)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        KERNEL.launch(x.data_ptr(), cperm, N, C, out.data_ptr(),
                      stream=torch.cuda.current_stream().cuda_stream)
    return out
