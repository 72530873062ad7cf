"""Launch wrapper of the fused offload CUDA kernel (csrc/offload_fused.cu).

Replaces ``repro.kernels.offload_fused.kernel.offload_fused_tpu``.  The
source note in the .cu gives its byte bound and design.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import (CudaKernel, check_aligned, check_operand,
                                        perm_array)

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("offload_fused", [_P, _P, ctypes.POINTER(_I),
                                      ctypes.c_longlong, _I, _I, _I,
                                      _P, _P, _P, _P])


def offload_fused_cuda(x: torch.Tensor, centers: torch.Tensor, *, perm, k: int):
    """x: (N, C) contiguous, 16-byte aligned float32 CUDA rows; centers:
    (L,) float32 on the same device, L <= 16; perm: C static channel
    indices; 0 <= k <= C.

    Returns (local (N, k), remote (N, C-k), idx int32 (N, C-k),
    deq (N, C-k)) from one launch.  Raises ValueError on any other input;
    a misaligned view is refused, not copied."""
    check_operand(x, "x", torch.float32)
    check_aligned(x, "x")
    check_operand(centers, "centers", torch.float32, x.device)
    if x.dim() != 2 or centers.dim() != 1 or not 1 <= centers.shape[0] <= 16:
        raise ValueError(f"x must be (N, C) and centers (L <= 16,), got "
                         f"{tuple(x.shape)}, {tuple(centers.shape)}")
    N, C = x.shape
    if not 0 <= k <= C:
        raise ValueError(f"k={k} outside [0, C={C}]")
    cperm = perm_array(perm, C)
    local = torch.empty((N, k), dtype=x.dtype, device=x.device)
    remote = torch.empty((N, C - k), dtype=x.dtype, device=x.device)
    idx = torch.empty((N, C - k), dtype=torch.int32, device=x.device)
    deq = torch.empty((N, C - k), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        KERNEL.launch(x.data_ptr(), centers.data_ptr(), cperm, N, C, k,
                      centers.shape[0], local.data_ptr(), remote.data_ptr(),
                      idx.data_ptr(), deq.data_ptr(),
                      stream=torch.cuda.current_stream().cuda_stream)
    return local, remote, idx, deq
