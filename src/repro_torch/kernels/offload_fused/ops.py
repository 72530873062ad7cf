"""Dispatch of the fused offload pass: the CUDA kernel for CUDA tensors,
the plain version for CPU tensors.  There is no fallback: a CUDA tensor
either goes through the kernel or the call raises."""
from __future__ import annotations

import torch

from repro_torch.kernels.offload_fused.kernel import offload_fused_cuda
from repro_torch.kernels.offload_fused.ref import offload_fused_ref


def fused_offload(x: torch.Tensor, centers: torch.Tensor, *, perm, k: int):
    """x: (..., C) -> (local (..., k), remote (..., C-k), indices int32,
    dequantized), every output contiguous."""
    lead, C = x.shape[:-1], x.shape[-1]
    if x.device.type == "cpu":
        return tuple(t.contiguous()
                     for t in offload_fused_ref(x, centers, perm, k))
    outs = offload_fused_cuda(x.reshape(-1, C).contiguous(), centers,
                              perm=perm, k=k)
    return tuple(o.reshape(lead + o.shape[-1:]) for o in outs)
