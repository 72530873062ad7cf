"""Launch wrapper of the flash-attention CUDA kernel
(csrc/flash_attention.cu).

Replaces ``repro.kernels.attention.kernel.flash_attention_tpu`` with the
contract of the jnp ``repro.nn.attention.flash_attention`` that the JAX
model calls.  The source note in the .cu gives its bound and design.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels._build import CudaKernel, check_aligned, check_operand

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("flash_attention", [_P, _P, _P, _P] + [_I] * 9
                    + [ctypes.c_float, _P])
HEAD_DIMS = (64, 128)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0,
                         q_offset: int = 0,
                         kv_valid_len: torch.Tensor | None = None):
    """q: (B, T, Hq, D); k, v: (B, S, Hkv, D); contiguous, 16-byte aligned
    float32 on one CUDA device, D in (64, 128), Hq a multiple of Hkv.
    kv_valid_len: optional (B,) integer count of live keys per row.  Returns
    (B, T, Hq, D) float32.  Raises ValueError on any other input; a
    misaligned view is refused, not copied."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, T, Hq, D) and k, v (B, S, Hkv, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS or k.shape[0] != B or k.shape[3] != D or Hkv < 1 or Hq % Hkv:
        raise ValueError(f"the kernel takes D in {HEAD_DIMS} and Hq a multiple "
                         f"of Hkv, got q {tuple(q.shape)}, k {tuple(k.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_operand(t, name, torch.float32, q.device)
        check_aligned(t, name)
    valid_ptr = None
    if kv_valid_len is not None:
        if kv_valid_len.shape != (B,) or kv_valid_len.is_floating_point():
            raise ValueError(f"kv_valid_len must be (B={B},) integers, got "
                             f"{tuple(kv_valid_len.shape)} {kv_valid_len.dtype}")
        kv_valid_len = kv_valid_len.to(device=q.device, dtype=torch.int32).contiguous()
        valid_ptr = kv_valid_len.data_ptr()
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_ptr,
                      B, T, S, Hq, Hkv, D, int(causal), int(window),
                      int(q_offset), 1.0 / math.sqrt(D), o.data_ptr(),
                      stream=torch.cuda.current_stream().cuda_stream)
    return o
