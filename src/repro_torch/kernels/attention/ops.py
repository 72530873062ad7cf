"""Dispatch of flash attention: the CUDA kernel for CUDA tensors, the
plain version for CPU tensors, no fallback between them."""
from __future__ import annotations

import torch

from repro_torch.kernels.attention.kernel import flash_attention_cuda
from repro_torch.kernels.attention.ref import flash_attention_ref


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, window: int = 0, q_offset: int = 0,
                       kv_valid_len: torch.Tensor | None = None):
    """q: (B, T, Hq, D); k/v: (B, S, Hkv, D) -> (B, T, Hq, D)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, kv_valid_len=kv_valid_len)
    return flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                causal=causal, window=window, q_offset=q_offset,
                                kv_valid_len=kv_valid_len)
