"""Dispatch of decode attention: the CUDA kernel for CUDA tensors, the
plain version for CPU tensors, no fallback between them."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import auto_page_size
from repro_torch.kernels.decode_attention.kernel import decode_attention_cuda
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

# the page passed where the cache width does not split into pages
DEFAULT_PAGE = 64


def decode_attention_op(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, attend_len):
    """q: (B, 1, Hq, D); k/v_cache: (B, S, Hkv, D); attend_len: an int or a
    () / (B,) tensor of valid slots.  Returns (B, 1, Hq, D).  On CUDA the
    page passed is ``auto_page_size(S)``, as the JAX dispatcher picks it,
    or ``DEFAULT_PAGE`` when S does not split into pages; the kernel cuts
    the slots into its own splits, so any S runs it."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, attend_len)
    page = auto_page_size(k_cache.shape[1]) or DEFAULT_PAGE
    return decode_attention_cuda(q.contiguous(), k_cache.contiguous(),
                                 v_cache.contiguous(), attend_len,
                                 page_size=page)
