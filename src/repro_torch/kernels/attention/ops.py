"""Dispatch of flash attention: the CUDA kernels for CUDA tensors, the
plain version for CPU tensors, no fallback between them.

Where a gradient is asked for on CUDA the forward kernel runs inside
``FlashAttention``, an autograd Function whose forward also writes the
log-sum-exp and whose backward is the backward kernel; without one the
forward kernel is called as it is, so inference launches exactly what it
launched before the Function existed."""
from __future__ import annotations

from functools import partial

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels.attention.kernel import (
    flash_attention_backward_cuda,
    flash_attention_cuda,
)
from repro_torch.kernels.attention.ref import flash_attention_ref

# what a gradient through q_offset / kv_valid_len would need
GRAD_CONTRACT_ITEM = ("ROADMAP Queue 2, 'flash backward: q_offset and "
                      "kv_valid_len'")


class FlashAttention(torch.autograd.Function):
    """``forward(q, k, v, causal=, window=) -> (o, lse)`` with the gradient
    ``backward(q, k, v, o, do, lse, causal=, window=) -> (dq, dk, dv)``:
    the two bodies are arguments (the CUDA kernels on the card; the tests
    drive it with plain-torch emulations).  Saves q, k, v, o and the
    log-sum-exp.  Once differentiable: no path takes a second derivative
    through the backbone's attention (the AgileNN-on-tokens loss
    differentiates twice through its reference head only)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, forward, backward):
        o, lse = forward(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window, ctx.backward_body = causal, window, backward
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = ctx.backward_body(q, k, v, o, do.contiguous(), lse,
                                       causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None, None, None


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, window: int = 0, q_offset: int = 0,
                       kv_valid_len: torch.Tensor | None = None):
    """q: (B, T, Hq, D); k/v: (B, S, Hkv, D) -> (B, T, Hq, D),
    differentiable in q, k and v on either device.  On CUDA a gradient is
    taken for q_offset = 0 and no kv_valid_len only (ValueError
    otherwise)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, kv_valid_len=kv_valid_len)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if q_offset or kv_valid_len is not None:
            raise ValueError("the flash backward kernel takes q_offset = 0 and "
                             "no kv_valid_len (no training path passes them); "
                             f"a gradient through them waits for {GRAD_CONTRACT_ITEM}")
        return FlashAttention.apply(
            q.contiguous(), k.contiguous(), v.contiguous(), causal, window,
            partial(flash_attention_cuda, return_lse=True),
            flash_attention_backward_cuda)
    return flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                causal=causal, window=window, q_offset=q_offset,
                                kv_valid_len=kv_valid_len)
