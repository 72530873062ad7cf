"""Dispatch of flash attention: the CUDA kernels for CUDA tensors, the
plain version for CPU tensors, no fallback between them.

Where a gradient is asked for on CUDA the forward kernel runs inside
``FlashAttention``, an autograd Function whose forward also writes the
log-sum-exp and whose backward is the backward kernel of the same dtype
(float32 or bf16), for the whole contract of the forward (causal, window,
q_offset, kv_valid_len); without one the forward kernel is called as it
is, so inference launches exactly what it launched before the Function
existed."""
from __future__ import annotations

from functools import partial

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels.attention.kernel import (
    flash_attention_backward_cuda,
    flash_attention_cuda,
)
from repro_torch.kernels.attention.ref import flash_attention_ref


class FlashAttention(torch.autograd.Function):
    """``forward(q, k, v, causal=, window=, q_offset=, kv_valid_len=) ->
    (o, lse)`` with the gradient ``backward(q, k, v, o, do, lse, causal=,
    window=, q_offset=, kv_valid_len=) -> (dq, dk, dv)``: the two bodies
    are arguments (the CUDA kernels on the card; the tests drive it with
    plain-torch emulations).  Saves q, k, v, o, the log-sum-exp and
    kv_valid_len; q_offset and kv_valid_len take no gradient.  Once
    differentiable: no path takes a second derivative through the
    backbone's attention (the AgileNN-on-tokens loss differentiates twice
    through its reference head only)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, kv_valid_len, forward,
                backward):
        o, lse = forward(q, k, v, causal=causal, window=window,
                         q_offset=q_offset, kv_valid_len=kv_valid_len)
        ctx.save_for_backward(q, k, v, o, lse, kv_valid_len)
        ctx.causal, ctx.window, ctx.q_offset = causal, window, q_offset
        ctx.backward_body = backward
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse, kv_valid_len = ctx.saved_tensors
        dq, dk, dv = ctx.backward_body(q, k, v, o, do.contiguous(), lse,
                                       causal=ctx.causal, window=ctx.window,
                                       q_offset=ctx.q_offset,
                                       kv_valid_len=kv_valid_len)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, window: int = 0, q_offset: int = 0,
                       kv_valid_len: torch.Tensor | None = None):
    """q: (B, T, Hq, D); k/v: (B, S, Hkv, D) -> (B, T, Hq, D) in q's dtype,
    differentiable in q, k and v on the CPU and on CUDA (float32 or bf16),
    with any causal, window, q_offset and kv_valid_len the forward takes."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, kv_valid_len=kv_valid_len)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(
            q.contiguous(), k.contiguous(), v.contiguous(), causal, window,
            q_offset, kv_valid_len,
            partial(flash_attention_cuda, return_lse=True),
            flash_attention_backward_cuda)
    return flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                causal=causal, window=window, q_offset=q_offset,
                                kv_valid_len=kv_valid_len)
