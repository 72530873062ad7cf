"""Dispatch of the channel permute / split: the CUDA kernel for CUDA
tensors, the plain version for CPU tensors, no fallback between them.

On CUDA the kernel runs inside ``ChannelPermute``, an autograd Function
whose backward is the same kernel with the inverse permutation, so the
permuted features carry gradients on the card as the plain version's
indexing does on the CPU (AgileNN training backpropagates through them
into the extractor)."""
from __future__ import annotations

import torch

from repro_torch.kernels.topk_split.kernel import channel_permute_cuda
from repro_torch.kernels.topk_split.ref import channel_permute_ref


def inverse_permutation(perm) -> tuple:
    """inv with inv[perm[c]] = c: ``x[:, perm][:, inv] == x``."""
    inv = [0] * len(perm)
    for c, p in enumerate(perm):
        inv[int(p)] = c
    return tuple(inv)


class ChannelPermute(torch.autograd.Function):
    """``body(x, perm)``, the permute ``out[:, c] = x[:, perm[c]]`` of (N, C)
    rows, with its gradient: ``grad_x = body(grad, inverse(perm))``.  The
    backward applies this Function again, so it is differentiable itself
    (the IG loss takes a second derivative upstream of the permute).
    Nothing is saved for the backward but the static permutation."""

    @staticmethod
    def forward(ctx, x, perm, body):
        ctx.perm, ctx.body = perm, body
        return body(x, perm)

    @staticmethod
    def backward(ctx, grad):
        return (ChannelPermute.apply(grad.contiguous(),
                                     inverse_permutation(ctx.perm), ctx.body),
                None, None)


def channel_permute_op(x: torch.Tensor, perm) -> torch.Tensor:
    """x: (..., C) -> contiguous (..., C) with channel c = x[..., perm[c]],
    differentiable in x on either device."""
    if x.device.type == "cpu":
        return channel_permute_ref(x, perm)
    C = x.shape[-1]
    return ChannelPermute.apply(x.reshape(-1, C).contiguous(), tuple(perm),
                                channel_permute_cuda).reshape(x.shape)


def split_op(x: torch.Tensor, *, perm, k: int):
    """x: (..., C) -> (local (..., k), remote (..., C-k)), views of the
    permuted tensor."""
    y = channel_permute_op(x, perm)
    return y[..., :k], y[..., k:]
