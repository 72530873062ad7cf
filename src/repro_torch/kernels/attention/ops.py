"""Dispatch of flash attention: the CUDA kernels for CUDA tensors, the
plain version for CPU tensors, no fallback between them.

Where a gradient is asked for on CUDA the forward kernel runs inside
``FlashAttention``, an autograd Function whose forward also writes the
log-sum-exp and whose backward is the backward kernel of the same dtype
(float32 or bf16), for the whole contract of the forward (causal, window,
q_offset, kv_valid_len); without one the forward kernel is called as it
is, so inference launches exactly what it launched before the Function
existed.

Each call reports its work to the step roofline (``kernels/work.py``);
while that counts, a CPU call under a gradient also runs in
``FlashAttention``, with the plain bodies, so that its backward is one
reported call as on the card (its gradients are the plain version's
up to float32 summation order).

Under a mesh, DTensor q, k and v run where they lie: the batch axis stays
split, and the head axis where q's and k's / v's head counts both divide
its split (each rank then holds whole KV groups); every other axis is
gathered first (explicitly, by ``sharded``), and the kernel runs on each
rank's block.  Meta tensors (the dry-run) give outputs of the right
shapes and run nothing."""
from __future__ import annotations

from functools import partial

import torch
from torch.autograd.function import once_differentiable

from repro_torch import sharded
from repro_torch.kernels import work
from repro_torch.kernels.attention.kernel import (
    flash_attention_backward_cuda,
    flash_attention_cuda,
)
from repro_torch.kernels.attention.ref import (
    flash_attention_backward_ref,
    flash_attention_ref,
)


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
        kw = {"causal": ctx.causal, "window": ctx.window, "q_offset": ctx.q_offset,
              "kv_valid_len": kv_valid_len}
        with work.call("flash_attention_backward",
                       lambda: work.flash_attention_backward(q, k, v, **kw)):
            dq, dk, dv = ctx.backward_body(q, k, v, o, do.contiguous(), lse, **kw)
        return dq, dk, dv, None, None, None, None, None, None


def _contiguous_backward_ref(*args, **kwargs):
    """``flash_attention_backward_ref`` with its gradients laid out as the
    kernel writes them (contiguous), so that the operators after the
    backward are the card's."""
    return tuple(g.contiguous() for g in flash_attention_backward_ref(*args, **kwargs))


def _meta_forward(q, k, v, **kw):
    """Meta tensors (the dry-run) have shapes only: o and the log-sum-exp."""
    B, T, Hq, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, Hq, T), dtype=torch.float32)


def _meta_backward(q, k, v, o, do, lse, **kw):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, window: int = 0, q_offset: int = 0,
                       kv_valid_len: torch.Tensor | None = None):
    """q: (B, T, Hq, D); k/v: (B, S, Hkv, D) -> (B, T, Hq, D) in q's dtype,
    differentiable in q, k and v on the CPU and on CUDA (float32 or bf16),
    with any causal, window, q_offset and kv_valid_len the forward takes."""
    kw = {"causal": causal, "window": window, "q_offset": q_offset,
          "kv_valid_len": kv_valid_len}
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    if sharded.is_dtensor(q):
        return attention_sharded(flash_attention_op, q, k, v, kw)
    with work.call("flash_attention", lambda: work.flash_attention(
            q, k, v, return_lse=grad, **kw)):
        if q.device.type == "meta":
            if grad:
                return FlashAttention.apply(q, k, v, causal, window, q_offset,
                                            kv_valid_len, _meta_forward, _meta_backward)
            return torch.empty_like(q)
        if q.device.type == "cpu":
            if grad and work.counting():
                return FlashAttention.apply(
                    q, k, v, causal, window, q_offset, kv_valid_len,
                    partial(flash_attention_ref, return_lse=True),
                    _contiguous_backward_ref)
            return flash_attention_ref(q, k, v, **kw)
        if grad:
            return FlashAttention.apply(
                q.contiguous(), k.contiguous(), v.contiguous(), causal, window,
                q_offset, kv_valid_len,
                partial(flash_attention_cuda, return_lse=True),
                flash_attention_backward_cuda)
        return flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                    **kw)


def attention_sharded(op, q, k, v, kw: dict, rows_key: str = "kv_valid_len"):
    """``op(q, k, v, **kw)`` of DTensors (B, T, H, D) on each rank's block:
    batch split kept, heads split kept where both head counts divide it,
    the rest gathered; ``kw[rows_key]`` (a per-row count) cut to the
    rank's rows.  Returns q's shape at those placements."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = q.device_mesh
    split = 1
    for i, p in enumerate(q.placements):
        if isinstance(p, Shard) and p.dim == 2:
            split *= mesh.size(i)
    heads = q.shape[2] % split == 0 and k.shape[2] % split == 0
    place = [p if isinstance(p, Shard) and (p.dim == 0 or (p.dim == 2 and heads))
             else Replicate() for p in q.placements]
    ql = sharded.local_block(q, place)
    kl, vl = (sharded.local_block(t, place) if sharded.is_dtensor(t)
              else sharded.local_block(sharded.wrap(t, mesh, [Replicate()] * len(place),
                                                    t.shape), place)
              for t in (k, v))
    kw = dict(kw)
    kw[rows_key] = sharded.local_rows(kw[rows_key],
                                      sharded.wrap(ql, mesh, place, q.shape))
    return sharded.wrap(op(ql, kl, vl, **kw), mesh, place, q.shape)
