"""Dispatch of the RMSNorm: the CUDA kernels for CUDA tensors, the plain
version for CPU tensors, no fallback between them.

Where a gradient is asked for on CUDA the forward kernel runs inside
``RMSNorm``, an autograd Function whose backward is the backward kernel
of the same dtype (float32 or bf16); without one the forward kernel is
called as it is, so inference launches exactly what it launched before
the Function existed.

Each call reports its work to the step roofline (``kernels/work.py``);
while that counts, a CPU call under a gradient also runs in ``RMSNorm``,
with the plain bodies, so that its backward is one reported call as on
the card (its gradients are the plain version's up to float32
summation order)."""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import work
from repro_torch.kernels.rmsnorm.kernel import rmsnorm_backward_cuda, rmsnorm_cuda
from repro_torch.kernels.rmsnorm.ref import rmsnorm_backward_ref, rmsnorm_ref


class RMSNorm(torch.autograd.Function):
    """``forward(x, scale, eps=eps)`` over (N, d) rows with the gradient
    ``backward(x, scale, g, eps=eps) -> (dx, dscale)``: the two bodies are
    arguments (the CUDA kernels on the card; the tests drive it with
    plain-torch emulations).  Saves x and scale.  Once differentiable: no
    path takes a second derivative through the backbone's norms (the
    AgileNN-on-tokens loss differentiates twice through its reference
    head only)."""

    @staticmethod
    def forward(ctx, x, scale, eps, forward, backward):
        ctx.save_for_backward(x, scale)
        ctx.eps, ctx.backward_body = eps, backward
        return forward(x, scale, eps=eps)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        with work.call("rmsnorm_backward", lambda: work.rmsnorm_backward(x, scale)):
            dx, dscale = ctx.backward_body(x, scale, g.contiguous(), eps=ctx.eps)
        return dx, dscale, None, None, None


def rmsnorm_op(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6):
    """x: (..., d); scale: (d,) of x's dtype (float32 or bfloat16 on CUDA).
    Returns x's shape and dtype; differentiable in x and scale on the CPU
    and on CUDA."""
    grad = torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad)
    with work.call("rmsnorm", lambda: work.rmsnorm(x, scale)):
        cpu = x.device.type == "cpu"
        if cpu and not (grad and work.counting()):
            return rmsnorm_ref(x, scale, eps=eps)
        d = x.shape[-1]
        x2 = x.reshape(-1, d).contiguous()
        if grad:
            bodies = ((rmsnorm_ref, rmsnorm_backward_ref) if cpu
                      else (rmsnorm_cuda, rmsnorm_backward_cuda))
            y = RMSNorm.apply(x2, scale, eps, *bodies)
        else:
            y = rmsnorm_cuda(x2, scale, eps=eps)
        return y.reshape(x.shape)
