"""Plain PyTorch versions of the fused RMSNorm (the JAX model's math) and
of its gradient."""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6):
    """x: (..., d); scale: (d,).  fp32 inside, returns x.dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * (var + eps) ** -0.5 * scale.float()).to(x.dtype)


def rmsnorm_backward_ref(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                         *, eps: float = 1e-6):
    """(dx, dscale): autograd of ``rmsnorm_ref`` at (x, scale) against the
    output gradient g (x's shape)."""
    with torch.enable_grad():
        xx = x.detach().requires_grad_()
        ss = scale.detach().requires_grad_()
        y = rmsnorm_ref(xx, ss, eps=eps)
        dx, dscale = torch.autograd.grad(y, (xx, ss), g)
    return dx, dscale
