"""Plain PyTorch version of the fused RMSNorm (the JAX model's math)."""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6):
    """x: (..., d); scale: (d,).  fp32 inside, returns x.dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * (var + eps) ** -0.5 * scale.float()).to(x.dtype)
