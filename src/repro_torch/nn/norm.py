"""Normalization layers over the last (channel) axis, fp32 inside."""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.ops import rmsnorm_op


def groupnorm_init(dim: int) -> dict:
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}


def rmsnorm_init(dim: int) -> dict:
    return {"scale": torch.ones(dim)}


def rmsnorm(params, x, *, eps: float = 1e-6):
    """The RMSNorm kernel (``kernels/rmsnorm``) on CUDA tensors, its plain
    version on CPU tensors."""
    return rmsnorm_op(x, params["scale"], eps=eps)


def layernorm(params, x, *, eps: float = 1e-5):
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * (var + eps) ** -0.5
    return (y * params["scale"].float() + params["bias"].float()).to(x.dtype)


def groupnorm(params, x, *, groups: int, eps: float = 1e-5):
    """GroupNorm of each pixel over its groups of channels (last axis).

    This is the JAX package's ``groupnorm_apply``: the statistics are
    taken over the C/groups channels of one group at one pixel, NOT over
    H x W as ``torch.nn.functional.group_norm`` does; the two disagree by
    far more than rounding."""
    x32 = x.float()
    shape = x32.shape
    xg = x32.reshape(shape[:-1] + (groups, shape[-1] // groups))
    mu = torch.mean(xg, dim=-1, keepdim=True)
    var = torch.var(xg, dim=-1, keepdim=True, correction=0)
    y = ((xg - mu) * (var + eps) ** -0.5).reshape(shape)
    return (y * params["scale"].float() + params["bias"].float()).to(x.dtype)
