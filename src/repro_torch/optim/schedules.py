"""Learning-rate schedules and global-norm clipping, as
``repro.optim.schedules``; each schedule returns a float32 0-d tensor."""
from __future__ import annotations

import math

import torch

from repro_torch import tree_leaves, tree_map


def cosine_schedule(step, *, base_lr: float, warmup: int, total: int,
                    min_lr: float = 0.0):
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = base_lr * step / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_lr + 0.5 * (base_lr - min_lr) * (1 + torch.cos(math.pi * frac))
    return torch.where(step < warmup, warm, cos)


def step_decay(step, *, base_lr: float, decay: float = 0.1,
               milestones: tuple = (100, 150)):
    step = torch.as_tensor(step, dtype=torch.float32)
    lr = torch.full_like(step, base_lr)
    for m in milestones:
        lr = torch.where(step >= m, lr * decay, lr)
    return lr


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled so their global L2 norm is at most max_norm, the norm
    before clipping)."""
    norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in tree_leaves(grads)))
    scale = torch.minimum(norm.new_tensor(1.0),
                          max_norm / torch.maximum(norm, norm.new_tensor(1e-12)))
    return tree_map(lambda g: g * scale, grads), norm
