"""AdamW, as ``repro.optim.adamw``: plain functions over parameter trees,
moments in fp32, returning new trees, in JAX's order of operations."""
from __future__ import annotations

import torch

from repro_torch import tree_leaves, tree_map


def adamw_init(params):
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    leaves = tree_leaves(params)
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32,
                            device=leaves[0].device if leaves else None),
    }


@torch.no_grad()
def adamw_update(params, grads, state, *, lr: float, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1):
    step = state["step"] + 1
    stepf = step.float()
    bc1 = 1.0 - torch.pow(stepf.new_tensor(b1), stepf)
    bc2 = 1.0 - torch.pow(stepf.new_tensor(b2), stepf)

    m_new = tree_map(lambda g, m: b1 * m + (1 - b1) * g.float(),
                     grads, state["m"])
    v_new = tree_map(lambda g, v: b2 * v + (1 - b2) * torch.square(g.float()),
                     grads, state["v"])

    def upd(p, m, v):
        update = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        p32 = p.float()
        return (p32 - lr * (update + weight_decay * p32)).to(p.dtype)

    p_new = tree_map(upd, params, m_new, v_new)
    return p_new, {"m": m_new, "v": v_new, "step": step}
