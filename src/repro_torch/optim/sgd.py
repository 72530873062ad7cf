"""SGD with momentum + decoupled weight decay (paper §7 training setup),
as ``repro.optim.sgd``: plain functions over parameter trees, returning
new trees (the inputs are left as they are), not ``torch.optim``.  The
update keeps JAX's order of operations, ``m = mu * m + g + wd * p`` then
``p - lr * m``."""
from __future__ import annotations

import torch

from repro_torch import tree_map


def sgd_init(params):
    return {"momentum": tree_map(torch.zeros_like, params)}


@torch.no_grad()
def sgd_update(params, grads, state, *, lr: float, momentum: float = 0.9,
               weight_decay: float = 5e-4):
    m_new = tree_map(lambda p, g, m: momentum * m + g + weight_decay * p,
                     params, grads, state["momentum"])
    p_new = tree_map(lambda p, m: p - lr * m, params, m_new)
    return p_new, {"momentum": m_new}
