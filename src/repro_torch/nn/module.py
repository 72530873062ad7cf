"""``repro.nn.module::param_count`` over the port's parameter trees
(dicts and lists of tensors)."""
from __future__ import annotations

from repro_torch import tree_leaves


def param_count(params) -> int:
    return sum(int(t.numel()) for t in tree_leaves(params))

