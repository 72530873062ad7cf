"""Move an AgileNN parameter tree of the JAX package into the port.

The caller maps the JAX tree to numpy arrays first
(``jax.tree_util.tree_map(np.asarray, params)``); this module sees only
numpy.  HWIO conv kernels become OIHW, the ``mapping`` array becomes the
static permutation tuple, and everything else keeps its layout.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device


def _convert(tree, device, key=None):
    if isinstance(tree, dict):
        return {k: _convert(v, device, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device) for v in tree]
    a = np.asarray(tree)
    if key == "mapping":
        return tuple(int(p) for p in a.reshape(-1))
    if key == "w" and a.ndim == 4:          # conv kernel: HWIO -> OIHW
        a = a.transpose(3, 2, 0, 1)
    return torch.tensor(a, device=device)


def params_from_numpy(tree, device=None):
    """The port's parameter tree on ``device`` (CUDA by default; raises
    when CUDA is absent and no device was named)."""
    return _convert(tree, resolve_device(device))
