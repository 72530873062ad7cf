"""Move parameter trees of the JAX package into the port.

The caller maps the JAX tree to numpy arrays first
(``jax.tree_util.tree_map(np.asarray, params)``); this module sees only
numpy.

- ``params_from_numpy``: an AgileNN tree.  HWIO conv kernels become OIHW,
  the ``mapping`` array becomes the static permutation tuple, and
  everything else keeps its layout.
- ``backbone_params_from_numpy``: an LLM backbone tree.  The JAX package
  stacks its layers on a leading (n_superblocks,) axis; the port keeps a
  list of per-layer dicts.  Dense weights keep their (in, out) layout.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.backbone import sublayer_specs


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


def _leaves_to(tree, device):
    if isinstance(tree, dict):
        return {k: _leaves_to(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), device=device)


def backbone_params_from_numpy(tree, cfg, device=None):
    """The port's backbone params (``repro_torch.models.backbone``) on
    ``device`` (CUDA by default; raises when CUDA is absent and no device
    was named), each tensor in its array's dtype.

    ``tree["blocks"]`` holds one dict per sublayer of a superblock, each
    leaf stacked over superblocks; layer ``s * superblock + j`` of the
    port is leaf ``[s]`` of sublayer ``j``."""
    sublayer_specs(cfg)                 # dense archs only, for now
    device = resolve_device(device)
    out = {k: _leaves_to(v, device) for k, v in tree.items() if k != "blocks"}
    subs = list(tree["blocks"])
    out["blocks"] = [
        _leaves_to(_index(sub, s), device)
        for s in range(cfg.n_superblocks) for sub in subs]
    return out


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]
