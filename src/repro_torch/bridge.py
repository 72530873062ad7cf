"""Move parameter trees of the JAX package into the port.

The caller maps the JAX tree to numpy arrays first
(``jax.tree_util.tree_map(np.asarray, params)``); this module sees only
numpy.

- ``params_from_numpy``: an AgileNN tree, or a baseline's
  (``core/baselines.py``: MCUNet, DeepCOD, SPINN).  HWIO conv kernels
  become OIHW, the ``mapping`` array becomes the static permutation
  tuple, and everything else keeps its layout.
- ``backbone_params_from_numpy``: an LLM backbone tree.  The JAX package
  stacks its layers on a leading (n_superblocks,) axis (an enc-dec's
  encoder and decoder layers on a plain (L,) axis); the port keeps a list
  of per-layer dicts.  Dense weights keep their (in, out) layout, an MoE
  layer's stacked experts their (E, in, out), and every leaf is cast to
  the config's dtype.
- ``agile_lm_params_from_numpy``: an AgileNN-on-tokens tree
  (``core/agile_lm.py``): its backbone as above, the rest as it is.
- ``backbone_params_to_numpy``: the way back, for a backbone tree of the
  port (its params, or a gradient tree of the same structure): numpy
  float32 leaves in the JAX package's layout, layers stacked again, so a
  test compares ``jax.value_and_grad``'s tree leaf by leaf.
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


def _leaves_to(tree, device, dtype=None):
    if isinstance(tree, dict):
        return {k: _leaves_to(v, device, dtype) for k, v in tree.items()}
    t = torch.tensor(np.asarray(tree), device=device)
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


def backbone_params_from_numpy(tree, cfg, device=None):
    """The port's backbone params (``repro_torch.models.backbone``) on
    ``device`` (CUDA by default; raises when CUDA is absent and no device
    was named), each floating-point tensor cast to ``cfg.dtype`` (a bf16
    config takes float32 arrays of bf16 values without loss; the port does
    not read numpy's bf16 extension type).

    ``tree["blocks"]`` holds one dict per sublayer of a superblock, each
    leaf stacked over superblocks; layer ``s * superblock + j`` of the
    port is leaf ``[s]`` of sublayer ``j``.  An MoE sublayer's ``moe``
    (``router``, stacked ``gate`` / ``up`` / ``down`` of shape (E, a, b)),
    ``shared`` and ``dense_res`` come over with it.  An enc-dec tree's
    ``"encoder"`` and ``"blocks"`` are each one dict whose leaves are
    stacked over layers; layer ``i`` is leaf ``[i]``.  Every other entry
    (``vision_proj``, the norms, the embedding) keeps its layout."""
    sublayer_specs(cfg)                 # no hybrid or xLSTM, for now
    device = resolve_device(device)
    dtype = cfg.dtype
    stacked = ("encoder", "blocks")
    out = {k: _leaves_to(v, device, dtype) for k, v in tree.items()
           if k not in stacked}
    if cfg.encdec is not None:
        for k, n in (("encoder", cfg.encdec.n_encoder_layers),
                     ("blocks", cfg.n_layers)):
            out[k] = [_leaves_to(_index(tree[k], i), device, dtype)
                      for i in range(n)]
        return out
    subs = list(tree["blocks"])
    out["blocks"] = [
        _leaves_to(_index(sub, s), device, dtype)
        for s in range(cfg.n_superblocks) for sub in subs]
    return out


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def agile_lm_params_from_numpy(tree, cfg, device=None):
    """The port's ``core.agile_lm`` params on ``device`` (CUDA by default;
    raises when CUDA is absent and no device was named)."""
    device = resolve_device(device)
    out = {k: _leaves_to(v, device) for k, v in tree.items() if k != "backbone"}
    out["backbone"] = backbone_params_from_numpy(tree["backbone"], cfg, device)
    return out


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.float() if t.is_floating_point() else t).numpy()


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def backbone_params_to_numpy(tree, cfg) -> dict:
    """A backbone tree of the port (``backbone_params_from_numpy``'s
    layout: params or gradients) in the JAX package's layout, every leaf a
    numpy array, floating point widened to float32 (a bf16 leaf exactly):
    ``"blocks"`` becomes one dict per sublayer of a superblock with each
    leaf stacked over superblocks (an enc-dec's ``"encoder"`` and
    ``"blocks"`` one dict each, stacked over layers)."""
    specs = sublayer_specs(cfg)
    stacked = ("encoder", "blocks")
    out = {k: _numpy(v) for k, v in tree.items() if k not in stacked}
    layers = {k: [_numpy(p) for p in tree[k]] for k in stacked if k in tree}
    if cfg.encdec is not None:
        return {**out, **{k: _stack(v) for k, v in layers.items()}}
    per = len(specs)
    out["blocks"] = [_stack(layers["blocks"][j::per]) for j in range(per)]
    return out
