"""Checkpointing: flat-key npz save/restore of parameter trees, in the JAX
package's format (``repro.checkpoint.io``): a key is the leaf's path,
dict keys and list indices joined by "/".

The file is the same whichever package writes it: conv kernels (4-D
``w``, OIHW here) are written in the JAX package's HWIO layout and read
back as OIHW, and the static ``mapping`` tuple is written as an int32
array and read back as a tuple.  A checkpoint written by either package
restores in the other.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def _is_conv(key: str, a) -> bool:
    return key.rsplit("/", 1)[-1] == "w" and a.ndim == 4


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items()
                for k, v in _flatten(sub, f"{prefix}{name}/").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flatten(sub, f"{prefix}{i}/").items()}
    key = prefix[:-1]
    if isinstance(tree, tuple):
        return {key: np.asarray(tree, dtype=np.int32)}
    a = tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)
    return {key: a.transpose(2, 3, 1, 0) if _is_conv(key, a) else a}


def save_checkpoint(path: str, tree) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **_flatten(tree))


def _restore(data, like, key: str):
    if isinstance(like, dict):
        return {k: _restore(data, v, f"{key}{k}/") for k, v in like.items()}
    if isinstance(like, list):
        return [_restore(data, v, f"{key}{i}/") for i, v in enumerate(like)]
    key = key[:-1]
    arr = data[key]
    if isinstance(like, tuple):
        return tuple(int(p) for p in arr.reshape(-1))
    if _is_conv(key, arr):
        arr = arr.transpose(3, 2, 0, 1)
    if arr.shape != tuple(like.shape):
        raise ValueError(f"checkpoint leaf {key}: shape {arr.shape}, expected "
                         f"{tuple(like.shape)}")
    return torch.tensor(arr.copy(), dtype=like.dtype,
                        device=like.device)


def restore_checkpoint(path: str, like):
    """Restore into the structure of ``like`` (a tree of the shapes,
    dtypes and devices wanted)."""
    with np.load(path) as data:
        return _restore(data, like, "")
