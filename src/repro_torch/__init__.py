"""PyTorch/CUDA port of the AgileNN reproduction (`repro`), for one
NVIDIA H100.

Public functions keep the JAX package's layouts (images NHWC, features
channels-last) so the two can be held against each other on the same
inputs.  Entry points that create tensors run on ``cuda`` unless the
caller passes ``device="cpu"``; they raise when CUDA is absent and no
device was named.
"""
from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function


def resolve_device(device=None) -> torch.device:
    """The torch device an entry point works on: ``cuda`` by default.

    Raises RuntimeError when no device was named and CUDA is absent: the
    CPU runs only when it is asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def tree_to(tree, device):
    """The parameter tree with every tensor moved to ``device``."""
    return tree_map(lambda t: t.to(device) if isinstance(t, torch.Tensor) else t,
                    tree)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of one or more trees of one structure: dicts
    and lists are nodes, anything else (a tensor, the static ``mapping``
    tuple) is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in the JAX package's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def value_and_grad(fn, params):
    """``((value, aux), grads)`` of ``fn(params) -> (value, aux)``, as
    ``jax.value_and_grad(fn, has_aux=True)``: the gradient of the scalar
    ``value`` with respect to every tensor of ``params`` (a tree of
    floating-point tensors), as a tree of the same structure, zeros where
    ``value`` does not depend on a leaf.

    ``fn`` sees detached copies that require grad, so ``params`` is left
    as it is; ``value`` comes back detached.  The backward runs in a
    torch.profiler range named ``value_and_grad.backward``."""
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    leaves = tree_leaves(live)
    with torch.enable_grad():
        value, aux = fn(live)
        with record_function("value_and_grad.backward"):
            grads = torch.autograd.grad(value, leaves, allow_unused=True)
    by_leaf = {id(t): g if g is not None else torch.zeros_like(t)
               for t, g in zip(leaves, grads)}
    return (value.detach(), aux), tree_map(lambda t: by_leaf[id(t)], live)


@contextlib.contextmanager
def fp32_math():
    """cuDNN convolutions and cuBLAS matmuls in full fp32 inside the block:
    TF32 off (``cudnn.allow_tf32`` defaults to True), both flags restored
    on exit.  No effect on CPU tensors."""
    conv = torch.backends.cudnn.allow_tf32
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = matmul
