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
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


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
