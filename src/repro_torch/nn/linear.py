"""Dense, conv and embedding primitives on channels-last tensors.

Weights: dense ``w`` is (in, out) as in the JAX package; conv ``w`` is
OIHW, torch's layout (the JAX package keeps HWIO; ``repro_torch.bridge``
transposes).  Activations stay NHWC at every public function.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn.init import he_normal, lecun_normal, normal


# ---------------------------------------------------------------- dense ----
def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, *,
               use_bias: bool = True) -> dict:
    p = {"w": lecun_normal(gen, (in_dim, out_dim), fan_in=in_dim)}
    if use_bias:
        p["b"] = torch.zeros(out_dim)
    return p


def dense(params, x):
    y = torch.matmul(x, params["w"])
    if "b" in params:
        y = y + params["b"]
    return y


# ----------------------------------------------------------------- conv ----
def conv2d_init(gen: torch.Generator, in_ch: int, out_ch: int,
                kernel: int = 3, *, use_bias: bool = True) -> dict:
    shape = (out_ch, in_ch, kernel, kernel)   # OIHW
    p = {"w": he_normal(gen, shape, fan_in=kernel * kernel * in_ch)}
    if use_bias:
        p["b"] = torch.zeros(out_ch)
    return p


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial axis: (low, high).

    A 3x3 stride-2 window over an even axis pads (0, 1), not torch's
    symmetric ``padding=1``, which would shift every output window."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv2d(params, x, *, stride: int = 1, groups: int = 1):
    """x: (B, H, W, C) NHWC -> (B, H', W', O) NHWC, "SAME" padding.

    ``groups=C`` is the depthwise conv (``feature_group_count`` in JAX)."""
    w = params["w"]
    kh, kw = w.shape[2], w.shape[3]
    ph = same_pads(x.shape[1], kh, stride)
    pw = same_pads(x.shape[2], kw, stride)
    xc = x.permute(0, 3, 1, 2)          # NCHW view of channels-last memory
    if ph != (0, 0) or pw != (0, 0):
        xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(xc, w, params.get("b"), stride=stride, groups=groups)
    return y.permute(0, 2, 3, 1)


# ------------------------------------------------------------ embedding ----
def embedding_init(gen: torch.Generator, vocab: int, dim: int) -> dict:
    return {"table": normal(gen, (vocab, dim), std=0.02)}


def embedding(params, ids):
    return params["table"][ids]


def embedding_attend(params, x):
    """Tied-readout logits: x @ table.T."""
    return x @ params["table"].T
