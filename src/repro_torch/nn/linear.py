"""Dense, conv and embedding primitives on channels-last tensors.

Weights: dense ``w`` is (in, out) as in the JAX package; conv ``w`` is
OIHW / OIW, torch's layout (the JAX package keeps HWIO / WIO;
``repro_torch.bridge`` transposes).  Activations stay channels-last (NHWC,
NWC) at every public function.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn.init import he_normal, lecun_normal, normal


# ---------------------------------------------------------------- dense ----
def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, *,
               use_bias: bool = True, dtype=torch.float32, device=None,
               std: float | None = None) -> dict:
    """``w`` (in, out) lecun-normal (normal of ``std`` when given, as the
    sLSTM's recurrent weight) and ``b`` zeros, in ``dtype`` on ``device``
    (the generator's when None)."""
    if std is None:
        w = lecun_normal(gen, (in_dim, out_dim), fan_in=in_dim, dtype=dtype,
                         device=device)
    else:
        w = normal(gen, (in_dim, out_dim), std=std, dtype=dtype, device=device)
    p = {"w": w}
    if use_bias:
        p["b"] = torch.zeros(out_dim, dtype=dtype, device=w.device)
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

    ``groups=C`` is the depthwise conv (``feature_group_count`` in JAX).
    Where a gradient may be taken the conv is ``_Conv2d``: a first-order
    backward launches the same cuDNN kernels as autograd's own, and a
    second derivative is one grouped conv instead of one per group.
    Without a graph it is ``F.conv2d``, which spares the Function's host
    cost on the inference paths (``scripts/conv_backward_ab.py`` times
    both)."""
    w = params["w"]
    kh, kw = w.shape[2], w.shape[3]
    ph = same_pads(x.shape[1], kh, stride)
    pw = same_pads(x.shape[2], kw, stride)
    xc = x.permute(0, 3, 1, 2)          # NCHW view of channels-last memory
    if ph != (0, 0) or pw != (0, 0):
        xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
    b = params.get("b")
    if torch.is_grad_enabled() and (xc.requires_grad or w.requires_grad or (
            b is not None and b.requires_grad)):
        y = _Conv2d.apply(xc, w, b, stride, groups)
    else:
        y = F.conv2d(xc, w, b, stride=stride, groups=groups)
    return y.permute(0, 2, 3, 1)


class _Conv2d(torch.autograd.Function):
    """``F.conv2d`` (no padding) whose backward is itself made of
    differentiable convolutions: the input's gradient is
    ``conv_transpose2d``, the weight's the convolution's weight gradient,
    each computed only when asked for.

    Autograd's own second derivative of a convolution
    (``_convolution_double_backward``) computes the weight's term even when
    the weight needs no gradient, and for a grouped conv it does so one
    group at a time: one conv launch per channel of the depthwise conv, at
    every IG step of AgileNN's loss.  Through this Function the second
    derivative is the transposed conv's own backward, one grouped call."""

    @staticmethod
    def forward(ctx, x, w, b, stride, groups):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.groups, ctx.has_bias = stride, groups, b is not None
        return F.conv2d(x, w, b, stride=stride, groups=groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        s = ctx.stride
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            # the rows and columns a stride-s window never reaches
            pad = [x.shape[d] - ((g.shape[d] - 1) * s + w.shape[d]) for d in (2, 3)]
            gx = F.conv_transpose2d(g, w, stride=s, output_padding=pad,
                                    groups=ctx.groups)
        if ctx.needs_input_grad[1]:
            gw = torch.ops.aten.convolution_backward(
                g, x, w, None, [s, s], [0, 0], [1, 1], False, [0, 0],
                ctx.groups, (False, True, False))[1]
        if ctx.has_bias and ctx.needs_input_grad[2]:
            gb = g.sum(dim=(0, 2, 3))
        return gx, gw, gb, None, None


def conv1d_init(gen: torch.Generator, in_ch: int, out_ch: int, kernel: int, *,
                use_bias: bool = True, groups: int = 1, **place) -> dict:
    """``w`` (out, in / groups, kernel), torch's OIW (the JAX package keeps
    WIO), he-normal over the kernel x in / groups inputs of an output, as
    JAX's ``conv1d_init`` with its ``in_ch`` the group's; ``b`` zeros."""
    w = he_normal(gen, (out_ch, in_ch // groups, kernel), fan_in=kernel * (in_ch // groups),
                  **place)
    p = {"w": w}
    if use_bias:
        p["b"] = torch.zeros(out_ch, dtype=w.dtype, device=w.device)
    return p


def conv1d(params, x, *, stride: int = 1, padding: str = "SAME", groups: int = 1):
    """x: (B, T, C) NWC -> (B, T', O), a cross-correlation as XLA's with
    "SAME" (XLA's asymmetric pads, ``same_pads``) or "VALID" padding;
    ``groups`` is JAX's ``feature_group_count`` (``groups=C``: depthwise,
    as the Mamba block's causal conv after its own left pad)."""
    w = params["w"]
    xc = x.transpose(1, 2)
    if padding == "SAME":
        lo, hi = same_pads(x.shape[1], w.shape[2], stride)
        xc = F.pad(xc, (lo, hi))
    elif padding != "VALID":
        raise ValueError(f"padding {padding!r}: \"SAME\" or \"VALID\"")
    return F.conv1d(xc, w, params.get("b"), stride=stride,
                    groups=groups).transpose(1, 2)


# ------------------------------------------------------------ embedding ----
def embedding_init(gen: torch.Generator, vocab: int, dim: int, *,
                   dtype=torch.float32, device=None) -> dict:
    return {"table": normal(gen, (vocab, dim), std=0.02, dtype=dtype,
                            device=device)}


def embedding(params, ids):
    return params["table"][ids]


def embedding_attend(params, x):
    """Tied-readout logits: x @ table.T."""
    return x @ params["table"].T
