"""CNNs of the AgileNN system (paper §6-7), NHWC in and out.

- feature extractor: 2 conv layers x 24 channels, stride 2 each ->
  (B, H/4, W/4, 24) feature maps.
- Local NN: global-average-pool + one dense layer.
- Remote NN: MobileNetV2-style inverted-residual stack over the
  offloaded feature channels, GroupNorm per pixel.
- Reference NN: a wider/deeper Remote NN over the full feature map.

Convs and dense layers are ``F.conv2d`` / ``torch.matmul``: the JAX
package leaves them to XLA, outside any Pallas kernel.
"""
from __future__ import annotations

import torch

from repro_torch.nn.linear import conv2d, conv2d_init, dense, dense_init
from repro_torch.nn.norm import groupnorm, groupnorm_init


def _relu6(x):
    """min(max(x, 0), 6).  Where a gradient is taken it is the JAX
    package's form, whose derivative is 0.5 at exactly 0 and 6 (ties split
    evenly; ``torch.clamp`` gives 1 there, and zero preactivations are
    common: zero biases at init over all-zero windows); otherwise the same
    values in one ``clamp``."""
    if x.requires_grad:
        return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_full((), 6.0))
    return torch.clamp(x, 0.0, 6.0)


# ------------------------------------------------------------- extractor ---
def extractor_init(gen: torch.Generator, in_ch: int = 3, channels: int = 24,
                   n_layers: int = 2) -> dict:
    layers, c = [], in_ch
    for _ in range(n_layers):
        layers.append(conv2d_init(gen, c, channels, kernel=3))
        c = channels
    return {"convs": layers}


def extractor_apply(params, x):
    """x: (B, H, W, 3) -> contiguous (B, H/2^L, W/2^L, C)."""
    for conv in params["convs"]:
        x = _relu6(conv2d(conv, x, stride=2))
    return x.contiguous()


# --------------------------------------------------------------- local NN --
def local_nn_init(gen: torch.Generator, k: int, n_classes: int,
                  hidden: int = 0) -> dict:
    if hidden:
        return {"fc": dense_init(gen, k, hidden),
                "fc2": dense_init(gen, hidden, n_classes)}
    return {"fc": dense_init(gen, k, n_classes)}


def local_nn_apply(params, feats_local):
    """feats_local: (B, H, W, k) -> logits (B, n_classes).  GAP + dense."""
    x = dense(params["fc"], torch.mean(feats_local, dim=(1, 2)))
    if "fc2" in params:
        x = dense(params["fc2"], torch.relu(x))
    return x


def local_nn_macs(k: int, n_classes: int, feat_hw: int, hidden: int = 0) -> int:
    """Multiply-accumulate count of the Local NN (for the MCU cost model)."""
    gap = feat_hw * feat_hw * k
    if hidden:
        return gap + k * hidden + hidden * n_classes
    return gap + k * n_classes


# ---------------------------------------------- MobileNetV2-ish remote NN --
def _inverted_residual_init(gen: torch.Generator, cin: int, cout: int, *,
                            expand: int = 4) -> dict:
    mid = cin * expand
    return {
        "pw1": conv2d_init(gen, cin, mid, kernel=1, use_bias=False),
        "dw": conv2d_init(gen, 1, mid, kernel=3, use_bias=False),  # depthwise
        "pw2": conv2d_init(gen, mid, cout, kernel=1, use_bias=False),
        "n1": groupnorm_init(mid), "n2": groupnorm_init(mid),
        "n3": groupnorm_init(cout),
    }


def _inverted_residual_apply(p, x, *, stride: int = 1):
    cin = x.shape[-1]
    mid = p["n1"]["scale"].shape[0]
    h = _relu6(groupnorm(p["n1"], conv2d(p["pw1"], x), groups=8))
    h = _relu6(groupnorm(p["n2"], conv2d(p["dw"], h, stride=stride, groups=mid),
                         groups=8))
    h = groupnorm(p["n3"], conv2d(p["pw2"], h), groups=8)
    if stride == 1 and h.shape[-1] == cin:
        h = h + x
    return h


def remote_nn_init(gen: torch.Generator, in_ch: int, n_classes: int, *,
                   width: int = 64, blocks: int = 6) -> dict:
    p = {"stem": conv2d_init(gen, in_ch, width, kernel=1, use_bias=False),
         "stem_n": groupnorm_init(width)}
    c, blist = width, []
    for i in range(blocks):
        cout = width * 2 if i >= blocks // 2 else width
        blist.append(_inverted_residual_init(gen, c, cout))
        c = cout
    p["blocks"] = blist
    p["fc"] = dense_init(gen, c, n_classes)
    return p


def remote_nn_apply(params, feats):
    """feats: (B, H, W, C_remote) -> logits (B, n_classes)."""
    x = _relu6(groupnorm(params["stem_n"], conv2d(params["stem"], feats),
                         groups=8))
    n = len(params["blocks"])
    for i, b in enumerate(params["blocks"]):
        x = _inverted_residual_apply(b, x, stride=2 if i == n // 2 else 1)
    return dense(params["fc"], torch.mean(x, dim=(1, 2)))


# ----------------------------------------------------------- reference NN --
def reference_nn_init(gen: torch.Generator, in_ch: int, n_classes: int, *,
                      width: int = 96, blocks: int = 8) -> dict:
    return remote_nn_init(gen, in_ch, n_classes, width=width, blocks=blocks)


reference_nn_apply = remote_nn_apply


# ------------------------------------------------------------ cost model ---
def conv_macs(h: int, w: int, kernel: int, cin: int, cout: int,
              stride: int = 1) -> int:
    return (h // stride) * (w // stride) * kernel * kernel * cin * cout


def extractor_macs(image_size: int, in_ch: int = 3, channels: int = 24,
                   n_layers: int = 2) -> int:
    total, s, c = 0, image_size, in_ch
    for _ in range(n_layers):
        total += conv_macs(s, s, 3, c, channels, stride=2)
        s //= 2
        c = channels
    return total
