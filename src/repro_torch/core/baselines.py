"""Comparison baselines (paper §7), as ``repro.core.baselines``:
edge-only, MCUNet-proxy (local-only), a DeepCOD-style learned sparse
encoder and SPINN-style early-exit partitioning.

Each baseline has init / loss pieces and a cost in the same
``DeviceModel`` accounting as AgileNN.  The inits take a seed where JAX
takes a key, draw on the CPU and move to ``device`` (CUDA by default;
raises when CUDA is absent and no device was named); bridge JAX's params
with ``repro_torch.bridge.params_from_numpy`` to compare.  The functions
run on the params' device, images (NHWC) and labels as numpy or tensors.
On CUDA the quantizer's hard half is the quantize kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device, tree_leaves, tree_to, value_and_grad
from repro_torch.compress.lzw import compress_payload, pack_indices
from repro_torch.compress.quantize import (
    dequantize,
    hard_indices,
    quantization_bits,
    quantize_ste,
    quantizer_init,
)
from repro_torch.configs.agilenn_cifar import AgileNNConfig
from repro_torch.core.agile import cross_entropy
from repro_torch.core.xai import _abs
from repro_torch.models.cnn import (
    conv_macs,
    extractor_apply,
    extractor_init,
    extractor_macs,
    local_nn_macs,
    remote_nn_apply,
    remote_nn_init,
)
from repro_torch.nn.linear import conv2d, conv2d_init, dense, dense_init
from repro_torch.optim.sgd import sgd_init, sgd_update
from repro_torch.serve.device_model import DeviceModel, InferenceCost


def _device(params) -> torch.device:
    return tree_leaves(params)[0].device


def _images(params, images) -> torch.Tensor:
    return torch.as_tensor(images, dtype=torch.float32, device=_device(params))


def _labels(params, labels) -> torch.Tensor:
    return torch.as_tensor(labels, device=_device(params)).long()


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ========================================================== edge-only ======
def edge_only_payload(images) -> int:
    """LZW on the raw uint8 image; returns total bytes for the batch."""
    arr = _numpy(images)
    arr = np.clip((arr - arr.min()) / max(float(np.ptp(arr)), 1e-6) * 255,
                  0, 255).astype(np.uint8)
    total = 0
    for b in range(arr.shape[0]):
        nbytes, _ = compress_payload(arr[b].tobytes())
        total += nbytes
    return total


def edge_only_cost(cfg: AgileNNConfig, images, *, remote_macs: float,
                   device: DeviceModel | None = None) -> InferenceCost:
    device = device or DeviceModel(cpu_hz=cfg.mcu_hz, link_bps=cfg.link_bps)
    payload = edge_only_payload(images) / images.shape[0]
    return InferenceCost(
        local_compute_s=device.compute_time(0.0), tx_s=device.tx_time(payload),
        server_s=device.server_time(remote_macs), payload_bytes=payload,
        local_macs=0.0, remote_macs=remote_macs)


# ================================================== MCUNet proxy (local) ===
def mcunet_init(seed: int, cfg: AgileNNConfig, *, width: int = 32,
                blocks: int = 4, device=None):
    """A NAS-proxy compact CNN executed fully on-device."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    p = {"stem": conv2d_init(gen, 3, width)}
    p["body"] = remote_nn_init(gen, width, cfg.n_classes, width=width,
                               blocks=blocks)
    return tree_to(p, device)


def mcunet_apply(params, images):
    x = torch.relu(conv2d(params["stem"], _images(params, images), stride=2))
    return remote_nn_apply(params["body"], x)


def mcunet_macs(cfg: AgileNNConfig, *, width: int = 32, blocks: int = 4) -> int:
    s = cfg.image_size
    total = conv_macs(s, s, 3, 3, width, stride=2)
    s //= 2
    # same structure as remote_nn_macs but starting at `width` input
    c = width
    total += s * s * c * width
    for i in range(blocks):
        cout = width * 2 if i >= blocks // 2 else width
        stride = 2 if i == blocks // 2 else 1
        mid = c * 4
        total += s * s * c * mid
        s //= stride
        total += s * s * mid * 9
        total += s * s * mid * cout
        c = cout
    return total + c * cfg.n_classes


def mcunet_cost(cfg: AgileNNConfig, *, device: DeviceModel | None = None,
                width: int = 32, blocks: int = 4) -> InferenceCost:
    device = device or DeviceModel(cpu_hz=cfg.mcu_hz, link_bps=cfg.link_bps)
    macs = mcunet_macs(cfg, width=width, blocks=blocks)
    return InferenceCost(local_compute_s=device.compute_time(macs), tx_s=0.0,
                         server_s=0.0, payload_bytes=0.0, local_macs=macs,
                         remote_macs=0.0)


# ================================================== DeepCOD-style encoder ==
def deepcod_init(seed: int, cfg: AgileNNConfig, *, code_channels: int = 0,
                 device=None):
    """Local learned encoder (extractor + 1x1 bottleneck) -> quantize ->
    remote decoder/classifier; trained end-to-end with an L1 sparsity
    penalty on the code.  code_channels defaults to AgileNN's transmitted
    channel count (C - k)."""
    code_channels = code_channels or (cfg.extractor_channels - cfg.agile.k)
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    p = {
        "ex": extractor_init(gen, channels=cfg.extractor_channels,
                             n_layers=cfg.extractor_layers),
        "bottleneck": conv2d_init(gen, cfg.extractor_channels, code_channels,
                                  kernel=1),
        "remote": remote_nn_init(gen, code_channels, cfg.n_classes,
                                 width=cfg.remote_width, blocks=cfg.remote_blocks),
        "quant": quantizer_init(n_centers=8),
    }
    return tree_to(p, device)


def deepcod_code(params, images):
    feats = extractor_apply(params["ex"], _images(params, images))
    return conv2d(params["bottleneck"], feats)


def deepcod_forward(params, images, *, train: bool = True):
    code = deepcod_code(params, images)
    code_q = quantize_ste(params["quant"], code) if train else \
        dequantize(params["quant"], hard_indices(params["quant"], code))
    logits = remote_nn_apply(params["remote"], code_q)
    return logits, code


def deepcod_loss(params, images, labels, *, sparsity_weight: float = 1e-3):
    labels = _labels(params, labels)
    logits, code = deepcod_forward(params, images, train=True)
    ce = cross_entropy(logits, labels)
    l1 = torch.mean(_abs(code))
    acc = torch.mean((torch.argmax(logits, -1) == labels).float())
    return ce + sparsity_weight * l1, {"ce": ce.detach(), "l1": l1.detach(),
                                       "accuracy": acc}


@torch.no_grad()
def deepcod_payload(params, images) -> int:
    idx = _numpy(hard_indices(params["quant"], deepcod_code(params, images)))
    bits = quantization_bits(params["quant"]["centers"].shape[0])
    total = 0
    for b in range(idx.shape[0]):
        nbytes, _ = compress_payload(pack_indices(idx[b], bits))
        total += nbytes
    return total


def deepcod_local_macs(cfg: AgileNNConfig, code_channels: int = 0) -> int:
    code_channels = code_channels or (cfg.extractor_channels - cfg.agile.k)
    feat_hw = cfg.image_size // (2 ** cfg.extractor_layers)
    return (extractor_macs(cfg.image_size, 3, cfg.extractor_channels,
                           cfg.extractor_layers)
            + feat_hw * feat_hw * cfg.extractor_channels * code_channels)


def deepcod_cost(cfg: AgileNNConfig, params, images, *, remote_macs: float,
                 device: DeviceModel | None = None,
                 code_channels: int = 0) -> InferenceCost:
    device = device or DeviceModel(cpu_hz=cfg.mcu_hz, link_bps=cfg.link_bps)
    payload = deepcod_payload(params, images) / images.shape[0]
    macs = deepcod_local_macs(cfg, code_channels)
    return InferenceCost(local_compute_s=device.compute_time(macs),
                         tx_s=device.tx_time(payload),
                         server_s=device.server_time(remote_macs),
                         payload_bytes=payload, local_macs=macs,
                         remote_macs=remote_macs)


# ===================================================== SPINN-style exits ===
def spinn_init(seed: int, cfg: AgileNNConfig, *, device=None):
    """Partitioned net with a local early-exit head: local = extractor +
    exit classifier; remote = full classifier on (quantized) features."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    p = {
        "ex": extractor_init(gen, channels=cfg.extractor_channels,
                             n_layers=cfg.extractor_layers),
        "exit": dense_init(gen, cfg.extractor_channels, cfg.n_classes),
        "remote": remote_nn_init(gen, cfg.extractor_channels, cfg.n_classes,
                                 width=cfg.remote_width,
                                 blocks=cfg.remote_blocks),
        "quant": quantizer_init(n_centers=8),
    }
    return tree_to(p, device)


def spinn_forward(params, images, *, train: bool = True):
    feats = extractor_apply(params["ex"], _images(params, images))
    exit_logits = dense(params["exit"], torch.mean(feats, dim=(1, 2)))
    fq = quantize_ste(params["quant"], feats) if train else \
        dequantize(params["quant"], hard_indices(params["quant"], feats))
    remote_logits = remote_nn_apply(params["remote"], fq)
    return exit_logits, remote_logits, feats


def spinn_loss(params, images, labels):
    labels = _labels(params, labels)
    exit_logits, remote_logits, _ = spinn_forward(params, images, train=True)
    ce = cross_entropy(remote_logits, labels) + 0.5 * cross_entropy(exit_logits, labels)
    acc = torch.mean((torch.argmax(remote_logits, -1) == labels).float())
    return ce, {"accuracy": acc}


@torch.no_grad()
def spinn_cost(cfg: AgileNNConfig, params, images, *, remote_macs: float,
               exit_threshold: float = 0.9,
               device: DeviceModel | None = None) -> InferenceCost:
    """Expected cost: early-exit samples stay local; the rest offload."""
    device = device or DeviceModel(cpu_hz=cfg.mcu_hz, link_bps=cfg.link_bps)
    exit_logits, _, feats = spinn_forward(params, images, train=False)
    conf = torch.max(torch.softmax(exit_logits, -1), dim=-1).values
    stay = _numpy(conf >= exit_threshold)
    idx = _numpy(hard_indices(params["quant"], feats))
    bits = quantization_bits(params["quant"]["centers"].shape[0])
    payload = 0
    for b in range(idx.shape[0]):
        if not stay[b]:
            nbytes, _ = compress_payload(pack_indices(idx[b], bits))
            payload += nbytes
    feat_hw = cfg.image_size // (2 ** cfg.extractor_layers)
    macs = (extractor_macs(cfg.image_size, 3, cfg.extractor_channels,
                           cfg.extractor_layers)
            + local_nn_macs(cfg.extractor_channels, cfg.n_classes, feat_hw))
    offload_frac = 1.0 - float(stay.mean())
    per_payload = payload / images.shape[0]
    return InferenceCost(local_compute_s=device.compute_time(macs),
                         tx_s=device.tx_time(per_payload),
                         server_s=device.server_time(remote_macs) * offload_frac,
                         payload_bytes=per_payload, local_macs=macs,
                         remote_macs=remote_macs * offload_frac)


# ------------------------------------------------------- generic trainer ---
def train_baseline(loss_fn, params, data, *, steps: int, batch_size: int = 32,
                   lr: float = 0.02, seed_base: int = 50_000):
    """SGD loop shared by the DeepCOD/SPINN/MCUNet baselines: ``loss_fn(
    params, images, labels) -> (loss, metrics)`` on ``data.batch``'s numpy
    batches, moved to the params' device.  Returns (params, the last
    step's metrics as floats)."""
    opt = sgd_init(params)
    dev = _device(params)
    metrics = {}
    for i in range(steps):
        images, labels = data.batch(batch_size, seed=seed_base + i)
        images = torch.as_tensor(images, device=dev)
        labels = torch.as_tensor(labels, device=dev)
        cur_lr = lr * (0.1 if i > steps * 0.7 else 1.0)
        (_, metrics), grads = value_and_grad(
            lambda p: loss_fn(p, images, labels), params)
        params, opt = sgd_update(params, grads, opt, lr=cur_lr)
    return params, {k: float(v) for k, v in metrics.items()}
