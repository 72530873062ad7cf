"""AgileNN inference runtime (paper Figure 5, fused online path).

Given AgileNN parameters, runs the deployment pipeline for a batch of
images and accounts every cost with the weak-device model:

  device:  extractor
           fused offload pass (one CUDA kernel over the feature stream:
             channel-permute -> (local, remote) split ->
             nearest-center indices + dequantized values)
           Local NN on the local half               (MACs -> t_compute)
           vectorized bit-pack (whole batch) -> per-sample LZW  (bytes)
  radio:   payload / bandwidth                     (t_tx)
  server:  Remote NN on the dequantized half       (t_server)
  device:  alpha-combine                           (negligible)

The tensors run on the params' device; ``measure_payload`` makes one
device->host copy of the indices per batch.  The costs are those of the
modelled weak device (``serve/device_model.py``), not GPU timings.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.compress.lzw import compress_payload, pack_indices_batch
from repro_torch.compress.quantize import quantization_bits
from repro_torch.configs.agilenn_cifar import AgileNNConfig
from repro_torch.core.agile import agile_forward, offload_payload_arrays
from repro_torch.models.cnn import extractor_macs, local_nn_macs
from repro_torch.serve.device_model import DeviceModel, InferenceCost


def local_path_macs(cfg: AgileNNConfig, feat_hw: int) -> int:
    """MACs of everything the weak device computes per inference
    (extractor + Local NN)."""
    return (extractor_macs(cfg.image_size, 3, cfg.extractor_channels,
                           cfg.extractor_layers)
            + local_nn_macs(cfg.agile.k, cfg.n_classes, feat_hw,
                            cfg.local_hidden))


def remote_nn_macs(cfg: AgileNNConfig, feat_hw: int) -> int:
    """Approximate Remote NN MACs (inverted residual stack)."""
    C = cfg.extractor_channels - cfg.agile.k
    w, b = cfg.remote_width, cfg.remote_blocks
    total = feat_hw * feat_hw * C * w                      # stem 1x1
    s, c = feat_hw, w
    for i in range(b):
        cout = w * 2 if i >= b // 2 else w
        stride = 2 if i == b // 2 else 1
        mid = c * 4
        total += s * s * c * mid                           # pw1
        s //= stride
        total += s * s * mid * 9                           # dw 3x3
        total += s * s * mid * cout                        # pw2
        c = cout
    total += c * cfg.n_classes
    return total


def measure_payload(cfg: AgileNNConfig, params, images, *,
                    use_fused: bool = True) -> tuple[int, np.ndarray]:
    """Exact transmitted bytes: quantize -> batched bit-pack -> LZW.

    One device->host copy and one vectorized packing pass for the whole
    batch; the LZW size is accounted per sample (each sample is an
    independent radio payload).  Returns (total bytes, indices as numpy)."""
    idx = offload_payload_arrays(cfg, params, images,
                                 use_fused=use_fused).cpu().numpy()
    bits = quantization_bits(params["quant"]["centers"].shape[0])
    total = 0
    for packed in pack_indices_batch(idx, bits):
        nbytes, _ = compress_payload(packed)
        total += nbytes
    return total, idx


def run_offload_inference(cfg: AgileNNConfig, params, images, *,
                          device: DeviceModel | None = None,
                          alpha_override=None):
    """Returns (predictions as numpy, InferenceCost averaged per sample).

    ``device`` is the weak-device cost model, as in the JAX package; the
    tensors run on the params' torch device."""
    device = device or DeviceModel(cpu_hz=cfg.mcu_hz, link_bps=cfg.link_bps,
                                   macs_per_cycle=cfg.mcu_macs_per_cycle)
    B = images.shape[0]
    logits, _ = agile_forward(cfg, params, images,
                              alpha_override=alpha_override)
    preds = torch.argmax(logits, dim=-1).cpu().numpy()

    feat_hw = cfg.image_size // (2 ** cfg.extractor_layers)
    local_macs = local_path_macs(cfg, feat_hw)
    payload_bytes, _ = measure_payload(cfg, params, images)
    payload_per_sample = payload_bytes / B
    r_macs = remote_nn_macs(cfg, feat_hw)

    cost = InferenceCost(
        local_compute_s=device.compute_time(local_macs),
        tx_s=device.tx_time(payload_per_sample),
        server_s=device.server_time(r_macs),
        payload_bytes=payload_per_sample,
        local_macs=local_macs,
        remote_macs=r_macs,
    )
    return preds, cost


def energy_per_inference(cfg: AgileNNConfig, cost: InferenceCost, *,
                         device: DeviceModel | None = None) -> float:
    device = device or DeviceModel(cpu_hz=cfg.mcu_hz, link_bps=cfg.link_bps)
    return device.energy(cost.local_macs, cost.payload_bytes)
