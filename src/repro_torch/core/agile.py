"""AgileNN joint model (paper Figure 5), deployment half: extractor + Local
NN + Remote NN + combiner + quantizer.

Parameter tree (plain dicts of tensors, as in ``repro.core.agile``):
  extractor   2-conv feature extractor (deployed on the weak device)
  local       GAP + dense Local NN (deployed on the weak device)
  remote      MobileNetV2-style Remote NN (deployed on the server)
  combiner    alpha = sigmoid(w / T)
  quant       scalar codebook for the offloaded channels
  mapping     the deployed channel permutation: a static tuple of ints

Every tensor of the tree lies on one device, the one ``init_agile_params``
or ``repro_torch.bridge.params_from_numpy`` was given; the functions here
run there.  On CUDA the offload pass is the fused kernel
(``kernels/offload_fused``), and ``use_fused=False`` runs its two unfused
halves, the permute (``kernels/topk_split``) and the quantizer
(``kernels/quantize``).  Training (XAI, skewness losses, STE) is not
ported yet.
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import torch

from repro_torch import resolve_device, tree_to
from repro_torch.compress.quantize import dequantize, hard_indices, quantizer_init
from repro_torch.configs.agilenn_cifar import AgileNNConfig
from repro_torch.core.combiner import alpha_value, combine_predictions, combiner_init
from repro_torch.core.splitter import merge_features, split_features
from repro_torch.kernels.offload_fused.ops import fused_offload
from repro_torch.kernels.topk_split.ops import channel_permute_op
from repro_torch.models.cnn import (
    extractor_apply,
    extractor_init,
    local_nn_apply,
    local_nn_init,
    remote_nn_apply,
    remote_nn_init,
)


def init_agile_params(cfg: AgileNNConfig, seed: int = 0, *, device=None) -> dict:
    """Fresh parameters from ``seed``, drawn on the CPU and moved to
    ``device`` (CUDA by default; raises when CUDA is absent and no device
    was named).  The mapping is the identity until channel selection runs."""
    device = resolve_device(device)
    C, k = cfg.extractor_channels, cfg.agile.k
    gen = torch.Generator().manual_seed(seed)
    params = {
        "extractor": extractor_init(gen, channels=C, n_layers=cfg.extractor_layers),
        "local": local_nn_init(gen, k, cfg.n_classes, hidden=cfg.local_hidden),
        "remote": remote_nn_init(gen, C - k, cfg.n_classes,
                                 width=cfg.remote_width, blocks=cfg.remote_blocks),
        "combiner": combiner_init(0.5, cfg.agile.alpha_temperature),
        "quant": quantizer_init(n_centers=8),
        "mapping": tuple(range(C)),
    }
    return tree_to(params, device)


def _images(params, images) -> torch.Tensor:
    """Images (numpy or tensor, NHWC) as float32 on the params' device."""
    return torch.as_tensor(images, dtype=torch.float32,
                           device=params["quant"]["centers"].device)


def extract_features(cfg: AgileNNConfig, params, images):
    """Extractor + the deployed channel permutation."""
    raw = extractor_apply(params["extractor"], _images(params, images))
    return channel_permute_op(raw, params["mapping"])


def _offload(cfg: AgileNNConfig, params, images, use_fused: bool):
    """(f_local, f_remote, idx, f_remote_q): one fused pass, or the
    permute and the quantizer as two passes; bit-identical either way."""
    if use_fused:
        raw = extractor_apply(params["extractor"], _images(params, images))
        return fused_offload(raw, params["quant"]["centers"],
                             perm=params["mapping"], k=cfg.agile.k)
    f_local, f_remote = split_features(extract_features(cfg, params, images),
                                       cfg.agile.k)
    idx = hard_indices(params["quant"], f_remote)
    return f_local, f_remote, idx, dequantize(params["quant"], idx)


def agile_forward(cfg: AgileNNConfig, params, images, *,
                  alpha_override=None, use_fused: bool = True):
    """The deployment pipeline, ``repro``'s ``agile_forward(train=False)``
    (hard quantization).  Returns (combined_logits, internals dict)."""
    f_local, f_remote, _, f_remote_q = _offload(cfg, params, images, use_fused)
    local_logits = local_nn_apply(params["local"], f_local)
    remote_logits = remote_nn_apply(params["remote"], f_remote_q)
    logits = combine_predictions(params["combiner"], local_logits, remote_logits,
                                 temperature=cfg.agile.alpha_temperature,
                                 alpha_override=alpha_override)
    return logits, {
        "features": merge_features(f_local, f_remote),
        "local_logits": local_logits,
        "remote_logits": remote_logits,
        "alpha": alpha_value(params["combiner"], cfg.agile.alpha_temperature),
    }


def device_forward(cfg: AgileNNConfig, params, images, *, use_fused: bool = True):
    """The device half of the deployment pipeline, batched: extractor ->
    permute/split/quantize -> Local NN, without the Remote-NN weights.
    Returns (local_logits (B, n_classes), f_remote (B, H, W, C-k), idx),
    bit-identical to the device-side tensors of ``agile_forward``."""
    f_local, f_remote, idx, _ = _offload(cfg, params, images, use_fused)
    return local_nn_apply(params["local"], f_local), f_remote, idx


def device_forward_fn(cfg: AgileNNConfig, params) -> Callable:
    """``fn(params, images) -> device_forward(...)`` on the fused path
    (the gateway fleet's batched device pass)."""
    return partial(device_forward, cfg)


def remote_forward(cfg: AgileNNConfig, params, f_remote_q, local_logits, *,
                   alpha_override=None):
    """The server half: Remote NN over the dequantized offloaded features
    + alpha-combine with the device's Local-NN logits.  Composing
    ``device_forward`` -> ``dequantize`` -> ``remote_forward`` is
    bit-identical to ``agile_forward``."""
    remote_logits = remote_nn_apply(params["remote"], f_remote_q)
    return combine_predictions(params["combiner"], local_logits, remote_logits,
                               temperature=cfg.agile.alpha_temperature,
                               alpha_override=alpha_override)


def agile_predict(cfg: AgileNNConfig, params, images, *, alpha_override=None):
    """Deployment-path prediction (hard quantization)."""
    return agile_forward(cfg, params, images, alpha_override=alpha_override)


def offload_payload_arrays(cfg: AgileNNConfig, params, images, *,
                           use_fused: bool = True):
    """What the device transmits: the hard quantization indices (int32) of
    the offloaded channels, to be bit-packed and LZW-coded."""
    return _offload(cfg, params, images, use_fused)[2]
