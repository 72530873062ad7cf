"""AgileNN joint model (paper Figure 5): extractor + Local NN + Remote NN
+ combiner + quantizer, with the XAI-driven skewness-manipulation loss.

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
(``kernels/quantize``).  Training (``agile_forward(train=True)``,
``agile_loss``) keeps JAX's two-pass composition: the permute kernel,
whose backward is the same kernel with the inverse permutation, then the
straight-through quantizer, whose hard half is the quantize kernel.
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch import resolve_device, tree_map, tree_to
from repro_torch.compress.quantize import (
    dequantize,
    hard_indices,
    quantize_ste,
    quantizer_init,
)
from repro_torch.configs.agilenn_cifar import AgileNNConfig
from repro_torch.core.combiner import alpha_value, combine_predictions, combiner_init
from repro_torch.core.skewness import combined_loss
from repro_torch.core.splitter import merge_features, split_features
from repro_torch.core.xai import evaluate_importance
from repro_torch.kernels.offload_fused.ops import fused_offload
from repro_torch.kernels.topk_split.ops import channel_permute_op
from repro_torch.models.cnn import (
    extractor_apply,
    extractor_init,
    local_nn_apply,
    local_nn_init,
    reference_nn_apply,
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
    """Extractor + the channel permutation (the training-time mapping
    layer, or the deployed one), differentiable in the extractor's
    params on either device."""
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


def _labels(params, labels) -> torch.Tensor:
    """Labels (numpy or tensor) as int64 on the params' device."""
    return torch.as_tensor(labels, device=params["quant"]["centers"].device).long()


def agile_forward(cfg: AgileNNConfig, params, images, *, train: bool = False,
                  quantize: bool = True, alpha_override=None,
                  use_fused: bool = True):
    """The split pipeline.  Returns (combined_logits, internals dict).

    The default is the deployment pipeline, ``repro``'s
    ``agile_forward(train=False)`` (hard quantization, the fused pass
    unless ``use_fused=False``); the JAX package defaults to
    ``train=True``.  ``train=True`` is the differentiable two-pass
    composition: permute, split, and the straight-through quantizer
    (``quantize=False`` skips the quantizer)."""
    if quantize and not train:
        f_local, f_remote, _, f_remote_q = _offload(cfg, params, images, use_fused)
        feats = merge_features(f_local, f_remote)
    else:
        feats = extract_features(cfg, params, images)
        f_local, f_remote = split_features(feats, cfg.agile.k)
        f_remote_q = (quantize_ste(params["quant"], f_remote) if quantize
                      else f_remote)
    local_logits = local_nn_apply(params["local"], f_local)
    remote_logits = remote_nn_apply(params["remote"], f_remote_q)
    logits = combine_predictions(params["combiner"], local_logits, remote_logits,
                                 temperature=cfg.agile.alpha_temperature,
                                 alpha_override=alpha_override)
    return logits, {
        "features": feats,
        "local_logits": local_logits,
        "remote_logits": remote_logits,
        "alpha": alpha_value(params["combiner"], cfg.agile.alpha_temperature),
    }


def reference_predict_fn(cfg: AgileNNConfig, ref_params) -> Callable:
    """predict(features) -> logits, for the XAI tool (the reference NN
    consumes the full extracted feature map, §3.1)."""
    def predict(feats):
        return reference_nn_apply(ref_params, feats)
    return predict


def batch_importance(cfg: AgileNNConfig, ref_params, feats, labels, *,
                     method: str = "ig"):
    """Normalized channel importance (B, C) + validity weights (B,).

    Per §3.1 the reference NN's output is only used when it predicts the
    training label correctly; other samples get weight 0 in the skewness
    losses.  labels: int64 tensor on the features' device."""
    predict = reference_predict_fn(cfg, ref_params)
    imp = evaluate_importance(predict, feats, labels, method=method,
                              steps=cfg.agile.ig_steps)
    with torch.no_grad():
        ref_pred = torch.argmax(predict(feats), dim=-1)
    valid = (ref_pred == labels).float()
    return imp, valid


def cross_entropy(logits, labels):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.mean(torch.gather(logp, -1, labels.long()[:, None]))


def agile_loss(cfg: AgileNNConfig, params, ref_params, images, labels, *,
               xai_method: str = "ig", ordering: str = "disorder",
               lam: "float | None" = None):
    """The unified training loss (§4.2).  Returns (loss, metrics), the
    metrics detached.

    The reference NN is detached (JAX's ``stop_gradient``); the gradient
    reaches the extractor through the features, through the XAI
    importance (a second derivative) as well as the prediction.
    ordering/lam overrides feed the Figure-9/Figure-10 ablations."""
    labels = _labels(params, labels)
    logits, internals = agile_forward(cfg, params, images, train=True)
    pred_loss = cross_entropy(logits, labels)

    imp, valid = batch_importance(cfg, tree_map(lambda t: t.detach(), ref_params),
                                  internals["features"], labels,
                                  method=xai_method)
    # invalid rows take an 'ideal' importance that gives zero loss: all
    # mass on channel 0
    B, C = imp.shape
    ideal = F.one_hot(torch.zeros(B, dtype=torch.long, device=imp.device),
                      C).float()
    imp_eff = torch.where(valid[:, None] > 0, imp, ideal)

    total, metrics = combined_loss(pred_loss, imp_eff, k=cfg.agile.k,
                                   rho=cfg.agile.rho,
                                   lam=cfg.agile.lam if lam is None else lam,
                                   ordering=ordering)
    acc = torch.mean((torch.argmax(logits, -1) == labels).float())
    metrics.update(accuracy=acc, alpha=internals["alpha"],
                   xai_valid_fraction=torch.mean(valid))
    return total, {k: v.detach() for k, v in metrics.items()}


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
