"""AgileNN split serving for the LM backbones, as ``repro.core.agile_lm``.

The paper's technique applied at the token level: a weak edge device runs
a lightweight token-feature extractor (embedding + one gated projection);
its C channels are importance-skewed during training (the same skewness
losses, IG against a reference LM head) so the top-k channels feed a tiny
on-device next-token head, while the remaining C - k are quantized and
offloaded to the Remote NN, the full backbone, whose logits are
alpha-combined with the local head's.

  extractor   embed -> silu-gated dense -> (B, T, C)
  Local NN    last-token top-k channels -> dense -> vocab logits
  Remote NN   the backbone's final hidden states (``forward_hidden``)
              plus the quantized remote channels projected into d_model
  reference   a tracked LM head over the extractor features

Every tensor lies on the params' device.  On CUDA the quantizer's hard
half is the quantize kernel (one launch per forward), and the backbone
runs the flash-attention and RMSNorm kernels, whose backward kernels carry
the loss's gradient through it.  The IG importance differentiates twice
through the (detached) reference head only, never through the backbone.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import resolve_device, tree_map, tree_to
from repro_torch.compress.quantize import (
    dequantize,
    hard_indices,
    quantize_ste,
    quantizer_init,
)
from repro_torch.configs.base import ArchConfig
from repro_torch.core.agile import cross_entropy
from repro_torch.core.combiner import alpha_value, combine_predictions, combiner_init
from repro_torch.core.skewness import combined_loss
from repro_torch.core.splitter import split_features
from repro_torch.core.xai import evaluate_importance
from repro_torch.models import backbone as bb
from repro_torch.nn.activations import silu
from repro_torch.nn.linear import dense, dense_init, embedding, embedding_init


def init_agile_lm_params(cfg: ArchConfig, seed: int = 0, *, device=None) -> dict:
    """Extractor / local / combiner / quantizer + remote backbone +
    reference, from ``seed`` (the backbone from ``seed + 1``), drawn on the
    CPU and moved to ``device`` (CUDA by default; raises when CUDA is
    absent and no device was named).  Bridge JAX's params with
    ``repro_torch.bridge.agile_lm_params_from_numpy`` to compare."""
    a = cfg.agile
    C = a.extractor_channels
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params = {
        "extractor": {
            "embed": embedding_init(gen, cfg.vocab, C),
            "gate": dense_init(gen, C, C, use_bias=True),
            "proj": dense_init(gen, C, C, use_bias=False),
        },
        "local": dense_init(gen, a.k, cfg.vocab, use_bias=False),
        "remote_in": dense_init(gen, C - a.k, cfg.d_model, use_bias=False),
        "reference": dense_init(gen, C, cfg.vocab, use_bias=False),
        "combiner": combiner_init(0.5, a.alpha_temperature),
        "quant": quantizer_init(n_centers=8),
    }
    params = tree_to(params, device)
    params["backbone"] = bb.init_params(cfg, seed + 1, device=device)
    return params


def _tokens(params, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=params["quant"]["centers"].device).long()


def extract_token_features(params, tokens):
    """The on-device extractor: (B, T) -> (B, T, C)."""
    e = params["extractor"]
    x = embedding(e["embed"], _tokens(params, tokens))
    return dense(e["proj"], x * silu(dense(e["gate"], x)))


def agile_lm_forward(cfg: ArchConfig, params, tokens, *, train: bool = True,
                     alpha_override=None):
    """Next-token logits for the LAST position via the split pipeline.

    Returns (logits (B, vocab), internals)."""
    a = cfg.agile
    tokens = _tokens(params, tokens)
    feats = extract_token_features(params, tokens)          # (B, T, C)
    f_local, f_remote = split_features(feats, a.k)
    if train:
        f_remote_q = quantize_ste(params["quant"], f_remote)
    else:
        f_remote_q = dequantize(params["quant"],
                                hard_indices(params["quant"], f_remote))
    # local head: tiny dense on the last token's top-k channels
    local_logits = dense(params["local"], f_local[:, -1])
    # remote: backbone consumes token embeddings + projected remote features
    h = bb.forward_hidden(cfg, params["backbone"], {"tokens": tokens})
    h = h + dense(params["remote_in"], f_remote_q)
    w = bb._readout_weight(cfg, params["backbone"])
    remote_logits = h[:, -1].float() @ w.float()
    logits = combine_predictions(params["combiner"], local_logits,
                                 remote_logits,
                                 temperature=a.alpha_temperature,
                                 alpha_override=alpha_override)
    return logits, {
        "features": feats,
        "local_logits": local_logits,
        "remote_logits": remote_logits,
        "alpha": alpha_value(params["combiner"], a.alpha_temperature),
    }


def _token_importance(cfg: ArchConfig, ref_w, feats, targets, *,
                      method: str = "ig", steps: int = 8):
    """Channel importance of the LAST token's features under the reference
    head (a linear readout over extractor features)."""
    def predict(f):
        return dense(ref_w, f)

    return evaluate_importance(predict, feats[:, -1], targets, method=method,
                               steps=steps)


def agile_lm_loss(cfg: ArchConfig, params, tokens, labels_last, *,
                  xai_method: str = "ig"):
    """Unified loss on next-token prediction of the final position.
    Returns (loss, metrics), the metrics detached.

    tokens: (B, T); labels_last: (B,) the T+1-th token."""
    a = cfg.agile
    labels = _tokens(params, labels_last)
    logits, internals = agile_lm_forward(cfg, params, tokens, train=True)
    pred_loss = cross_entropy(logits, labels)

    ref_w = tree_map(lambda t: t.detach(), params["reference"])
    feats = internals["features"]
    imp = _token_importance(cfg, ref_w, feats, labels, method=xai_method,
                            steps=a.ig_steps)
    with torch.no_grad():
        valid = (torch.argmax(dense(ref_w, feats[:, -1]), -1) == labels).float()
    ideal = F.one_hot(torch.zeros(imp.shape[0], dtype=torch.long,
                                  device=imp.device), imp.shape[-1]).float()
    imp_eff = torch.where(valid[:, None] > 0, imp, ideal)
    total, metrics = combined_loss(pred_loss, imp_eff, k=a.k, rho=a.rho,
                                   lam=a.lam)
    # train the reference head alongside (tracking; stop-grad features)
    ref_ce = cross_entropy(dense(params["reference"], feats[:, -1].detach()), labels)
    total = total + 0.3 * ref_ce
    acc = torch.mean((torch.argmax(logits, -1) == labels).float())
    metrics.update(accuracy=acc, alpha=internals["alpha"],
                   xai_valid_fraction=torch.mean(valid), ref_ce=ref_ce)
    return total, {k: v.detach() for k, v in metrics.items()}


@torch.no_grad()
def offload_payload_bits(cfg: ArchConfig, params, tokens) -> int:
    """Bits the device would transmit per request (last-token remote
    channels, 3-bit codebook) - before LZW."""
    feats = extract_token_features(params, tokens)
    _, f_remote = split_features(feats, cfg.agile.k)
    return int(f_remote[:, -1].numel()) * 3
