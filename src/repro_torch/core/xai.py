"""XAI feature-attribution tools (paper §2.2, §7.7), as in
``repro.core.xai``.

Both tools attribute a model's output to the *extracted feature channels*
(not raw pixels): given features F (B, ..., C) and a prediction function
``predict(features) -> confidence scores (B, n_classes)``, they return a
per-channel importance map the same shape as F.

Integrated Gradients [Sundararajan et al. 2017]:
    IG_i = (F_i - F0_i) * mean_{s=1..m} d predict(F0 + s/m (F - F0))_y / dF_i
Gradient Saliency: |d predict(F)_y / dF_i|.

Each gradient is ``torch.autograd.grad`` with respect to the features
only.  When the features require grad (and grad mode is on) the graph is
kept (``create_graph``), so the importance is differentiable in them, as
JAX's ``grad`` inside a traced loss is: AgileNN's training loss takes a
second derivative through it.  On detached features nothing is kept.
The interpolation steps run in ``lax.scan``'s order, summed in fp32.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.profiler import record_function


def _abs(x):
    """|x| with JAX's derivative at 0, +1 (``torch.abs`` gives 0 there): IG
    at an all-zero feature is |0 * acc|, whose gradient JAX takes as acc.
    Adding 0.0 turns a -0.0 into +0.0, so the values are ``torch.abs``'s."""
    return torch.where(x >= 0, x, -x) + 0.0


def _target_scores(predict: Callable, feats, targets):
    """Confidence score of the target class per sample."""
    probs = torch.softmax(predict(feats).float(), dim=-1)
    return torch.gather(probs, -1, targets.long()[:, None])[:, 0]


def _score_grad(predict: Callable, f, targets):
    """d sum_b score_y(f) / d f; differentiable in f when f requires grad."""
    create = f.requires_grad and torch.is_grad_enabled()
    with torch.enable_grad():
        if not create:
            f = f.detach().requires_grad_()
        score = torch.sum(_target_scores(predict, f, targets))
        (g,) = torch.autograd.grad(score, f, create_graph=create)
    return g


def gradient_saliency(predict: Callable, feats, targets) -> torch.Tensor:
    """|d score_y / d feats| — one gradient pass."""
    return _abs(_score_grad(predict, feats, targets).float())


def integrated_gradients(predict: Callable, feats, targets, *,
                         steps: int = 16, baseline=None) -> torch.Tensor:
    """Path integral of gradients from ``baseline`` (default zeros) to
    feats, over ``steps`` interpolation points (AgileSpec.ig_steps).  Runs
    in a torch.profiler range named ``xai.integrated_gradients``."""
    with record_function("xai.integrated_gradients"):
        if baseline is None:
            baseline = torch.zeros_like(feats)
        delta = feats - baseline
        acc = torch.zeros(feats.shape, dtype=torch.float32, device=feats.device)
        for i in range(steps):
            alpha = (i + 1.0) / steps
            g = _score_grad(predict, baseline + alpha * delta, targets)
            acc = acc + g.float()
        return _abs(delta.float() * acc / steps)


def channel_importance(attr: torch.Tensor) -> torch.Tensor:
    """Aggregate an attribution map (B, ..., C) to per-channel importance
    (B, C), normalized to sum 1 (the paper's 'normalized importance')."""
    reduce_dims = tuple(range(1, attr.dim() - 1))
    imp = torch.sum(attr, dim=reduce_dims) if reduce_dims else attr
    total = torch.sum(imp, dim=-1, keepdim=True)
    return imp / torch.maximum(total, total.new_tensor(1e-12))


def evaluate_importance(predict: Callable, feats, targets, *,
                        method: str = "ig", steps: int = 16) -> torch.Tensor:
    """Normalized per-channel importance (B, C).  method: 'ig' | 'saliency'."""
    if method == "ig":
        attr = integrated_gradients(predict, feats, targets, steps=steps)
    elif method == "saliency":
        attr = gradient_saliency(predict, feats, targets)
    else:
        raise ValueError(f"unknown XAI method: {method}")
    return channel_importance(attr)
