"""Algorithm 1 (paper §5): select the k initial feature channels, as in
``repro.core.channel_selection``.

For every training sample, evaluate feature importance with the XAI tool
(against the pre-trained reference NN) and count, per channel, how often
the channel hosts one of the sample's top-k features.  The k channels with
the highest likelihood become the initial local channels; the training-
time mapping layer then permutes them into the first k slots.

The mapping is the port's static tuple of ints.  Conv kernels are OIHW
here (HWIO in the JAX package): the reference stem's input channels are
axis 1, the extractor conv's output channels axis 0.
"""
from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch
import torch.nn.functional as F


def topk_channel_counts(importance: torch.Tensor, k: int) -> torch.Tensor:
    """importance: (B, C) -> per-channel counts of top-k membership (C,),
    float32.  Ties go to the lower channel, as ``lax.top_k``: a stable
    descending sort, not ``torch.topk``, whose tie order is unspecified."""
    C = importance.shape[-1]
    idx = torch.sort(importance, dim=-1, descending=True, stable=True).indices[:, :k]
    return torch.sum(F.one_hot(idx, C).float(), dim=(0, 1))


def select_initial_channels(
        extractor: Callable, importance_fn: Callable,
        batches: Iterable, k: int) -> np.ndarray:
    """Run Algorithm 1 over a dataset.

    extractor(batch) -> features; importance_fn(features, batch) -> (B, C)
    normalized importances.  Returns the k selected channel indices, ranked
    by likelihood p_c (ties broken by channel id, like argsort)."""
    counts = None
    total = 0
    for batch in batches:
        feats = extractor(batch)
        imp = importance_fn(feats, batch)
        c = topk_channel_counts(imp, k)
        counts = c if counts is None else counts + c
        total += imp.shape[0]
    p = counts.cpu().numpy() / max(total, 1)       # p_c, line 9
    ranking = np.argsort(-p, kind="stable")        # line 10
    return ranking[:k]                             # line 11


def build_mapping_permutation(selected, n_channels: int) -> tuple:
    """The permutation (a static tuple) that moves ``selected`` channels to
    the first k slots (training-time mapping layer, §5 Figure 12;
    discarded after training by folding it into the extractor's final
    conv weights)."""
    selected = [int(c) for c in selected]
    rest = [c for c in range(n_channels) if c not in selected]
    return tuple(selected + rest)


def permute_reference_stem(ref_params: dict, perm) -> dict:
    """Permute the reference NN's stem input channels so it consumes
    *mapped* features: new ref(mapped_feats) == old ref(raw_feats).
    (mapped[c] = raw[perm[c]], so stem weight input channel c must become
    the old channel perm[c]: ``w[:, perm]`` in OIHW.)"""
    out = dict(ref_params)
    stem = dict(out["stem"])
    stem["w"] = ref_params["stem"]["w"][:, list(perm)]
    out["stem"] = stem
    return out


def fold_permutation_into_conv(conv_params: dict, perm) -> dict:
    """Discard the mapping layer by permuting the extractor's last conv's
    output channels (weights OIHW, bias (O,)): after this the extractor
    emits features already in mapped order, at zero runtime cost (the
    paper's 'mapping layer is discarded')."""
    out = dict(conv_params)
    out["w"] = conv_params["w"][list(perm)]
    if "b" in conv_params:
        out["b"] = conv_params["b"][list(perm)]
    return out
