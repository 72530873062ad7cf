"""Local/remote prediction combination (paper §3.3).

final = alpha * local + (1 - alpha) * remote, with alpha = sigmoid(w / T).
"""
from __future__ import annotations

import math

import torch


def combiner_init(init_alpha: float = 0.5, temperature: float = 6.0) -> dict:
    """Parameterize so sigmoid(w/T) == init_alpha at start."""
    w = temperature * math.log(init_alpha / (1.0 - init_alpha))
    return {"w": torch.tensor(w, dtype=torch.float32)}


def alpha_value(params, temperature: float) -> torch.Tensor:
    return torch.sigmoid(params["w"] / temperature)


def combine_predictions(params, local_logits, remote_logits, *,
                        temperature: float = 6.0, alpha_override=None):
    """Weighted sum over aligned class channels; the runtime may override
    alpha (paper: user-tunable at deployment)."""
    a = (alpha_override if alpha_override is not None
         else alpha_value(params, temperature))
    return a * local_logits + (1.0 - a) * remote_logits
