"""Skewness-manipulation losses (paper Eq. 1, Eq. 2, §4) and metrics, as in
``repro.core.skewness``.

Ties are real here (ReLU6 can zero a channel, which gives an importance
of exactly 0; an invalid row of ``agile_loss`` is one-hot), so the
subgradients follow JAX's: ``torch.amax`` / ``torch.amin`` and
``torch.maximum`` split the gradient evenly between equal values, and the
sorts are stable in JAX's tie order.
"""
from __future__ import annotations

import torch


def _relu(x: torch.Tensor) -> torch.Tensor:
    """max(0, x) with the gradient split evenly at x == 0 (jnp.maximum)."""
    return torch.maximum(x.new_zeros(()), x)


def disorder_loss(importance: torch.Tensor, k: int) -> torch.Tensor:
    """Eq. (1): max(0, max(I2) - min(I1)) averaged over the batch.

    importance: (B, C) normalized channel importances; the first k channels
    are the designated local (top-k) slots.  Non-zero iff any non-local
    channel out-ranks a local one."""
    viol = _relu(torch.amax(importance[:, k:], dim=-1)
                 - torch.amin(importance[:, :k], dim=-1))
    return torch.mean(viol)


def skewness_loss(importance: torch.Tensor, k: int, rho: float) -> torch.Tensor:
    """Eq. (2): max(0, rho - |I1|_1) averaged over the batch."""
    i1_mass = torch.sum(importance[:, :k], dim=-1)
    return torch.mean(_relu(rho - i1_mass))


def descent_loss(importance: torch.Tensor) -> torch.Tensor:
    """The strawman §4.1 L_descent = ||I - sort(I, desc)||^2 (the Figure-9
    ablation).  A stable descending sort: ties keep the lower channel
    first, as ``lax.top_k`` over all C channels does, so the gradient goes
    where JAX's goes."""
    i_sorted = torch.sort(importance, dim=-1, descending=True, stable=True).values
    return torch.mean(torch.sum((importance - i_sorted) ** 2, dim=-1))


def combined_loss(prediction_loss, importance, *, k: int, rho: float,
                  lam: float, ordering: str = "disorder"):
    """§4.2: L = lam * L_pred + (1 - lam) * (L_skew + L_disorder).

    ordering="descent" swaps in the strawman L_descent (full sort) for the
    Figure-9 ablation.  Returns (total, metrics dict)."""
    if ordering == "descent":
        l_dis = descent_loss(importance)
    else:
        l_dis = disorder_loss(importance, k)
    l_skew = skewness_loss(importance, k, rho)
    total = lam * prediction_loss + (1.0 - lam) * (l_skew + l_dis)
    return total, {
        "loss_prediction": prediction_loss,
        "loss_disorder": l_dis,
        "loss_skewness": l_skew,
    }


# --------------------------------------------------------------- metrics ---
def topk_mass(importance: torch.Tensor, k: int) -> torch.Tensor:
    """Per-sample cumulative normalized importance of the first k channels."""
    return torch.sum(importance[:, :k], dim=-1)


def achieved_skewness(importance: torch.Tensor, k: int) -> torch.Tensor:
    """Batch-mean top-k mass (compare against the rho requirement)."""
    return torch.mean(topk_mass(importance, k))


def disorder_rate(importance: torch.Tensor, k: int) -> torch.Tensor:
    """Fraction of samples where some non-local channel out-ranks a local
    one (the paper's '% disorder cases', target < 2%)."""
    viol = torch.amax(importance[:, k:], dim=-1) > torch.amin(importance[:, :k], dim=-1)
    return torch.mean(viol.float())


def natural_skewness(importance: torch.Tensor, frac: float = 0.2) -> torch.Tensor:
    """§2.3 metric: normalized importance mass of the top-`frac` channels
    (by rank, not by position) per sample.  An ascending stable sort,
    reversed, as JAX's ``jnp.sort(...)[:, ::-1]``: among tied values the
    higher channel ranks first."""
    C = importance.shape[-1]
    k = max(1, int(round(frac * C)))
    topv = torch.sort(importance, dim=-1, stable=True).values.flip(-1)[:, :k]
    return torch.sum(topv, dim=-1)
