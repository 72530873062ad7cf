"""Mixture-of-Experts layer: top-k routing with grouped capacity dispatch,
the port of ``repro.nn.moe``.

Tokens are cut into G groups of S tokens (``_pick_group_size``); each
group routes its tokens in float32 (router logits, softmax, top-k, the
gates renormalised to sum to 1), and each expert takes at most
C = min(S, max(4, int(capacity_factor * S * k / E))) of a group's routing
slots.  A slot's position in its expert counts slot-major, as the JAX
package's: every token's slot 0 first, then every token's slot 1, and so
on; slots at positions C and past are dropped (their token falls through
the residual).

The JAX package dispatches and combines by one-hot einsums over
(G, S, E, C) tensors.  The port computes the same ``keep`` mask and
positions and moves rows by index instead: the expert inputs are the
tokens copied into their (expert, position) rows, bitwise the one-hot
dispatch (which adds exact zeros), and the outputs are gathered back,
each weighted by its gate in float32, and summed over the k slots in
slot order.  At moonshot-v1-16b-a3b's prefill (S = 2,048, E = 64,
C = 768) the one-hot tensors would be 403 MB each in float32.

The expert SwiGLU is a batched product over (E, G * C, d) in the model's
dtype (``torch.bmm``), as the JAX package leaves it to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn.activations import silu
from repro_torch.nn.init import lecun_normal
from repro_torch.nn.linear import dense_init


def moe_init(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             **place) -> dict:
    """The router (d, E) and the stacked expert weights gate / up (E, d,
    d_ff) and down (E, d_ff, d); ``place``: ``dtype`` / ``device``."""
    def ek(a, b):
        return lecun_normal(gen, (n_experts, a, b), fan_in=a, **place)
    return {
        "router": dense_init(gen, d_model, n_experts, use_bias=False, **place),
        "gate": ek(d_model, d_ff),
        "up": ek(d_model, d_ff),
        "down": ek(d_ff, d_model),
    }


def _expert_ffn(params, x):
    """x: (E, C', d) -> (E, C', d) with per-expert SwiGLU weights."""
    g = silu(torch.bmm(x, params["gate"]))
    u = torch.bmm(x, params["up"])
    return torch.bmm(g * u, params["down"])


def _pick_group_size(N: int, target: int) -> int:
    """Largest power-of-two group size <= target that divides N (falls back
    to N itself for odd token counts)."""
    s = 1
    while s * 2 <= target and N % (s * 2) == 0:
        s *= 2
    return s if N % s == 0 else N


def top_k_stable(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of the last axis, ties
    to the lower index first, as ``jax.lax.top_k``: a stable descending
    sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(params, xt, top_k: int):
    """Router probabilities (..., E) in float32 and the renormalised top-k
    gates and experts (..., k)."""
    logits = xt.float() @ params["router"]["w"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k_stable(probs, top_k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_vals, expert_idx


def moe_routing(params, x, *, top_k: int, capacity_factor: float = 1.25,
                min_capacity: int = 4, group_size: int = 4096) -> dict:
    """The routing of x (B, T, d): the group size S and count G, the
    capacity C, the float32 router ``probs`` (G, S, E), ``gates`` and
    ``experts`` (G, S, k), and per routing slot in slot-major order
    (G, k * S): ``expert``, ``pos`` (its position in its expert) and
    ``keep`` (pos < C)."""
    B, T, _ = x.shape
    E = params["router"]["w"].shape[1]
    N = B * T
    S = _pick_group_size(N, group_size)
    G = N // S
    probs, gate_vals, expert_idx = _route(params, x.reshape(G, S, -1), top_k)
    capacity = min(max(min_capacity, int(capacity_factor * S * top_k / E)), S)
    expert = expert_idx.permute(0, 2, 1).reshape(G, top_k * S)
    onehot = F.one_hot(expert, E)                               # (G, k*S, E)
    pos = torch.gather(torch.cumsum(onehot, dim=1) - onehot, 2,
                       expert[..., None])[..., 0]
    return {"S": S, "G": G, "capacity": capacity, "probs": probs,
            "gates": gate_vals, "experts": expert_idx, "expert": expert,
            "pos": pos, "keep": pos < capacity}


def moe_apply(params, x, *, top_k: int, capacity_factor: float = 1.25,
              min_capacity: int = 4, group_size: int = 4096):
    """x: (B, T, d).  Returns (y (B, T, d) in x's dtype, aux) where aux
    holds the Switch load-balance loss and the fraction of routing slots
    dropped over capacity, both () float32 tensors."""
    B, T, d = x.shape
    E = params["router"]["w"].shape[1]
    r = moe_routing(params, x, top_k=top_k, capacity_factor=capacity_factor,
                    min_capacity=min_capacity, group_size=group_size)
    S, G, C, keep = r["S"], r["G"], r["capacity"], r["keep"]
    n_rows = E * G * C

    # dispatch: slot j of token (g, s) goes to row g * C + pos of its
    # expert's block; dropped slots go to a spare last row
    slot = torch.arange(top_k * S, device=x.device)
    grp = torch.arange(G, device=x.device)[:, None]
    row = r["expert"] * (G * C) + grp * C + r["pos"]            # (G, k*S)
    src = (grp * S + slot % S).reshape(-1)
    xe = x.new_zeros((n_rows + 1, d))
    xe.index_copy_(0, torch.where(keep, row, n_rows).reshape(-1),
                   x.reshape(B * T, d)[src])
    yout = _expert_ffn({k: params[k] for k in ("gate", "up", "down")},
                       xe[:n_rows].reshape(E, G * C, d)).reshape(n_rows, d)

    # combine in float32, slot by slot; a dropped slot weighs 0
    gates = r["gates"].permute(0, 2, 1).reshape(G, top_k * S) * keep
    picked = yout[torch.where(keep, row, 0)].float() * gates[..., None]
    y = picked.reshape(G, top_k, S, d).sum(dim=1)

    # Switch-style load-balance loss (over all tokens)
    density = F.one_hot(r["experts"][..., 0].reshape(-1), E).float().mean(0)
    mean_probs = r["probs"].reshape(-1, E).mean(0)
    lb_loss = E * torch.sum(density * mean_probs)
    # jnp.mean on XLA:CPU multiplies the sum by the float32 reciprocal of
    # the count; the same here keeps the dropped fraction bitwise JAX's
    inv_slots = (torch.ones((), dtype=torch.float32) / keep.numel()).item()
    aux = {"load_balance_loss": lb_loss,
           "dropped_fraction": 1.0 - keep.float().sum() * inv_slots}
    return y.reshape(B, T, d).to(x.dtype), aux


def moe_reference(params, x, *, top_k: int):
    """Oracle: loop over experts, no capacity limit (tests use small E)."""
    B, T, d = x.shape
    E = params["router"]["w"].shape[1]
    xt = x.reshape(-1, d)
    _, gate_vals, expert_idx = _route(params, xt, top_k)
    y = torch.zeros(xt.shape, dtype=torch.float32, device=x.device)
    for e in range(E):
        fe = (silu(xt @ params["gate"][e]) * (xt @ params["up"][e])) @ params["down"][e]
        w = torch.where(expert_idx == e, gate_vals, 0.0).sum(-1)
        y = y + w[:, None] * fe.float()
    return y.reshape(B, T, d).to(x.dtype)
