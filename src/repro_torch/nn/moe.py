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
C = 768) the one-hot tensors would be 403 MB each in float32.  Under a
gradient the router (through the softmax and the top-k values), the
gates, the stacked experts and x get the gradients JAX's one-hot einsums
give them (``tests/test_torch_moe_train.py``), bitwise the same from run
to run on the card (no float atomics on the way).

The expert SwiGLU is a batched product over (E, G * C, d) in the model's
dtype (``torch.bmm``), as the JAX package leaves it to XLA.

Under a mesh (a DTensor x) the layer computes the same function on the
experts' placed blocks, as GSPMD lowers the JAX package's einsums: each
rank routes its own groups, partial sums over the mesh dims that split
the experts or their ff axis, an all-to-all over those that split both
the experts and the rows (the meshed section below).
"""
from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

from repro_torch import sharded
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


def _dispatch_combine(weights, x, r, *, top_k: int, slab=None):
    """The experts' part of the layer on routing ``r`` of x (G * S, d):
    the kept slots copied into their expert's rows, the experts run, and
    the rows gathered back, each weighted by its gate, summed over the k
    slots in float32.  Returns y (G, S, d) float32.

    ``slab`` (meshed): which experts these weights hold, as ``_Slab``: a
    slot of another expert weighs 0 here (another rank adds it), and with
    an exchange group the rows travel to the ranks that hold their experts
    and back (an all-to-all each way)."""
    S, G, C = r["S"], r["G"], r["capacity"]
    d = x.shape[-1]
    if slab is None:
        slot, mine, n_slab = r["expert"], r["keep"], weights["gate"].shape[0]
    else:
        slot = slab.slot[r["expert"]]
        mine = r["keep"] & (slot >= 0)
        n_slab = slab.slot_count
    n_rows = n_slab * G * C

    # dispatch: slot j of token (g, s) goes to row g * C + pos of its
    # expert's block; dropped slots go to a spare last row.  The slots'
    # copies of the tokens are an expand over k (slot-major, as the slots
    # are ordered), whose backward sums the k copies of a token in a fixed
    # order; index_copy_'s backward is a gather of the rows, so the
    # gradient of x is bitwise the same from run to run on the card
    grp = torch.arange(G, device=x.device)[:, None]
    row = slot * (G * C) + grp * C + r["pos"]                   # (G, k*S)
    slots = x.reshape(G, 1, S, d).expand(G, top_k, S, d).reshape(G * top_k * S, d)
    xe = x.new_zeros((n_rows + 1, d))
    xe.index_copy_(0, torch.where(mine, row, n_rows).reshape(-1), slots)
    if slab is None or slab.group is None:
        yout = _expert_ffn(weights, xe[:n_rows].reshape(n_slab, G * C, d)).reshape(n_rows, d)
    else:
        yout = _exchange_ffn(weights, xe[:n_rows], slab)

    # combine in float32, slot by slot; a dropped slot weighs 0.  Kept
    # slots gather distinct rows; dropped ones all gather row 0 with gate 0,
    # so in the gather's backward (an accumulating index_put, sorted by row
    # on the card) row 0 takes exact zeros beside its own slot's gradient
    gates = r["gates"].permute(0, 2, 1).reshape(G, top_k * S) * mine
    picked = yout[torch.where(mine, row, 0)].float() * gates[..., None]
    return picked.reshape(G, top_k, S, d).sum(dim=1)


def moe_apply(params, x, *, top_k: int, capacity_factor: float = 1.25,
              min_capacity: int = 4, group_size: int = 4096):
    """x: (B, T, d).  Returns (y (B, T, d) in x's dtype, aux) where aux
    holds the Switch load-balance loss and the fraction of routing slots
    dropped over capacity, both () float32 tensors.  A DTensor x runs the
    meshed layer (``_moe_meshed``): the same function, computed where the
    params and rows are placed."""
    if sharded.is_dtensor(x):
        return _moe_meshed(params, x, top_k=top_k, capacity_factor=capacity_factor,
                           min_capacity=min_capacity, group_size=group_size)
    B, T, d = x.shape
    E = params["router"]["w"].shape[1]
    r = moe_routing(params, x, top_k=top_k, capacity_factor=capacity_factor,
                    min_capacity=min_capacity, group_size=group_size)
    y = _dispatch_combine({k: params[k] for k in ("gate", "up", "down")}, x, r,
                          top_k=top_k)

    # Switch-style load-balance loss (over all tokens)
    density = F.one_hot(r["experts"][..., 0].reshape(-1), E).float().mean(0)
    mean_probs = r["probs"].reshape(-1, E).mean(0)
    lb_loss = E * torch.sum(density * mean_probs)
    keep = r["keep"]
    # jnp.mean on XLA:CPU multiplies the sum by the float32 reciprocal of
    # the count; the same here keeps the dropped fraction bitwise JAX's
    inv_slots = (torch.ones((), dtype=torch.float32) / keep.numel()).item()
    aux = {"load_balance_loss": lb_loss,
           "dropped_fraction": 1.0 - keep.float().sum() * inv_slots}
    return y.reshape(B, T, d).to(x.dtype), aux


# ------------------------------------------------------------- meshed ---
# Under a mesh the params sit at the JAX package's placements
# (``launch/partition.py``): the stacked experts over the model axes (E
# dividing them), else their ff axis; with ``Strategy.expert_data_sharding``
# the experts over the data axes and ff over the model axes; under FSDP a
# further split over the data axes.  The layer computes on those blocks, as
# GSPMD lowers the JAX package's einsums:
#
#   * rows: each rank routes its own whole groups (x's split of the rows
#     where it divides G, else gathered first: ``sharded.whole_groups``);
#     S, G and C are the unsharded layer's, positions count per group;
#   * a mesh dim that splits the experts but not the rows: each rank runs
#     its experts on the rows dispatched to them, the other slots weigh 0,
#     and y is a partial sum over that dim (kept float32, summed before the
#     cast);
#   * a mesh dim that splits ff but not the rows: each rank runs every
#     expert on its ff slice, y a partial sum again;
#   * a mesh dim that splits both the experts and the rows: each rank
#     dispatches its groups into (E, G_l * C, d), an all-to-all sends each
#     expert's block to the rank that holds it, that rank runs its experts
#     on every rank's slots, and an all-to-all brings them back (several
#     such dims: one all-to-all over their joint group, major to minor);
#   * any other split (FSDP's over the data axes, d's) is gathered.
#
# The aux sums (density, router probabilities, kept slots) are summed over
# the dims that split the rows.  Gradients: where y is a partial sum, the
# gradients of the dispatched x and of the gates are summed over those
# dims (``sharded.SumGrad``, Megatron's f), so that x, the router and the routing
# get whole gradients on every rank there; an expert block's gradient is a
# partial sum only over the dims that split the rows and not the experts.

_EXPERT_FF_AXIS = {"gate": 2, "up": 2, "down": 1}       # (E, d, ff), (E, ff, d)


class _Slab:
    """The experts a rank's dispatch buffer holds rows for, in order:
    ``slot`` (E,) maps an expert to its place in the buffer (-1: handled
    by another rank), ``slot_count`` places; ``group`` (None, or the
    all-to-all's (mesh, dim)) exchanges the buffer's equal chunks."""

    def __init__(self, slot, slot_count: int, group):
        self.slot, self.slot_count, self.group = slot, slot_count, group


def _expert_roles(params, rows: set, ndim: int) -> list:
    """Per mesh dim, how the layer uses the experts' placement there: "A"
    (experts split, rows split: the all-to-all), "E" (experts split, rows
    not), "F" (ff split, rows not), or None (gathered).  The three stacked
    leaves must agree, else the dim is gathered."""
    from torch.distributed.tensor import Shard

    roles = []
    for i in range(ndim):
        seen = set()
        for name, ff in _EXPERT_FF_AXIS.items():
            t = params[name]
            p = t.placements[i] if sharded.is_dtensor(t) else None
            if isinstance(p, Shard) and p.dim == 0:
                seen.add("A" if i in rows else "E")
            elif isinstance(p, Shard) and p.dim == ff and i not in rows:
                seen.add("F")
            else:
                seen.add(None)
        roles.append(seen.pop() if len(seen) == 1 else None)
    return roles


def _slab(mesh, roles: list, E: int, device) -> "_Slab | None":
    """The experts this rank dispatches to: with the experts split over
    the dims of ``roles`` "A" and "E", the blocks whose "E" coordinates
    are this rank's, one block for each rank of the "A" dims' joint group,
    in that group's order (major to minor).  None when no dim splits the
    experts."""
    e_dims = [i for i, ro in enumerate(roles) if ro in ("A", "E")]
    if not e_dims:
        return None
    a_dims = [i for i in e_dims if roles[i] == "A"]
    coord = mesh.get_coordinate()
    n_blocks, n_a = 1, 1
    for i in e_dims:
        n_blocks *= mesh.size(i)
    for i in a_dims:
        n_a *= mesh.size(i)
    per = E // n_blocks
    slot = [-1] * E
    for j, digits in enumerate(itertools.product(*(range(mesh.size(i)) for i in a_dims))):
        where = dict(zip(a_dims, digits))
        b = 0
        for i in e_dims:
            b = b * mesh.size(i) + where.get(i, coord[i])
        slot[b * per:(b + 1) * per] = range(j * per, (j + 1) * per)
    return _Slab(torch.tensor(slot, device=device), per * n_a,
                 sharded.Group(mesh, a_dims).spec)


def _exchange_ffn(weights, xe, slab: _Slab):
    """xe (n * E_l * GC, d): this rank's slots for the n ranks of the
    exchange group, E_l experts each.  Returns the experts' outputs for
    these slots, laid out as xe: the chunks go out, each rank runs its E_l
    experts on the n chunks it receives, and the results come back."""
    from torch.distributed import _functional_collectives as fc

    E_l, d = weights["gate"].shape[0], xe.shape[-1]
    n = slab.slot_count // E_l
    gc = xe.shape[0] // slab.slot_count
    recv = fc.all_to_all_single_autograd(xe.contiguous(), None, None, slab.group)
    recv = recv.reshape(n, E_l, gc, d).transpose(0, 1).reshape(E_l, n * gc, d)
    out = _expert_ffn(weights, recv)
    out = out.reshape(E_l, n, gc, d).transpose(0, 1).reshape(n * E_l * gc, d)
    return fc.all_to_all_single_autograd(out.contiguous(), None, None, slab.group)


def _moe_meshed(params, x, *, top_k: int, capacity_factor: float,
                min_capacity: int, group_size: int):
    """``moe_apply`` of a DTensor x on params at their placements (see the
    comment above).  Returns y as a DTensor at x's split of the rows
    (replicated elsewhere) in x's dtype, and aux as replicated () float32
    DTensors."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = x.device_mesh
    ndim = mesh.ndim
    B, T, d = x.shape
    E = params["router"]["w"].shape[1]
    N = B * T
    S = _pick_group_size(N, group_size)
    place = sharded.keep_dims(x, {0})
    xt = x if tuple(x.placements) == tuple(place) else x.redistribute(mesh, place)
    xt = sharded.whole_groups(xt, 0, N // S)
    rows = {i for i, p in enumerate(xt.placements) if isinstance(p, Shard)}
    roles = _expert_roles(params, rows, ndim)
    partial = tuple(i for i, ro in enumerate(roles) if ro in ("E", "F"))

    def local(t, placements, grad):
        if not sharded.is_dtensor(t):
            return t
        return sharded.local_block(t, placements, grad_placements=grad)

    def expert_block(name):
        ff = _EXPERT_FF_AXIS[name]
        at = [Shard(0) if ro in ("A", "E") else Shard(ff) if ro == "F" else None
              for ro in roles]
        grad = [p if p is not None else Partial() if i in rows else Replicate()
                for i, p in enumerate(at)]
        return local(params[name], [p or Replicate() for p in at], grad)

    xl = sharded.local_block(xt, xt.placements)
    whole = [Replicate()] * ndim
    rows_partial = [Partial() if i in rows else Replicate() for i in range(ndim)]
    router = {"w": local(params["router"]["w"], whole, rows_partial)}
    weights = {name: expert_block(name) for name in _EXPERT_FF_AXIS}
    r = moe_routing({"router": router}, xl, top_k=top_k, capacity_factor=capacity_factor,
                    min_capacity=min_capacity, group_size=group_size)
    if r["S"] != S:
        raise ValueError(f"local groups of {r['S']} tokens, the layer's are {S}")
    xd = xl
    if partial:
        group = sharded.Group(mesh, partial)
        xd = sharded.SumGrad.apply(xl, group)
        r = dict(r, gates=sharded.SumGrad.apply(r["gates"], group))
    y = _dispatch_combine(weights, xd, r, top_k=top_k,
                          slab=_slab(mesh, roles, E, xl.device))
    y_place = [Shard(0) if i in rows else Partial() if i in partial else Replicate()
               for i in range(ndim)]
    y = sharded.wrap(y.reshape(xl.shape), mesh, y_place, x.shape)
    y = (y if tuple(y_place) == tuple(place) else y.redistribute(mesh, place)).to(x.dtype)

    # the aux over the whole batch: the density, router probabilities and
    # kept slots summed over the ranks that split the rows (one all-reduce)
    stats = torch.cat([F.one_hot(r["experts"][..., 0].reshape(-1), E).float().sum(0),
                       r["probs"].reshape(-1, E).sum(0), r["keep"].float().sum()[None]])
    if rows:
        stats = sharded.wrap(stats, mesh, rows_partial, stats.shape)
        stats = stats.redistribute(mesh, whole).to_local()
    lb_loss = E * torch.sum((stats[:E] / N) * (stats[E:2 * E] / N))
    inv_slots = (torch.ones((), dtype=torch.float32) / (N * top_k)).item()
    aux = {"load_balance_loss": lb_loss,
           "dropped_fraction": 1.0 - stats[2 * E] * inv_slots}
    return y, {k: sharded.wrap(v, mesh, whole, ()) for k, v in aux.items()}


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
