"""Local blocks of DTensors, for the code that must see plain tensors.

Under a mesh (``launch/mesh.py``) the model runs on DTensors, whose
operators DTensor propagates rank by rank.  Some code must not see one:
the hand kernels, which launch through ctypes on ``data_ptr()``; writes
by row index into a tensor sharded along its rows (the decode caches and
the scheduler's pool); the layers whose operators have no sharding
strategy (the Mamba and xLSTM recurrences: ``run_local``; the MoE, whose
routing has none either, computes on its placed local blocks itself:
``nn/moe.py``); a lookup along a split vocabulary (``embedding``); host
reads.  ``local_block`` redistributes a DTensor to the placements such
code can work on (explicitly, so that what it moves is stated where it is
needed) and returns its local block; ``wrap`` makes a DTensor of a local
result.

A DTensor's rows are independent along a batch axis, and attention's heads
along the head axis with their KV group, so a kernel run on each rank's
block computes that rank's block of the whole result.
"""
from __future__ import annotations

from contextlib import nullcontext

import torch


def is_dtensor(t) -> bool:
    if not isinstance(t, torch.Tensor) or type(t) in (torch.Tensor, torch.nn.Parameter):
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def keep_dims(t, dims) -> list:
    """Placements of ``t`` that keep its Shard(d) for d in ``dims`` and
    replicate everything else (other shards and partial sums)."""
    from torch.distributed.tensor import Replicate, Shard

    return [p if isinstance(p, Shard) and p.dim in dims else Replicate()
            for p in t.placements]


def local_block(t, placements, *, grad_placements=None):
    """The local block of DTensor ``t`` at ``placements`` (redistributed
    first where they differ).  ``grad_placements``: how a gradient of the
    block adds up across ranks (Partial where ranks hold partial sums of
    it), as ``DTensor.to_local`` takes it."""
    if tuple(t.placements) != tuple(placements):
        t = t.redistribute(t.device_mesh, placements)
    local = t.to_local(grad_placements=grad_placements)
    return _DenseGrad.apply(local) if local.requires_grad else local


class _DenseGrad(torch.autograd.Function):
    """The identity, whose gradient leaves contiguous: a local block's
    gradient becomes a DTensor's again, and DTensor's views of it need
    its rows dense."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def wrap(local: torch.Tensor, mesh, placements, shape):
    """A DTensor of global ``shape`` from this rank's block."""
    from torch.distributed.tensor import DTensor

    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def local_rows(value, like):
    """A per-row value (None, an int, a plain tensor over every row, or a
    DTensor) as this rank's block of the rows (axis 0) of DTensor
    ``like``: a DTensor takes like's split of the rows, a plain tensor of
    every row is cut to the local ones (it stands replicated)."""
    from torch.distributed.tensor import Shard

    if value is None or isinstance(value, (int, float)):
        return value
    if not isinstance(value, torch.Tensor) or value.dim() == 0:
        return value.to_local() if is_dtensor(value) else value
    placements = [p if isinstance(p, Shard) and p.dim == 0 else None
                  for p in like.placements]
    if is_dtensor(value):
        from torch.distributed.tensor import Replicate

        return local_block(value, [Shard(0) if p is not None else Replicate()
                                   for p in placements])
    mesh = like.device_mesh
    coord = mesh.get_coordinate()
    n = value.shape[0]
    start, size = 0, n
    for i, p in enumerate(placements):
        if p is not None:
            k = mesh.size(i)
            size //= k
            start += coord[i] * size
    return value[start:start + size]


def empty_for(like, value):
    """An uninitialised tensor of ``like``'s shape and dtype (a meta tensor)
    whose trailing axes take ``value``'s (one slice of it): on value's
    device, and for a DTensor in its placements (sharded axes shifted
    past the leading ones; a partial sum lands reduced)."""
    if not is_dtensor(value):
        return torch.empty(like.shape, dtype=like.dtype, device=value.device)
    from torch.distributed.tensor import Replicate, Shard

    shift = like.dim() - value.dim()
    placements = [Shard(p.dim + shift) if isinstance(p, Shard) else Replicate()
                  for p in value.placements]
    local = value.to_local()
    shape = tuple(like.shape[:shift]) + tuple(local.shape)
    return wrap(torch.empty(shape, dtype=like.dtype, device=local.device),
                value.device_mesh, placements, like.shape)


def host_replicated(mesh):
    """A context in which plain tensors made on the host (token ids,
    positions, masks) stand replicated beside DTensors on ``mesh``: every
    rank makes the same ones.  No effect without a mesh."""
    if mesh is None:
        return nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def whole_groups(t, dim: int, groups: int):
    """DTensor ``t`` with axis ``dim`` split only where its split divides
    ``groups`` (so that a reshape of the axis into (groups, rest) keeps
    whole groups on each rank): the mesh axes that split it are
    replicated (gathered), explicitly, when their split does not."""
    from torch.distributed.tensor import Replicate, Shard

    split = [i for i, p in enumerate(t.placements)
             if isinstance(p, Shard) and p.dim == dim]
    k = 1
    for i in split:
        k *= t.device_mesh.size(i)
    if not split or groups % k == 0:
        return t
    placements = [Replicate() if i in split else p for i, p in enumerate(t.placements)]
    return t.redistribute(t.device_mesh, placements)


def run_local(fn, params, x, *args, **kw):
    """``fn(params, x, *args, **kw)`` of a layer on plain tensors, for a
    DTensor ``x`` (B, ...): every DTensor param gathered whole (explicitly;
    its gradient a partial sum over the ranks that split the rows), and
    each rank's rows of x and of the tensors in ``args`` (states (B, ...)).
    The tensors of the result (a tensor or a tuple / dict of them, each
    leading with the batch, or () scalars over the whole batch) come back
    as DTensors at x's row split, or replicated."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.utils._pytree import tree_map as map_any

    mesh = x.device_mesh
    place = keep_dims(x, {0})
    whole = [Replicate()] * mesh.ndim
    grad = [Partial() if isinstance(p, Shard) else Replicate() for p in place]

    def local(t, placements, grad_placements=None):
        if is_dtensor(t):
            return local_block(t, placements, grad_placements=grad_placements)
        return t

    pl = map_any(lambda t: local(t, whole, grad), params)
    xl = local(x, place)
    al = map_any(lambda t: local(t, place), args)
    out = fn(pl, xl, *al, **kw)

    def back(t):
        if not isinstance(t, torch.Tensor):
            return t
        if t.dim() == 0:
            return wrap(t, mesh, whole, t.shape)
        return wrap(t, mesh, place, (x.shape[0],) + tuple(t.shape[1:]))

    return map_any(back, out)


def mesh_of(tree):
    """The mesh of a tree's DTensors (its first leaf's), or None."""
    from repro_torch import tree_leaves

    leaves = tree_leaves(tree)
    return leaves[0].device_mesh if leaves and is_dtensor(leaves[0]) else None


def like(t, ref):
    """DTensor ``t`` at ``ref``'s placements (replicated when ``ref`` is
    None); anything else as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate

    placements = (ref.placements if ref is not None
                  else [Replicate()] * t.device_mesh.ndim)
    if tuple(t.placements) == tuple(placements):
        return t
    return t.redistribute(t.device_mesh, placements)


def embedding(table, ids):
    """``table[ids]`` of a DTensor table (V, d), explicitly: DTensor's own
    lookup along a split vocabulary (its masked partial sum) fails in
    some torch releases.  Each rank looks up the ids of its rows in its
    block of the vocabulary (zeros for ids outside it), and the blocks are
    summed across the ranks that split the vocabulary (an all-reduce);
    the feature axis is gathered first where FSDP split it.  ids: a
    DTensor or a plain tensor (standing replicated)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = table.device_mesh
    if not is_dtensor(ids):
        ids = wrap(ids, mesh, [Replicate()] * mesh.ndim, ids.shape)
    vocab = [isinstance(p, Shard) and p.dim == 0 for p in table.placements]
    rows = [isinstance(p, Shard) and p.dim == 0 and not v
            for p, v in zip(ids.placements, vocab)]
    id_place = [Shard(0) if r else Replicate() for r in rows]
    local_ids = local_block(ids, id_place)
    t_place = [Shard(0) if v else Replicate() for v in vocab]
    grad = [Shard(0) if v else Partial() if r else Replicate()
            for v, r in zip(vocab, rows)]
    local_table = local_block(table, t_place, grad_placements=grad)
    shape = tuple(ids.shape) + (table.shape[1],)
    if not any(vocab):
        return wrap(local_table[local_ids], mesh, id_place, shape)
    n, start = local_table.shape[0], 0
    coord = mesh.get_coordinate()
    for i, v in enumerate(vocab):
        if v:
            start = start * mesh.size(i) + coord[i]
    start *= n
    inside = (local_ids >= start) & (local_ids < start + n)
    out = local_table[torch.where(inside, local_ids - start, 0)]
    out = out * inside[..., None].to(out.dtype)
    partial = wrap(out, mesh, [Partial() if v else p for v, p in zip(vocab, id_place)],
                   shape)
    return partial.redistribute(mesh, id_place)

