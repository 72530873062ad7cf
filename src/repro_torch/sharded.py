"""Local blocks of DTensors, for the code that must see plain tensors.

Under a mesh (``launch/mesh.py``) the model runs on DTensors, whose
operators DTensor propagates rank by rank.  Some code must not see one:
the hand kernels, which launch through ctypes on ``data_ptr()``; writes
by row or slot index into a tensor sharded along that axis (the decode
caches and the scheduler's pool); the layers that compute on their
placed blocks themselves, because their operators have no sharding
strategy or would gather what they need whole (the Mamba and xLSTM
recurrences, ``nn/ssm.py`` and ``nn/xlstm.py``; the MoE, ``nn/moe.py``;
decode attention on a cache split along its slots,
``kernels/decode_attention/ops.py``); a lookup along a split vocabulary
(``embedding``); host reads.  ``local_block`` redistributes a DTensor to
the placements such code can work on (explicitly, so that what it moves
is stated where it is needed) and returns its local block; ``wrap`` makes
a DTensor of a local result.

A DTensor's rows are independent along a batch axis, and attention's heads
along the head axis with their KV group, so a kernel run on each rank's
block computes that rank's block of the whole result.

The layers that compute on placed blocks talk over the mesh dims that
split them through the functional collectives below (``Group``).  Inside
such a layer a value that every rank of the group holds whole carries,
on each rank, that rank's share of its gradient (the ranks' shares add
up to it), since each rank computes its own block of the output from
it: ``SumGrad`` (the identity, its gradient summed) takes a layer's input
into that convention, ``all_reduce`` sums partial values whose gradient
is itself a share, and ``reduce_out`` (a sum whose gradient is taken
whole) hands a partial output back to DTensor, whose replicated values
carry whole gradients on every rank.
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


class Group:
    """The process group of the mesh dims ``dims`` (their joint group,
    major to minor, for several) for the functional collectives: ``size``
    ranks, this rank at ``index``."""

    def __init__(self, mesh, dims):
        self.mesh, self.dims = mesh, tuple(dims)
        coord = mesh.get_coordinate()
        self.size, self.index = 1, 0
        for i in self.dims:
            self.size *= mesh.size(i)
            self.index = self.index * mesh.size(i) + coord[i]
        if len(self.dims) == 1:
            self.spec = (mesh, self.dims[0])
        elif self.dims:
            names = tuple(mesh.mesh_dim_names[i] for i in self.dims)
            self.spec = (mesh[names]._flatten(), 0)
        else:
            self.spec = None

    def sum(self, t, op: str = "sum"):
        """The all-reduce of a plain tensor (no gradient)."""
        from torch.distributed import _functional_collectives as fc

        if self.size == 1:
            return t
        return fc.wait_tensor(fc.all_reduce(t.contiguous(), op, self.spec))

    def gather(self, t, dim: int, *, whole_grad: bool = False):
        """The blocks of ``t`` along ``dim``, in the group's order.  The
        gradient of each block is the sum of the ranks' shares of it (a
        reduce-scatter), or with ``whole_grad`` (the gathered value leaves
        the layer replicated, its gradient whole on every rank) this
        rank's block of it."""
        from torch.distributed import _functional_collectives as fc

        if self.size == 1:
            return t
        if whole_grad:
            return _GatherWhole.apply(t, dim, self)
        out = fc.all_gather_tensor_autograd(t.movedim(dim, 0).contiguous(), 0, self.spec)
        return fc.wait_tensor(out).movedim(0, dim)

    def exchange(self, t, send: list, recv: list):
        """``all_to_all_single`` along axis 0 of ``t``: ``send[j]`` rows to
        rank j, ``recv[j]`` rows from rank j (the gradient goes back the
        same way)."""
        from torch.distributed import _functional_collectives as fc

        if self.size == 1:
            return t
        return fc.wait_tensor(fc.all_to_all_single_autograd(
            t.contiguous(), list(recv), list(send), self.spec))

    def _routes(self, parts: int):
        """``realign``'s all-to-all: the order that sorts this rank's
        ``parts`` blocks by the rank each goes to, the blocks sent to each
        rank and those received from each."""
        k, j = self.size, self.index
        dest = [(parts * j + i) % k for i in range(parts)]
        order = sorted(range(parts), key=lambda i: (dest[i], i))
        recv = [sum(1 for g in range(parts) if (g * k + j) // parts == r) for r in range(k)]
        return order, [dest.count(r) for r in range(k)], recv

    def realign(self, t, parts: int):
        """This rank's block of each of ``parts`` equal parts, from its
        block ``t`` (..., parts * w) of their concatenation [part 0 | part 1
        | ...] split over the group in order (as a column-parallel weight
        of stacked halves or gates gives it): (parts, ..., w), an
        all-to-all of blocks of w columns."""
        blocks = t.reshape(t.shape[:-1] + (parts, t.shape[-1] // parts)).movedim(-2, 0)
        if self.size == 1:
            return blocks
        order, send, recv = self._routes(parts)
        return self.exchange(blocks[order], send, recv)

    def unalign(self, blocks, parts: int):
        """``realign``'s inverse: this rank's block of each part, (parts,
        ..., w), back to its block (..., parts * w) of their concatenation
        split over the group in order."""
        if self.size > 1:
            order, send, recv = self._routes(parts)
            blocks = self.exchange(blocks, recv, send)[[order.index(i) for i in range(parts)]]
        return blocks.movedim(0, -2).reshape(blocks.shape[1:-1] + (parts * blocks.shape[-1],))

    def reshard(self, t, src: int, dst: int):
        """``t``, this rank's block along axis ``src`` (axis ``dst`` whole),
        as its block along axis ``dst`` (axis ``src`` whole): an
        all-to-all."""
        k = self.size
        if k == 1:
            return t
        shape = t.shape
        chunks = t.reshape(shape[:dst] + (k, shape[dst] // k) + shape[dst + 1:]).movedim(dst, 0)
        out = self.exchange(chunks, [1] * k, [1] * k).movedim(0, src)
        return out.reshape(out.shape[:src] + (k * out.shape[src + 1],) + out.shape[src + 2:])


class _GatherWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        from torch.distributed import _functional_collectives as fc

        ctx.dim, ctx.group, ctx.n = dim, group, t.shape[dim]
        out = fc.all_gather_tensor(t.movedim(dim, 0).contiguous(), 0, group.spec)
        return fc.wait_tensor(out).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.group.index * ctx.n, ctx.n), None, None


class SumGrad(torch.autograd.Function):
    """The identity, whose gradient is summed over ``group`` (an
    all-reduce): where ranks compute their own blocks from a value they
    all hold, each holds only its share of the value's gradient."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.sum(g), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, whole_grad):
        ctx.group, ctx.whole_grad = group, whole_grad
        return group.sum(t)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.whole_grad else ctx.group.sum(g)), None, None


def all_reduce(t, group):
    """The sum over ``group`` of each rank's partial ``t``, used by every
    rank for its own block: its gradient, a share on each rank, is summed
    too."""
    return t if group.size == 1 else _AllReduce.apply(t, group, False)


def reduce_out(t, group):
    """The sum over ``group`` of each rank's partial ``t``, leaving the
    layer as a replicated value: its gradient arrives whole on every rank
    and passes to each partial as it is."""
    return t if group.size == 1 else _AllReduce.apply(t, group, True)


def param_block(t, group, axis, rows, *, share: bool = False):
    """The local block of param ``t`` for a layer computing on ``group``'s
    blocks: its split of ``axis`` over the group's dims kept (``axis``
    None: whole), every other split gathered (FSDP's, over the data
    axes).  Its gradient is a partial sum over ``rows`` (the dims that
    split the batch) and, with ``share`` (a whole param each rank uses for
    its own block of the output), over the group's dims too."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    if not is_dtensor(t):
        return t
    mesh = t.device_mesh
    at = [Shard(axis) if axis is not None and i in group.dims else Replicate()
          for i in range(mesh.ndim)]
    grad = [p if isinstance(p, Shard) else
            Partial() if i in rows or (share and i in group.dims) else Replicate()
            for i, p in enumerate(at)]
    return local_block(t, at, grad_placements=grad)


def _state_place(ndim: int, rows, group, axis) -> list:
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if i in rows else
            Shard(axis) if axis is not None and i in group.dims else Replicate()
            for i in range(ndim)]


def _moves_split(placements, group, want, avoid) -> int | None:
    """The axis that ``placements`` split over every one of the group's
    dims (one axis, not ``avoid``) where they equal ``want`` elsewhere;
    else None."""
    from torch.distributed.tensor import Shard

    axes = {p.dim for i, p in enumerate(placements) if i in group.dims and isinstance(p, Shard)}
    if group.size == 1 or len(axes) != 1 or avoid in axes or any(
            (not isinstance(p, Shard)) if i in group.dims else p != want[i]
            for i, p in enumerate(placements)):
        return None
    return axes.pop()


def state_block(t, rows, group, axis):
    """This rank's block of a decode-state leaf ``t`` (B, ...) for a layer
    computing on ``group``'s blocks: its rows, and its block of ``axis``
    over the group (``axis`` None: whole).  A leaf the cache splits along
    another axis over the group is moved by an all-to-all; anything else
    is redistributed explicitly."""
    want = _state_place(t.device_mesh.ndim, rows, group, axis)
    src = _moves_split(t.placements, group, want, axis) if axis is not None else None
    if src is not None:
        return group.reshard(t.to_local(), src, axis)
    return local_block(t, want)


def state_out(local, like, rows, group, axis):
    """The new state leaf from its block ``local`` (``state_block``'s
    layout) as a DTensor at ``like``'s placements (the leaf passed in),
    or, where ``like`` is the leaf's shape (a prefill), at the cache's
    (``launch/partition.py::cache_model_axis`` over the group's dims): one
    all-to-all where only the split axis differs, else an explicit
    redistribution (slicing, where the block is whole over the group)."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.partition import cache_model_axis

    mesh = group.mesh
    have = _state_place(mesh.ndim, rows, group, axis)
    if is_dtensor(like):
        shape, target = tuple(like.shape), list(like.placements)
    else:
        shape, split = tuple(like), cache_model_axis(like, group.size, start=1)
        cut = Replicate() if split is None else Shard(split)
        target = [cut if i in group.dims else p for i, p in enumerate(have)]
    if target == have:
        return wrap(local, mesh, have, shape)
    dst = _moves_split(target, group, have, axis) if axis is not None else None
    if dst is not None:
        return wrap(group.reshard(local, axis, dst), mesh, target, shape)
    return wrap(local, mesh, have, shape).redistribute(mesh, target)


def layer_group(mesh, param, axis: int, rows) -> "Group":
    """The group of a layer that computes on the blocks of ``param``'s
    ``axis``: the mesh dims that split it and not the rows (FSDP's
    data-axis split of a param is gathered, not computed on); none for a
    plain param."""
    dims = split_dims(param, axis) if is_dtensor(param) else []
    return Group(mesh, [i for i in dims if i not in rows])


def split_dims(t, dim: int) -> list:
    """The mesh dims that split DTensor ``t``'s axis ``dim``."""
    from torch.distributed.tensor import Shard

    return [i for i, p in enumerate(t.placements) if isinstance(p, Shard) and p.dim == dim]


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

