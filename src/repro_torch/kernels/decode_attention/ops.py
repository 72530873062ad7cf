"""Dispatch of decode attention: the CUDA kernel for CUDA tensors, the
plain version for CPU tensors, no fallback between them.  Each call
reports its work to the step roofline (``kernels/work.py``); meta tensors
(the dry-run) give outputs of the right shapes and run nothing.

DTensors run on each rank's block of rows and KV groups, as flash
attention's (``kernels/attention/ops.py::attention_sharded``).  A cache
split along its slots (``launch/partition.py::cache_shardings`` splits
the sequence where the kv heads do not divide the model axis) stays
split: each rank runs the kernel on its block of slots with that block's
live count and returns its output and log-sum-exp, and the ranks combine
the blocks as flash-decoding combines its splits (``combine_blocks``; over
the mesh, two all-reduces of (B, Hq) and (B, Hq, D + 1) values)."""
from __future__ import annotations

import torch

from repro_torch import sharded
from repro_torch.kernels import work
from repro_torch.kernels.attention.ops import attention_sharded
from repro_torch.kernels.common import auto_page_size
from repro_torch.kernels.decode_attention.kernel import decode_attention_cuda
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

# the page passed where the cache width does not split into pages
DEFAULT_PAGE = 64


def decode_attention_op(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, attend_len, *, return_lse: bool = False):
    """q: (B, 1, Hq, D); k/v_cache: (B, S, Hkv, D); attend_len: an int or a
    () / (B,) tensor of valid slots.  Returns (B, 1, Hq, D) [and with
    ``return_lse`` the (B, Hq) float32 log-sum-exp, plain tensors only].
    On CUDA the page passed is ``auto_page_size(S)``, as the JAX dispatcher
    picks it, or ``DEFAULT_PAGE`` when S does not split into pages; the
    kernel cuts the slots into its own splits, so any S runs it."""
    if sharded.is_dtensor(q):
        if sharded.is_dtensor(k_cache) and sharded.split_dims(k_cache, 1):
            return _sequence_split(q, k_cache, v_cache, attend_len)
        return attention_sharded(
            lambda q, k, v, attend_len: decode_attention_op(q, k, v, attend_len),
            q, k_cache, v_cache, {"attend_len": attend_len}, "attend_len")
    with work.call("decode_attention", lambda: work.decode_attention(
            q, k_cache, v_cache, attend_len)):
        if q.device.type == "meta":
            out = torch.empty_like(q)
            if return_lse:
                return out, q.new_empty(q.shape[:1] + q.shape[2:3], dtype=torch.float32)
            return out
        if q.device.type == "cpu":
            return decode_attention_ref(q, k_cache, v_cache, attend_len,
                                        return_lse=return_lse)
        page = auto_page_size(k_cache.shape[1]) or DEFAULT_PAGE
        return decode_attention_cuda(q.contiguous(), k_cache.contiguous(),
                                     v_cache.contiguous(), attend_len,
                                     page_size=page, return_lse=return_lse)


def block_attend(attend_len, start: int, size: int):
    """The live count of the block of ``size`` slots from slot ``start``,
    of a cache whose first ``attend_len`` slots (an int or a tensor) are
    live: clamp(attend_len - start, 0, size)."""
    if isinstance(attend_len, torch.Tensor):
        return torch.clamp(attend_len - start, 0, size)
    return min(max(int(attend_len) - start, 0), size)


def combine_blocks(outs, lses, dtype=None):
    """Decode attention over a cache from its k blocks' results: outs (k,
    B, 1, Hq, D) and lses (k, B, Hq) (each block's output and log-sum-exp,
    -inf where a block has no live slot).  Returns (B, 1, Hq, D) in
    ``dtype`` (outs' by default); ``_combine`` gives the rule."""
    out = _combine(outs[:, :, 0], lses, lambda t, op: t.amax(0) if op == "max" else t.sum(0))
    return out[:, None].to(dtype or outs.dtype)


def _combine(out, lse, reduce):
    """Each block weighed by exp(lse - max lse), the weighted outputs
    summed over the summed weights, in float32; 0 for a (row, head) with
    no live slot in any block.  out (..., B, Hq, D), lse (..., B, Hq);
    ``reduce(t, "max" | "sum")`` reduces over the blocks."""
    m = reduce(lse, "max")
    w = torch.exp(lse - torch.where(torch.isfinite(m), m, 0.0))[..., None]
    both = reduce(torch.cat([w * out.float(), w], dim=-1), "sum")
    num, den = both[..., :-1], both[..., -1:]
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)


def _sequence_split(q, k_cache, v_cache, attend_len):
    """Decode attention of DTensors whose cache is split along its slots
    (the module docstring): the cache's blocks read where they lie (its
    rows and heads splits kept), q at those rows and heads, the blocks
    combined over the mesh dims that split the slots."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = k_cache.device_mesh
    cache_place = [p if isinstance(p, Shard) and p.dim in (0, 1, 2) else Replicate()
                   for p in k_cache.placements]
    q_place = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
               for p in cache_place]
    kl = sharded.local_block(k_cache, cache_place)
    vl = sharded.local_block(v_cache, cache_place)
    ql = sharded.local_block(q, q_place)
    group = sharded.Group(mesh, sharded.split_dims(k_cache, 1))
    size = kl.shape[1]
    live = sharded.local_rows(attend_len, sharded.wrap(ql, mesh, q_place, q.shape))
    out, lse = decode_attention_op(ql, kl, vl, block_attend(live, group.index * size, size),
                                   return_lse=True)
    out = _combine(out[:, 0], lse, group.sum)
    return sharded.wrap(out[:, None].to(q.dtype), mesh, q_place, q.shape)
