"""The work of one hand-kernel call, for the step roofline.

The kernels launch through ctypes, so a counter of torch's operators
(``roofline/analysis.py::analyze_step``) sees none of their work on the
card, and on the CPU it would see their plain versions' (the full T x S
score matrix where a causal kernel needs half).  So each dispatcher wraps
its call in ``call(name, work)``: while a counter is active, ``work()``
gives the operations and bytes that the call needs, from its shapes and
its data (live causal pairs, attend_len, rows x width), and the operators
inside the call, the kernel's or its plain version's, are not counted.  A
step's count is then the same whether the kernels or their plain versions
run.  With no counter active ``call`` does nothing else.

Each function below returns ``(operations, bytes, dtype)``: every input
byte read once and every output byte written once; ``dtype`` names the
type the call computes in (its inputs' element type), whose peak rate
bounds it.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

# the active counter (``roofline.analysis._Counter``), or None
_counter = None


def counting() -> bool:
    """True while a step's work is being counted."""
    return _counter is not None


@contextlib.contextmanager
def call(name: str, work):
    """One dispatcher call: reports ``work()`` under ``name`` to the active
    counter and hides the operators inside from it."""
    counter = _counter
    if counter is None:
        yield
        return
    counter.enter(name, *work())
    try:
        yield
    finally:
        counter.exit()


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _lengths(value, B: int, default: int) -> np.ndarray:
    """A per-row count (None, an int, a () or (B,) tensor) as (B,) int64."""
    if value is None:
        return np.full(B, default, np.int64)
    a = np.asarray(value.tolist() if isinstance(value, torch.Tensor) else value,
                   np.int64)
    return np.broadcast_to(a, (B,)).copy()


def live_pairs(T: int, S: int, *, causal: bool = True, window: int = 0,
               q_offset: int = 0, kv_valid_len=None, B: int = 1) -> int:
    """(query, key) pairs that flash attention scores, summed over B rows:
    query t (at position t + q_offset) sees key s < S (and < the row's
    kv_valid_len) with s <= t + q_offset when causal and s > t + q_offset -
    window under a window."""
    pos = np.arange(T, dtype=np.int64) + q_offset
    total = 0
    for valid in _lengths(kv_valid_len, B, S):
        hi = np.full(T, min(S, int(valid)), np.int64)
        if causal:
            hi = np.minimum(hi, pos + 1)
        lo = np.maximum(pos - window + 1, 0) if window > 0 else np.zeros(T, np.int64)
        total += int(np.maximum(hi - lo, 0).sum())
    return total


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, kv_valid_len=None,
                    return_lse: bool = False) -> tuple:
    """The forward: 4 * D operations a live pair and head (Q.K^T, P.V); q,
    k, v (and kv_valid_len) read, o (and the log-sum-exp) written."""
    B, T, Hq, D = q.shape
    pairs = live_pairs(T, k.shape[1], causal=causal, window=window,
                       q_offset=q_offset, kv_valid_len=kv_valid_len, B=B)
    nbytes = 2 * _nbytes(q) + _nbytes(k, v, kv_valid_len)
    if return_lse:
        nbytes += B * Hq * T * 4
    return 4 * D * Hq * pairs, nbytes, q.dtype


def flash_attention_backward(q, k, v, *, causal: bool = True, window: int = 0,
                             q_offset: int = 0, kv_valid_len=None) -> tuple:
    """The backward: 10 * D operations a live pair and head (its five
    products); q, o, dO, k, v, the log-sum-exp (and kv_valid_len) read, dq,
    dk, dv written."""
    B, T, Hq, D = q.shape
    pairs = live_pairs(T, k.shape[1], causal=causal, window=window,
                       q_offset=q_offset, kv_valid_len=kv_valid_len, B=B)
    nbytes = 4 * _nbytes(q) + 2 * _nbytes(k, v) + B * Hq * T * 4 + _nbytes(kv_valid_len)
    return 10 * D * Hq * pairs, nbytes, q.dtype


def decode_attention(q, k_cache, v_cache, attend_len) -> tuple:
    """One decode step: 4 * D operations a head and attended slot; q, the
    attended slots of the K/V cache (and a tensor attend_len) read, o
    written."""
    B, _, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    slots = int(_lengths(attend_len, B, k_cache.shape[1]).sum())
    nbytes = (2 * _nbytes(q) + 2 * slots * Hkv * D * k_cache.element_size()
              + (_nbytes(attend_len) if isinstance(attend_len, torch.Tensor) else 0))
    return 4 * D * Hq * slots, nbytes, q.dtype


def rmsnorm(x, scale) -> tuple:
    """4 operations an element (square, sum, two scalings); x and scale
    read, y written.  The arithmetic is float32 whatever x's type."""
    return 4 * x.numel(), 2 * _nbytes(x) + _nbytes(scale), torch.float32


def rmsnorm_backward(x, scale) -> tuple:
    """6 operations an element; x, scale and g read, dx and dscale
    written."""
    return 6 * x.numel(), 3 * _nbytes(x) + 2 * _nbytes(scale), torch.float32


def quantize(x, centers) -> tuple:
    """3 operations an element and center (difference, square, compare);
    x and the codebook read, int32 indices and the values written."""
    n = x.numel()
    return 3 * centers.numel() * n, 2 * _nbytes(x) + _nbytes(centers) + 4 * n, torch.float32


def offload_fused(x, centers, k: int) -> tuple:
    """The permute, split and quantize of (..., C) rows: the quantizer's
    operations on the C - k remote channels; x and the codebook read, the
    local and remote halves, int32 indices and values written."""
    C = x.shape[-1]
    remote = x.numel() // C * (C - k)
    nbytes = 2 * _nbytes(x) + _nbytes(centers) + remote * (4 + x.element_size())
    return 3 * centers.numel() * remote, nbytes, torch.float32


def channel_permute(x) -> tuple:
    """A copy: x read and written, no arithmetic."""
    return 0, 2 * _nbytes(x), x.dtype
