"""Launch wrapper of the split-K paged decode-attention CUDA kernel
(csrc/decode_attention.cu).

Replaces ``repro.kernels.decode_attention.kernel.paged_decode_attention_tpu``,
in float32 (``decode_attention_launch``) and in bf16
(``decode_attention_bf16_launch``, a launch count of its own).
The source note in the .cu gives its byte bound and design; ``split_slots``
here is the rule that cuts a row's cache slots into the splits that the
kernel's blocks take.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels._build import (
    KERNEL_DTYPES,
    CudaKernel,
    check_aligned,
    check_operand,
    check_plain,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P] + [_I] * 9 + [ctypes.c_float, _P, _P]
KERNEL = CudaKernel("decode_attention", _ARGS)
KERNEL_BF16 = CudaKernel("decode_attention_bf16", _ARGS,
                         library="decode_attention")
HEAD_DIMS = (64, 128)
MAX_GROUP = 16
MAX_PAGE = 128
# the kernel stages 32 cache slots a tile (a lane per slot); a split is a
# whole number of tiles, and the splits of all rows and kv heads aim at
# about four blocks on each SM
SPLIT_TILE = 32
SPLIT_BLOCKS_PER_SM = 4


def split_slots(B: int, depth: int, Hkv: int, sms: int) -> int:
    """Cache slots per split: the fewest whole tiles that keep B * Hkv *
    ceil(depth / split) blocks within SPLIT_BLOCKS_PER_SM per SM.  depth
    is the deepest row the grid must cover: attend_len when every row
    shares it, else the cache width S."""
    tiles = max(1, -(-depth // SPLIT_TILE))
    per_split = -(-(B * Hkv * tiles) // (SPLIT_BLOCKS_PER_SM * sms))
    return SPLIT_TILE * max(1, per_split)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, attend_len, *,
                          page_size: int = 64):
    """q: (B, 1, Hq, D); k/v_cache: (B, S, Hkv, D); contiguous, 16-byte
    aligned, all float32 or all bfloat16, on one CUDA device, D in (64,
    128), G = Hq / Hkv <= 16.
    attend_len: an int for every row, or a () / (B,) integer tensor: the
    count of live cache slots per row (clipped to [0, S]).  Any S works.
    ``page_size`` (the TPU kernel's page, 1..128) is checked and does not
    shape the work: the kernel cuts each row into ``split_slots`` splits.
    Returns (B, 1, Hq, D) in q's dtype (bf16: the float32 kernel's
    arithmetic on the widened inputs, bitwise, rounded at the end), 0 on a
    row with attend_len = 0.  Raises
    ValueError on any other input; a misaligned view is refused, not
    copied."""
    if q.dim() != 4 or q.shape[1] != 1 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"q must be (B, 1, Hq, D) and k/v_cache (B, S, Hkv, D), "
                         f"got {tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    B, _, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    if (D not in HEAD_DIMS or k_cache.shape[0] != B or k_cache.shape[3] != D
            or Hkv < 1 or Hq % Hkv or not 1 <= Hq // Hkv <= MAX_GROUP):
        raise ValueError(f"the kernel takes D in {HEAD_DIMS} and Hq = G * Hkv "
                         f"with G <= {MAX_GROUP}, got q {tuple(q.shape)}, "
                         f"cache {tuple(k_cache.shape)}")
    if not 1 <= page_size <= MAX_PAGE:
        raise ValueError(f"page_size must be in [1, {MAX_PAGE}], got {page_size}")
    check_operand(q, "q", KERNEL_DTYPES, q.device)
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        check_operand(t, name, q.dtype, q.device)
        check_aligned(t, name)
    G = Hq // Hkv
    rows_ptr, attend_all = None, 0
    if isinstance(attend_len, torch.Tensor):
        check_plain(attend_len, "attend_len")
        if attend_len.is_floating_point() or attend_len.dim() > 1:
            raise ValueError(f"attend_len must be () or (B,) integers, got "
                             f"{tuple(attend_len.shape)} {attend_len.dtype}")
        attend_len = attend_len.to(device=q.device, dtype=torch.int32)
        attend_len = attend_len.expand(B).contiguous()
        rows_ptr = attend_len.data_ptr()
        depth = S                 # the host does not read the rows' depths
    else:
        attend_all = int(attend_len)
        depth = min(max(attend_all, 0), S)
    split = split_slots(B, depth, Hkv, _sm_count(q.device.index))
    n_splits = -(-depth // split)
    part = torch.empty(B * Hkv * n_splits * G * (D + 2), dtype=torch.float32,
                       device=q.device)
    o = torch.empty_like(q)
    kernel = KERNEL if q.dtype == torch.float32 else KERNEL_BF16
    with torch.cuda.device(q.device):
        kernel.launch(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                      rows_ptr, attend_all, B, S, Hkv, G, D, page_size, split,
                      n_splits, 1.0 / math.sqrt(D), part.data_ptr(),
                      o.data_ptr(), stream=torch.cuda.current_stream().cuda_stream)
    return o
