"""Launch wrappers of the flash-attention CUDA kernels
(csrc/flash_attention.cu, its bf16 half csrc/flash_attention_bf16.cu, and
their gradients, csrc/flash_attention_backward.cu and
csrc/flash_attention_backward_bf16.cu).

The forward replaces ``repro.kernels.attention.kernel.flash_attention_tpu``
with the contract of the jnp ``repro.nn.attention.flash_attention`` that
the JAX model calls, in float32 (``flash_attention_launch``, 3xTF32
``mma.sync``) and in bf16 (``flash_attention_bf16_launch``, the bf16
tensor cores by ``wgmma``, a library and a launch count of its own); the
backward has no TPU counterpart (the JAX model differentiates that jnp
function) and has the same two halves (``flash_attention_backward_launch``,
3xTF32 ``mma.sync``, and ``flash_attention_backward_bf16_launch``, all five
products by ``wgmma`` on 64-row tiles, P and dS rounded to bf16 before
their products), each with its own library and launch count.  The two
bf16 sources share their swizzled tiles, descriptors, ``wgmma`` forms and
tile copy (csrc/wgmma_common.cuh).  The source notes in the .cu give
bounds and designs.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels._build import (
    KERNEL_DTYPES,
    CudaKernel,
    check_aligned,
    check_operand,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
_FORWARD_ARGS = [_P, _P, _P, _P] + [_I] * 9 + [ctypes.c_float, _P, _P]
KERNEL = CudaKernel("flash_attention", _FORWARD_ARGS)
KERNEL_BF16 = CudaKernel("flash_attention_bf16", _FORWARD_ARGS)
_BACKWARD_ARGS = [_P] * 8 + [_I] * 9 + [ctypes.c_float, _P, _P, _P]
BACKWARD = CudaKernel("flash_attention_backward", _BACKWARD_ARGS)
BACKWARD_BF16 = CudaKernel("flash_attention_backward_bf16", _BACKWARD_ARGS)
HEAD_DIMS = (64, 128)


def _check_qkv(q, k, v, more=()):
    """q, k, v (and ``more``, (name, tensor) pairs of q's shape) as the
    kernels take them."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, T, Hq, D) and k, v (B, S, Hkv, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    if D not in HEAD_DIMS or k.shape[0] != B or k.shape[3] != D or Hkv < 1 or Hq % Hkv:
        raise ValueError(f"the kernel takes D in {HEAD_DIMS} and Hq a multiple "
                         f"of Hkv, got q {tuple(q.shape)}, k {tuple(k.shape)}")
    for name, t in more:
        if t.shape != q.shape:
            raise ValueError(f"{name} must be q's shape {tuple(q.shape)}, "
                             f"got {tuple(t.shape)}")
    _check_operands(q, (("k", k), ("v", v), *more))


def _check_operands(q, rest) -> None:
    """q and the ``rest`` ((name, tensor) pairs) as the kernels take them:
    the dtypes first (q float32 or bf16, the rest q's), then 16-byte
    alignment, then device and layout, so each refusal names its first
    cause; all raise ValueError before any device work."""
    pairs = (("q", q), *rest)
    for name, t in pairs:
        want = KERNEL_DTYPES if t is q else (q.dtype,)
        if t.dtype not in want:
            raise ValueError(f"{name}: the CUDA kernel takes "
                             f"{' or '.join(map(str, want))}, got {t.dtype}")
    for name, t in pairs:
        check_aligned(t, name)
    for name, t in pairs:
        check_operand(t, name, q.dtype, q.device)


def _kv_valid_ptr(kv_valid_len, B: int, device):
    """kv_valid_len as the kernels read it: None, or a contiguous (B,)
    int32 copy on ``device`` (returned to keep it alive) and its address."""
    if kv_valid_len is None:
        return None, None
    if kv_valid_len.shape != (B,) or kv_valid_len.is_floating_point():
        raise ValueError(f"kv_valid_len must be (B={B},) integers, got "
                         f"{tuple(kv_valid_len.shape)} {kv_valid_len.dtype}")
    kv_valid_len = kv_valid_len.to(device=device, dtype=torch.int32).contiguous()
    return kv_valid_len, kv_valid_len.data_ptr()


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0,
                         q_offset: int = 0,
                         kv_valid_len: torch.Tensor | None = None,
                         return_lse: bool = False):
    """q: (B, T, Hq, D); k, v: (B, S, Hkv, D); contiguous, 16-byte aligned,
    all float32 or all bfloat16, on one CUDA device, D in (64, 128), Hq a
    multiple of Hkv.  kv_valid_len: optional (B,) integer count of live
    keys per row.  Returns (B, T, Hq, D) in q's dtype (float32: 3xTF32
    products, within 2e-5 of the plain version; bf16: bf16 products summed
    in fp32, P rounded to bf16 before P.V, within 3e-2 of the plain
    version), and with ``return_lse`` also each row's log-sum-exp of its
    scaled live scores, (B, Hq, T) float32 (-inf for a row with no live
    key); the output is bitwise the same either way, and from call to
    call.  Raises ValueError on any other input; a misaligned view is
    refused, not copied."""
    _check_qkv(q, k, v)
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    kv_valid_len, valid_ptr = _kv_valid_ptr(kv_valid_len, B, q.device)
    o = torch.empty_like(q)
    lse = (torch.empty((B, Hq, T), dtype=torch.float32, device=q.device)
           if return_lse else None)
    kernel = KERNEL if q.dtype == torch.float32 else KERNEL_BF16
    with torch.cuda.device(q.device):
        kernel.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_ptr,
                      B, T, S, Hq, Hkv, D, int(causal), int(window),
                      int(q_offset), 1.0 / math.sqrt(D), o.data_ptr(),
                      lse.data_ptr() if return_lse else None,
                      stream=torch.cuda.current_stream().cuda_stream)
    return (o, lse) if return_lse else o


def flash_attention_backward_cuda(q, k, v, o, do, lse, *, causal: bool = True,
                                  window: int = 0, q_offset: int = 0,
                                  kv_valid_len: torch.Tensor | None = None):
    """The gradient of ``flash_attention_cuda(q, k, v, causal=, window=,
    q_offset=, kv_valid_len=)`` against do = dL/do: (dq, dk, dv) in the
    shapes and dtype of q, k, v (float32: 3xTF32 products; bf16: bf16
    products summed in fp32, P and dS rounded to bf16 before theirs),
    bitwise the same from call to call; a query row with no live key gets
    dq = 0, a key no row sees dk = dv = 0.  o and lse are that call's
    output and log-sum-exp; o and do take q's shape, dtype and checks, lse
    is (B, Hq, T) float32, kv_valid_len as the forward takes it.  Raises
    ValueError on any other input."""
    if lse.dtype != torch.float32:
        raise ValueError(f"lse: the CUDA kernel takes torch.float32, got {lse.dtype}")
    rows = (q.shape[0], q.shape[2], q.shape[1]) if q.dim() == 4 else None
    if rows is not None and lse.shape != rows:
        raise ValueError(f"lse must be (B, Hq, T) = {rows}, got {tuple(lse.shape)}")
    _check_qkv(q, k, v, (("o", o), ("do", do)))
    check_operand(lse, "lse", torch.float32, q.device)
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    kv_valid_len, valid_ptr = _kv_valid_ptr(kv_valid_len, B, q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:       # no query or no key: zeros
        return dq.zero_(), dk.zero_(), dv.zero_()
    dvec = torch.empty((B, Hq, T), dtype=torch.float32, device=q.device)
    kernel = BACKWARD if q.dtype == torch.float32 else BACKWARD_BF16
    with torch.cuda.device(q.device):
        kernel.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                        do.data_ptr(), lse.data_ptr(), dvec.data_ptr(),
                        valid_ptr, B, T, S, Hq, Hkv, D, int(causal),
                        int(window), int(q_offset), 1.0 / math.sqrt(D),
                        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                        stream=torch.cuda.current_stream().cuda_stream)
    return dq, dk, dv
