"""Launch wrappers of the RMSNorm CUDA kernels (csrc/rmsnorm.cu and its
gradient, csrc/rmsnorm_backward.cu).

The forward replaces ``repro.kernels.rmsnorm.kernel.rmsnorm_tpu``, in
float32 (``rmsnorm_launch``) and in bf16 (``rmsnorm_bf16_launch``, a
kernel and a launch count of its own in the same library); the backward
has no TPU counterpart (the JAX model differentiates its jnp
``rmsnorm_apply``) and has the same two halves (``rmsnorm_backward_launch``
and ``rmsnorm_backward_bf16_launch``, each with its own launch count).
The source notes in the .cu give bounds and designs.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import KERNEL_DTYPES, CudaKernel, check_operand

_P = ctypes.c_void_p
_FORWARD_ARGS = [_P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_float, _P]
KERNEL = CudaKernel("rmsnorm", _FORWARD_ARGS)
KERNEL_BF16 = CudaKernel("rmsnorm_bf16", _FORWARD_ARGS, library="rmsnorm")
_BACKWARD_ARGS = [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                  _P, _P, _P]
BACKWARD = CudaKernel("rmsnorm_backward", _BACKWARD_ARGS)
BACKWARD_BF16 = CudaKernel("rmsnorm_backward_bf16", _BACKWARD_ARGS,
                           library="rmsnorm_backward")
MAX_WIDTH = 8192
# the backward's grid: rows are dealt to at most this many blocks, whose
# partial dscale rows are summed in block order (kBwdBlocks in the .cu)
BACKWARD_BLOCKS = 1024


def _check(x, scale):
    if x.dim() != 2 or scale.shape != x.shape[-1:] or not 1 <= x.shape[1] <= MAX_WIDTH:
        raise ValueError(f"x must be (N, d <= {MAX_WIDTH}) and scale (d,), got "
                         f"{tuple(x.shape)}, {tuple(scale.shape)}")
    check_operand(x, "x", KERNEL_DTYPES)
    check_operand(scale, "scale", x.dtype, x.device)


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6):
    """x: (N, d) contiguous float32 or bfloat16 CUDA rows, any N, d <= 8192;
    scale: (d,) of x's dtype on the same device.  Returns (N, d) in x's
    dtype: bf16 is widened to fp32, normalised in fp32 and rounded once at
    the end (its own kernel, within 2e-2 of the plain version; the sum of
    squares in another order than the float32 kernel's).  Bitwise the same
    from call to call.  Raises ValueError on any other input."""
    _check(x, scale)
    y = torch.empty_like(x)
    kernel = KERNEL if x.dtype == torch.float32 else KERNEL_BF16
    with torch.cuda.device(x.device):
        kernel.launch(x.data_ptr(), scale.data_ptr(), x.shape[0], x.shape[1],
                      eps, y.data_ptr(),
                      stream=torch.cuda.current_stream().cuda_stream)
    return y


def rmsnorm_backward_cuda(x: torch.Tensor, scale: torch.Tensor,
                          g: torch.Tensor, *, eps: float = 1e-6):
    """The gradient of ``rmsnorm_cuda`` at (x, scale) against g = dL/dy:
    x, scale and g all float32 or all bfloat16, as ``rmsnorm_cuda`` takes
    them (g of x's shape).  Returns (dx (N, d), dscale (d,)) in x's dtype,
    bitwise the same from call to call; the bf16 half is bitwise the
    float32 kernel on the widened inputs, rounded to bf16 once.  Raises
    ValueError on any other input."""
    _check(x, scale)
    if g.shape != x.shape:
        raise ValueError(f"g must be x's shape {tuple(x.shape)}, got {tuple(g.shape)}")
    check_operand(g, "g", x.dtype, x.device)
    N, d = x.shape
    dx = torch.empty_like(x)
    dscale = torch.empty_like(scale)
    partial = torch.empty((max(1, min(N, BACKWARD_BLOCKS)), d),
                          dtype=torch.float32, device=x.device)
    kernel = BACKWARD if x.dtype == torch.float32 else BACKWARD_BF16
    with torch.cuda.device(x.device):
        kernel.launch(x.data_ptr(), scale.data_ptr(), g.data_ptr(), N, d,
                        eps, dx.data_ptr(), partial.data_ptr(),
                        dscale.data_ptr(),
                        stream=torch.cuda.current_stream().cuda_stream)
    return dx, dscale
