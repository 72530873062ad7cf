"""Learning-based quantization of offloaded features (paper §6): a
trainable scalar codebook of L centers.  Training uses the
straight-through estimator (hard values forward, the softmax-weighted
soft assignment's gradient backward); deployment uses hard
nearest-center indices, which the runtime LZW-compresses and puts on the
radio.  The hard half is the quantize kernel on CUDA tensors."""
from __future__ import annotations

import torch

from repro_torch.kernels.quantize.ops import quantize_op


def quantizer_init(n_centers: int = 8, lo: float = -4.0,
                   hi: float = 4.0) -> dict:
    """Codebook initialized to a uniform grid (learns during training)."""
    return {"centers": torch.linspace(lo, hi, n_centers, dtype=torch.float32)}


def soft_quantize(params, x, *, temperature: float = 1.0):
    """Differentiable soft assignment: sum_l softmax(-d^2/T) * c_l."""
    d2 = (x[..., None] - params["centers"]) ** 2
    w = torch.softmax(-d2 / temperature, dim=-1)
    return torch.sum(w * params["centers"], dim=-1)


def hard_indices(params, x) -> torch.Tensor:
    """Nearest-center index per element (int32; what gets transmitted).
    Ties go to the lowest index.  On a CUDA tensor this is the quantize
    kernel."""
    idx, _ = quantize_op(x.contiguous(), params["centers"])
    return idx


def dequantize(params, idx) -> torch.Tensor:
    return params["centers"][idx]


def quantize_ste(params, x, *, temperature: float = 1.0):
    """Train-time op: hard values forward, soft gradient backward (to x and
    to the centers).  The hard half runs without a graph, as JAX's
    ``stop_gradient`` cuts it: one quantize-kernel launch on CUDA."""
    soft = soft_quantize(params, x, temperature=temperature)
    with torch.no_grad():
        _, hard = quantize_op(x.detach().contiguous(), params["centers"].detach())
        step = hard - soft
    return soft + step


def quantization_bits(n_centers: int) -> int:
    return max(1, (n_centers - 1).bit_length())
