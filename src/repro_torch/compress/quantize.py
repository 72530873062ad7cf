"""Learning-based quantization of offloaded features (paper §6): a
trainable scalar codebook of L centers.  Training uses the
straight-through estimator (hard values forward, the softmax-weighted
soft assignment's gradient backward); deployment uses hard
nearest-center indices, which the runtime LZW-compresses and puts on the
radio.  The hard half is the quantize kernel on CUDA tensors."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.quantize.ops import quantize_op


def _fma_f32(a, b, c) -> np.ndarray:
    """float32(a * b + c) with one rounding, as a fused multiply-add gives
    it, for float32 a, b, c.  The product is exact in float64; TwoSum keeps
    the float64 sum's rounding error, which decides the float32 rounding
    where that sum lands exactly on a float32 midpoint."""
    a, b, c = np.broadcast_arrays(*(np.asarray(t, np.float64) for t in (a, b, c)))
    p = a * b
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    r = s.astype(np.float32)
    rd = r.astype(np.float64)
    other = np.nextafter(r, np.where(rd > s, -np.inf, np.inf).astype(np.float32))
    mid = (rd + other.astype(np.float64)) / 2
    wrong = (s == mid) & (err != 0) & (np.sign(rd - s) != np.sign(err))
    return np.where(wrong, other, r)


def linspace_f32(n: int, lo: float, hi: float) -> np.ndarray:
    """``jnp.linspace(lo, hi, n)`` in float32, bit for bit, where
    ``torch.linspace`` is a few ulp off.

    JAX computes element i < n-1 as ``lo*(1 - i*c) + hi*(i*c)`` with
    ``c = 1/(n-1)``, all in float32, and the last as ``hi``; jax 0.9.0's
    program on the CPU evaluates it as ``fma(i, hi*c, lo*(1 - i*c))``,
    except element 1 when n <= 34, which it contracts as
    ``fma(lo, 1 - c, hi*c)``.  ``lo`` and ``hi`` are rounded to float32
    first, as JAX's weakly typed floats are."""
    f32 = np.float32
    lo, hi = f32(lo), f32(hi)
    if n <= 1:
        return np.full((max(n, 0),), lo, f32)
    div = n - 1
    c = f32(1) / f32(div)
    i = np.arange(div, dtype=f32)
    hc = f32(hi * c)
    out = _fma_f32(i, hc, lo * (f32(1) - i * c))
    if 2 <= div <= 33:
        out[1] = _fma_f32(lo, f32(1) - c, hc)
    return np.append(out, hi).astype(f32)


def quantizer_init(n_centers: int = 8, lo: float = -4.0,
                   hi: float = 4.0) -> dict:
    """Codebook initialized to a uniform grid (learns during training),
    rounded as the JAX package's ``jnp.linspace`` rounds it."""
    return {"centers": torch.from_numpy(linspace_f32(n_centers, lo, hi))}


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
