"""Rotary position embeddings (RoPE), split by halves (not interleaved),
as ``repro.nn.rope``."""
from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), float32."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., T, H, D); positions: (..., T) integer positions that
    broadcast against x's batch dims.  Returns x's shape and dtype."""
    d = x.shape[-1]
    inv_freq = rope_frequencies(d, theta, device=x.device)
    angles = positions[..., None].float() * inv_freq          # (..., T, d/2)
    angles = angles[..., None, :]                             # (..., T, 1, d/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
