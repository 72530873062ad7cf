"""Shared helpers of the kernels' plain PyTorch versions."""
from __future__ import annotations

import torch


def round_up(x: int, m: int) -> int:
    """Smallest multiple of m that is >= x."""
    return -(-x // m) * m


def auto_page_size(S: int, candidates: tuple[int, ...] = (128, 64, 32)) -> int:
    """Largest candidate page size that divides a cache of width S into at
    least two pages; 0 when none does."""
    for p in candidates:
        if S % p == 0 and S // p >= 2:
            return p
    return 0


def nearest_center_scan(xf: torch.Tensor, centers_f32: torch.Tensor):
    """Nearest-center search, the arithmetic of the CUDA kernels.

    xf: float32 tensor (any shape); centers_f32: 1-D float32 codebook
    (any L; the kernels take L <= 16 fused, L <= 256 standalone).  A strict ``<`` scan from center 0 upward, so ties go to
    the lowest index, bit-identical to argmin over squared distances on
    finite inputs.  Returns (indices int32, center values float32)."""
    best_d = torch.full_like(xf, float("inf"))
    best_i = torch.zeros(xf.shape, dtype=torch.int32, device=xf.device)
    best_v = torch.zeros_like(xf)
    for c in range(centers_f32.shape[0]):
        cv = centers_f32[c]
        t = xf - cv
        d = t * t
        take = d < best_d
        best_d = torch.where(take, d, best_d)
        best_i = torch.where(take, c, best_i)
        best_v = torch.where(take, cv, best_v)
    return best_i, best_v
