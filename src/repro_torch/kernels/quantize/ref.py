"""Plain PyTorch version of the nearest-center quantizer."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import nearest_center_scan


def quantize_ref(x: torch.Tensor, centers: torch.Tensor):
    """x: any shape -> (indices int32, dequantized x.dtype)."""
    idx, deq = nearest_center_scan(x.float(), centers.float())
    return idx, deq.to(x.dtype)
