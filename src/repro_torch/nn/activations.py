"""Activation functions and the SwiGLU feed-forward (llama/qwen style)."""
from __future__ import annotations

import torch

from repro_torch.nn.linear import dense, dense_init


def silu(x):
    return x * torch.sigmoid(x)


def swiglu_ffn_init(gen: torch.Generator, d_model: int, d_ff: int) -> dict:
    return {
        "gate": dense_init(gen, d_model, d_ff, use_bias=False),
        "up": dense_init(gen, d_model, d_ff, use_bias=False),
        "down": dense_init(gen, d_ff, d_model, use_bias=False),
    }


def swiglu_ffn(params, x):
    g = silu(dense(params["gate"], x))
    u = dense(params["up"], x)
    return dense(params["down"], g * u)
