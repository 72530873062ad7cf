"""Activation functions, the SwiGLU feed-forward (llama/qwen style) and
the plain GELU MLP with biases (whisper style)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn.linear import dense, dense_init


def silu(x):
    return x * torch.sigmoid(x)


def gelu(x):
    """GELU in its tanh form, as the JAX package's ``jax.nn.gelu(x,
    approximate=True)``."""
    return F.gelu(x, approximate="tanh")


def swiglu_ffn_init(gen: torch.Generator, d_model: int, d_ff: int,
                    **place) -> dict:
    """``place``: the ``dtype`` / ``device`` keywords of ``dense_init``."""
    return {
        "gate": dense_init(gen, d_model, d_ff, use_bias=False, **place),
        "up": dense_init(gen, d_model, d_ff, use_bias=False, **place),
        "down": dense_init(gen, d_ff, d_model, use_bias=False, **place),
    }


def swiglu_ffn(params, x):
    g = silu(dense(params["gate"], x))
    u = dense(params["up"], x)
    return dense(params["down"], g * u)


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, **place) -> dict:
    return {
        "fc1": dense_init(gen, d_model, d_ff, use_bias=True, **place),
        "fc2": dense_init(gen, d_ff, d_model, use_bias=True, **place),
    }


def mlp(params, x):
    return dense(params["fc2"], gelu(dense(params["fc1"], x)))
