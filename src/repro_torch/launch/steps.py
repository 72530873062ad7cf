"""The LM steps on one device and their input specs, as
``repro.launch.steps``.

``make_train_step``: SGD-momentum with gradient accumulation over
microbatches; ``n_microbatches`` picks their count from the width.  The
arithmetic is JAX's: the microbatch gradients summed into fp32 zeros in
order and divided by their count, the loss as the sum of loss / n, then
``new_m`` / ``new_p`` in fp32 and cast back to each leaf's dtype.  bf16
params (the MoE archs at full size) give bf16 gradients, as
``jax.value_and_grad`` does; ``bf16_grads`` casts the gradient to
bfloat16 as JAX does, on its one-microbatch branch only.

Where JAX scans the microbatches inside one jitted program, the port loops
over them eagerly, each through ``repro_torch.value_and_grad`` of
``models/backbone.py::forward_loss``; the accumulation is in place.

``make_serve_step`` (one decode step) and ``make_prefill_step`` wrap the
backbone's ``decode_step`` and ``prefill``.  The specs
(``make_batch_specs``, ``params_specs``, ``opt_specs``, ``cache_specs``)
are tensors on torch's ``meta`` device, JAX's ShapeDtypeStructs: shapes
and dtypes, nothing allocated and nothing drawn (``nn/init.py`` draws no
weight for a meta tensor), so arctic-480b's tree costs milliseconds.
``Strategy``, ``batch_shardings`` and ``lower_step`` need a mesh and wait
for ROADMAP Queue 1 item 7b.
"""
from __future__ import annotations

import torch

from repro_torch import tree_leaves, tree_map, value_and_grad
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.models import backbone as bb


def n_microbatches(cfg: ArchConfig, shape: InputShape) -> int:
    """Gradient-accumulation factor: keeps per-device activation memory
    bounded for the wide architectures (power of two, divides batch)."""
    if shape.kind != "train":
        return 1
    if cfg.d_model >= 7000:
        n = 16
    elif cfg.d_model >= 4096:
        n = 8
    elif cfg.d_model >= 1536:
        n = 2
    else:
        n = 1
    while shape.global_batch % n:
        n //= 2
    return max(1, n)


def make_batch_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    """Meta tensors of one training / prefill batch: a VLM's ``patches``
    (B, P, vision_dim) and an enc-dec's ``frames`` (B, F, d) in cfg.dtype,
    ``tokens`` (and, to train, ``labels``) (B, T - P) int32."""
    B, T = shape.global_batch, shape.seq_len
    meta = {"device": "meta"}
    batch = {}
    t_text = T
    if cfg.vlm is not None:
        batch["patches"] = torch.empty((B, cfg.vlm.n_patches, cfg.vlm.vision_dim),
                                       dtype=cfg.dtype, **meta)
        t_text = T - cfg.vlm.n_patches
    if cfg.encdec is not None:
        batch["frames"] = torch.empty((B, cfg.encdec.n_frames, cfg.d_model),
                                      dtype=cfg.dtype, **meta)
    batch["tokens"] = torch.empty((B, t_text), dtype=torch.int32, **meta)
    if shape.kind == "train":
        batch["labels"] = torch.empty((B, t_text), dtype=torch.int32, **meta)
    return batch


def params_specs(cfg: ArchConfig) -> dict:
    """The parameter tree as meta tensors: ``init_params``' structure,
    shapes and dtypes, with nothing drawn or allocated."""
    return bb.init_params(cfg, device="meta")


def opt_specs(params_sds) -> dict:
    return {"momentum": params_sds}


def cache_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    """The decode cache of ``shape`` (its batch and context) as meta
    tensors; ``long_500k`` takes the long-context window."""
    return bb.init_cache(cfg, shape.global_batch, shape.seq_len,
                         long_context=shape.name == "long_500k", device="meta")


def opt_init(params) -> dict:
    """The train step's optimizer state: zero momentum in each param's
    dtype (``repro.launch.steps.opt_specs``' tree)."""
    return {"momentum": tree_map(torch.zeros_like, params)}


def make_train_step(cfg: ArchConfig, shape: InputShape, *,
                    lr: float = 1e-3, momentum: float = 0.9,
                    weight_decay: float = 0.0,
                    n_micro_override: "int | None" = None,
                    bf16_grads: bool = False):
    """(params, opt, batch) -> (params, opt, {"loss"}) with microbatching.

    batch: {"tokens", "labels"} of (B, T) integers (tensors or numpy, moved
    to the params' device); B must split into the microbatches.  Returns
    new trees; the inputs are left as they are."""
    n_micro = n_micro_override or n_microbatches(cfg, shape)
    window = cfg.sliding_window

    def loss_fn(params, mb):
        return bb.forward_loss(cfg, params, mb, window=window)

    def train_step(params, opt, batch):
        dev = tree_leaves(params)[0].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if n_micro == 1:
            (loss, _), grads = value_and_grad(lambda p: loss_fn(p, batch), params)
            if bf16_grads:
                grads = tree_map(lambda g: g.to(torch.bfloat16), grads)
        else:
            mbs = {k: v.reshape((n_micro, v.shape[0] // n_micro) + v.shape[1:])
                   for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            loss = torch.zeros((), device=dev)
            for i in range(n_micro):
                mb = {k: v[i] for k, v in mbs.items()}
                (loss_i, _), g = value_and_grad(lambda p: loss_fn(p, mb), params)
                tree_map(lambda acc, gi: acc.add_(gi), grads, g)
                loss = loss + loss_i / n_micro
                del g
            grads = tree_map(lambda g: g / n_micro, grads)

        with torch.no_grad():
            def new_m(p, g, m):
                g32 = g.float() + weight_decay * p.float()
                return (momentum * m.float() + g32).to(m.dtype)

            def new_p(p, m):
                return (p.float() - lr * m.float()).to(p.dtype)

            m_upd = tree_map(new_m, params, grads, opt["momentum"])
            p_upd = tree_map(new_p, params, m_upd)
        return p_upd, {"momentum": m_upd}, {"loss": loss}

    return train_step


def make_serve_step(cfg: ArchConfig, shape: InputShape):
    """(params, tokens (B, 1), cache, cache_len) -> (logits, cache): one
    decode step, the cache written in place."""

    def serve_step(params, tokens, cache, cache_len):
        return bb.decode_step(cfg, params, tokens, cache, cache_len)

    return serve_step


def make_prefill_step(cfg: ArchConfig, shape: InputShape):
    """(params, batch) -> (last-token logits, cache) over a context of
    ``shape.seq_len``; ``long_500k`` prefills with the long-context
    window."""
    long = shape.name == "long_500k"

    def prefill_step(params, batch):
        logits, cache, _ = bb.prefill(cfg, params, batch, long_context=long,
                                      max_len=shape.seq_len)
        return logits, cache

    return prefill_step
