"""The two pieces of ``repro.serve.scheduler`` that the equal-length
serving path needs: per-request sampling and the continuous-batching
gate.  The continuous scheduler itself (length buckets, slot pool,
chunked prefill) is not ported yet: ROADMAP Queue 1 item 9."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig


def supports_continuous_batching(cfg: ArchConfig) -> bool:
    """Bucketed prefill + slot-pool decode needs a pure-attention decoder:
    recurrent layers would integrate pad tokens into their state, MoE
    capacity would let pads evict real tokens, absolute sinusoidal
    positions are scalar-offset only, and SWA ring compaction could drop
    real tokens behind the pads."""
    return (cfg.hybrid is None and cfg.xlstm is None and cfg.encdec is None
            and cfg.vlm is None and cfg.moe is None and cfg.rope_theta > 0
            and cfg.sliding_window == 0)


def sample_tokens(logits: torch.Tensor, temps: torch.Tensor,
                  gen: torch.Generator) -> torch.Tensor:
    """Per-request sampling on the logits' device: rows with temp <= 0 take
    the argmax, others draw categorically at their own temperature (the
    Gumbel-max draw of ``jax.random.categorical``, from ``gen``, which
    lives on the logits' device).  Returns (B,) int64."""
    greedy_t = torch.argmax(logits, dim=-1)
    scaled = logits / torch.clamp(temps, min=1e-6)[:, None]
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(u.dtype).tiny)))
    drawn = torch.argmax(scaled + gumbel, dim=-1)
    return torch.where(temps <= 0.0, greedy_t, drawn)
