"""The pieces of ``repro.serve.scheduler`` that the port's serving paths
need: per-request sampling and the continuous-batching gate (the
equal-length LLM path), and the host-side slot pool (the offload
gateway's Remote-NN feature slots).  The continuous scheduler itself
(length buckets, paged decode pool, chunked prefill) is not ported yet:
ROADMAP Queue 1 item 9."""
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


class SlotError(RuntimeError):
    """Slot-pool misuse: acquiring an occupied slot, releasing a free
    slot (double release), or releasing a slot on behalf of a request
    that does not own it.  Preemption makes these real hazards — a
    suspend races admission for the slot it frees — so the pool fails
    loudly instead of silently corrupting occupancy."""


class SlotPool:
    """Host-side bookkeeping for a fixed set of batch slots.

    ``rids[i]`` is the request occupying slot i (None = free).  The
    continuous scheduler (decode slots) and the offload gateway
    (remote-NN feature slots) share this discipline: work is admitted
    into free slots, one fixed-shape device program runs over the whole
    pool, and slots are released as requests finish — the compiled batch
    shape never changes."""

    def __init__(self, n_slots: int):
        self.rids: list = [None] * n_slots

    def __len__(self) -> int:
        return len(self.rids)

    def free(self) -> list[int]:
        return [i for i, r in enumerate(self.rids) if r is None]

    def acquire(self, slot: int, rid) -> None:
        if self.rids[slot] is not None:
            raise SlotError(f"slot {slot} already occupied "
                            f"by {self.rids[slot]!r}")
        self.rids[slot] = rid

    def release(self, slot: int, rid=None):
        """Free a slot and return its occupant.  A free slot raises
        (double release); passing ``rid`` asserts the expected occupant,
        so a preempting caller can never free a slot that was already
        re-admitted under a fresher request."""
        cur = self.rids[slot]
        if cur is None:
            raise SlotError(f"slot {slot} released twice (already free)")
        if rid is not None and cur != rid:
            raise SlotError(f"slot {slot} is owned by {cur!r}, "
                            f"not {rid!r}")
        self.rids[slot] = None
        return cur

    def occupied(self) -> list[tuple[int, object]]:
        return [(i, r) for i, r in enumerate(self.rids) if r is not None]

    def any_occupied(self) -> bool:
        return any(r is not None for r in self.rids)
