"""Serving engine: request queue -> bucketed prefill -> slot-pool decode.

The port of ``repro.serve.engine``.  Two execution paths share one
``generate`` API, routed as in the JAX package:

  * equal-length path — requests whose prompts share one length and
    carry no deadline go through one prefill of the whole batch, then a
    decode loop on the device: the first token comes from the prefill
    logits, then each step runs ``decode_step``, samples on the device
    (per-request temperature, 0 => greedy), writes the token into a
    (B, max_len) buffer and masks rows that hit their EOS or their own
    ``max_new_tokens``.  The loop reads one flag per step back to the
    host (has every row finished?), so it stops at the step the JAX loop
    stops at, and ``steps`` counts as it does.
  * continuous batching — mixed lengths and deadlines route through
    ``repro_torch.serve.scheduler.ContinuousScheduler`` (built lazily,
    seeded with ``seed + 1``).  Architectures the scheduler rules out
    fall back to one equal-length call per prompt length; deadlines on
    those raise ValueError.

A mesh (sharded serving) waits for ROADMAP Queue 1 item 7.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import backbone as bb
from repro_torch.serve import telemetry as _telemetry
from repro_torch.serve.scheduler import (
    MESH_ITEM,
    ContinuousScheduler,
    SchedulerConfig,
    sample_tokens,
    supports_continuous_batching,
)


@dataclasses.dataclass
class Request:
    tokens: np.ndarray                 # (T,) prompt
    max_new_tokens: int = 16
    eos_id: int = -1                   # -1: never stops early
    temperature: float = 0.0           # 0 => greedy
    extras: Optional[dict] = None      # patches / frames for vlm / audio
    deadline_s: Optional[float] = None  # wall seconds from submit; past it
                                        # the scheduler evicts the request
                                        # between chunks (partial tokens,
                                        # Completion.timed_out=True)


@dataclasses.dataclass
class Completion:
    tokens: np.ndarray
    steps: int
    timed_out: bool = False            # deadline-evicted mid-decode: tokens
                                       # hold whatever was generated in time


class ServeEngine:
    """Generates for a batch of requests.

    params live on ``device`` (CUDA by default; raises when CUDA is absent
    and no device was named).  ``seed`` seeds the equal-length path's
    sampling generator, which advances from one ``generate`` call to the
    next; the scheduler's is seeded with ``seed + 1``.  ``scheduler``
    configures the continuous scheduler, ``telemetry`` instruments it."""

    def __init__(self, cfg: ArchConfig, params, *, max_len: int = 256,
                 seed: int = 0, scheduler: Optional[SchedulerConfig] = None,
                 mesh=None, telemetry=None, device=None):
        if mesh is not None:
            raise NotImplementedError(
                f"sharded serving (mesh=) waits for {MESH_ITEM}")
        bb.sublayer_specs(cfg)
        self.device = resolve_device(device)
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params are on {table.device}, the engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.tel = telemetry if telemetry is not None else _telemetry.default()
        self._seed = seed
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._sched_cfg = scheduler or SchedulerConfig()
        self._sched: Optional[ContinuousScheduler] = None

    @property
    def scheduler(self) -> ContinuousScheduler:
        """The lazily built continuous-batching scheduler (one pool shared
        across generate calls)."""
        if self._sched is None:
            self._sched = ContinuousScheduler(
                self.cfg, self.params, sched=self._sched_cfg,
                max_len=self.max_len, seed=self._seed + 1,
                telemetry=self.tel, device=self.device)
        return self._sched

    def generate(self, requests: list[Request]) -> list[Completion]:
        """One Completion per request, in submission order.  Equal-length
        prompts without deadlines take the single-batch path; mixed
        lengths and deadlines run through the continuous scheduler, or
        through equal-length grouping where the architecture rules the
        scheduler out (deadlines then raise ValueError)."""
        if not requests:
            raise ValueError("empty batch")
        if any(r.extras is not None for r in requests):
            raise NotImplementedError(
                "requests with extras (patches / frames) wait for ROADMAP "
                "Queue 1 item 6 (arch zoo)")
        schedulable = supports_continuous_batching(self.cfg)
        deadlines = any(r.deadline_s is not None for r in requests)
        if deadlines and not schedulable:
            raise ValueError(
                "per-request deadlines are honored by the continuous "
                "scheduler only; this architecture routes through the "
                "equal-length path, which cannot evict mid-decode")
        if len({len(r.tokens) for r in requests}) == 1 and not deadlines:
            return self._generate_equal(requests)
        if schedulable:
            sched = self.scheduler
            rids = [sched.submit(r) for r in requests]
            outs = sched.run()
            return [outs[rid] for rid in rids]
        # fallback: one equal-length call per prompt-length group
        by_len: dict[int, list[int]] = {}
        for i, r in enumerate(requests):
            by_len.setdefault(len(r.tokens), []).append(i)
        out: list[Optional[Completion]] = [None] * len(requests)
        for idxs in by_len.values():
            for i, c in zip(idxs, self._generate_equal(
                    [requests[i] for i in idxs])):
                out[i] = c
        return out

    def _generate_equal(self, requests: list[Request]) -> list[Completion]:
        dev, B = self.device, len(requests)
        tokens = torch.as_tensor(np.stack([r.tokens for r in requests]),
                                 dtype=torch.long, device=dev)
        T = tokens.shape[1]
        max_new = max(r.max_new_tokens for r in requests)
        if max_new > self.max_len:
            raise ValueError(f"max_new_tokens {max_new} exceeds engine "
                             f"max_len {self.max_len}")
        if self.cfg.sliding_window == 0 and T + max_new > self.max_len:
            # full-attention caches are not rings: a wrap would overwrite
            # context the model still attends to
            raise ValueError(
                f"context {T} + max_new_tokens {max_new} exceeds "
                f"engine max_len {self.max_len}: decode would ring-wrap over "
                "live context")
        logits, cache, total_T = bb.prefill(self.cfg, self.params,
                                            {"tokens": tokens},
                                            max_len=self.max_len)
        temps = torch.tensor([r.temperature for r in requests],
                             dtype=torch.float32, device=dev)
        greedy = all(r.temperature <= 0.0 for r in requests)
        eos_ids = torch.tensor([r.eos_id for r in requests], device=dev)
        max_lens = torch.tensor([r.max_new_tokens for r in requests], device=dev)

        def sample(lg):
            if greedy:
                return torch.argmax(lg, dim=-1)
            return sample_tokens(lg, temps, self._gen)

        rows = torch.arange(B, device=dev)
        tok = sample(logits)
        buf = torch.zeros((B, self.max_len), dtype=torch.long, device=dev)
        buf[:, 0] = tok
        lengths = torch.ones(B, dtype=torch.long, device=dev)
        done = (tok == eos_ids) | (lengths >= max_lens)
        step, cache_len = 0, total_T
        while step < max_new - 1 and not bool(done.all()):
            logits, cache = bb.decode_step(self.cfg, self.params, tok[:, None],
                                           cache, cache_len)
            t = sample(logits)
            active = ~done
            # finished rows rewrite their own last token: nothing moves
            pos = torch.where(active, lengths, lengths - 1)
            buf[rows, pos] = torch.where(active, t, buf[rows, pos])
            lengths = lengths + active.long()
            done = done | (active & ((t == eos_ids) | (lengths >= max_lens)))
            tok, step, cache_len = t, step + 1, cache_len + 1
        buf, lengths = buf.cpu().numpy(), lengths.cpu().numpy()
        return [Completion(buf[b, :lengths[b]].astype(np.int32), step + 1)
                for b in range(B)]
