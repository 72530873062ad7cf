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
    stops at, and ``steps`` counts as it does.  Requests with ``extras``
    (patches of a VLM, frames of an enc-dec) take this path only: every
    request of a call must carry the same keys, and the context a row
    holds counts its patches.
  * continuous batching — mixed lengths and deadlines route through
    ``repro_torch.serve.scheduler.ContinuousScheduler`` (built lazily,
    seeded with ``seed + 1``).  Architectures the scheduler rules out
    (MoE and the recurrent xLSTM among them) fall back to one equal-length
    call per prompt length (so do requests with extras); deadlines on
    those raise ValueError.

An MoE arch's equal-length call keeps each forward's aux losses in
``ServeEngine.moe_aux``: {"prefill": {...}, "decode": [{...} a step]},
each {"load_balance_loss", "dropped_fraction"} as () float32 tensors on
the device (read them after the call; nothing waits on them).

With a ``mesh`` (``launch.mesh.make_serving_mesh``) everything routes
through the scheduler, whose slot pool shards over the data axes and
whose params go tensor-parallel (``serve/scheduler.py``): the
equal-length path is single-device, and dropping the mesh would serve
unsharded.  An architecture the scheduler gates out, or a request with
extras, raises under a mesh, as in the JAX package; so do params already
distributed (DTensors) with no ``mesh``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device, sharded
from repro_torch.configs.base import ArchConfig
from repro_torch.models import backbone as bb
from repro_torch.serve import telemetry as _telemetry
from repro_torch.serve.scheduler import (
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


def _stack_extras(requests: list[Request], device) -> dict:
    """The extras batch: every request must carry the same keys (a mixed
    batch would silently drop or misalign modality inputs)."""
    key_sets = {frozenset((r.extras or {}).keys()) for r in requests}
    if len(key_sets) > 1:
        raise ValueError(
            "all requests in a batch must carry the same extras keys; got "
            + " vs ".join(str(sorted(s)) for s in key_sets))
    ex = requests[0].extras or {}
    return {k: torch.as_tensor(np.stack([np.asarray(r.extras[k]) for r in requests]),
                               device=device) for k in ex}


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
        if mesh is not None and not supports_continuous_batching(cfg):
            raise ValueError(
                f"{cfg.name}: sharded serving runs through the continuous "
                "scheduler, which this architecture gates out; a meshed "
                "engine would silently serve unsharded on one device")
        if mesh is None and sharded.mesh_of(params) is not None:
            raise ValueError(
                "params are distributed on a mesh: pass it as mesh= (the "
                "continuous scheduler serves them), or pass plain tensors")
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
        self.mesh = mesh            # scheduler path only
        self._seed = seed
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._sched_cfg = scheduler or SchedulerConfig()
        self._sched: Optional[ContinuousScheduler] = None
        self.moe_aux: Optional[dict] = None

    @property
    def scheduler(self) -> ContinuousScheduler:
        """The lazily built continuous-batching scheduler (one pool shared
        across generate calls)."""
        if self._sched is None:
            self._sched = ContinuousScheduler(
                self.cfg, self.params, sched=self._sched_cfg,
                max_len=self.max_len, seed=self._seed + 1, mesh=self.mesh,
                telemetry=self.tel, device=self.device)
        return self._sched

    def generate(self, requests: list[Request]) -> list[Completion]:
        """One Completion per request, in submission order.  Equal-length
        prompts without deadlines take the single-batch path (unless a
        mesh is set); mixed lengths, deadlines and a mesh run through the
        continuous scheduler, or
        through equal-length grouping where the architecture rules the
        scheduler out (deadlines then raise ValueError)."""
        if not requests:
            raise ValueError("empty batch")
        schedulable = (supports_continuous_batching(self.cfg)
                       and all(r.extras is None for r in requests))
        deadlines = any(r.deadline_s is not None for r in requests)
        if deadlines and not schedulable:
            raise ValueError(
                "per-request deadlines are honored by the continuous "
                "scheduler only; this architecture (or extras-carrying "
                "batch) routes through the equal-length path, which cannot "
                "evict mid-decode")
        if self.mesh is not None and not schedulable:
            raise ValueError(
                "sharded serving cannot take requests with extras: they route "
                "through the single-device path, dropping the mesh")
        if (len({len(r.tokens) for r in requests}) == 1 and not deadlines
                and self.mesh is None):
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
        batch = {"tokens": tokens, **_stack_extras(requests, dev)}
        total_T = tokens.shape[1]
        if self.cfg.vlm is not None and "patches" in batch:
            total_T += batch["patches"].shape[1]
        max_new = max(r.max_new_tokens for r in requests)
        if max_new > self.max_len:
            raise ValueError(f"max_new_tokens {max_new} exceeds engine "
                             f"max_len {self.max_len}")
        if self.cfg.sliding_window == 0 and total_T + max_new > self.max_len:
            # full-attention caches are not rings: a wrap would overwrite
            # context the model still attends to
            raise ValueError(
                f"context {total_T} + max_new_tokens {max_new} exceeds "
                f"engine max_len {self.max_len}: decode would ring-wrap over "
                "live context")
        aux = None
        if self.cfg.moe is not None:
            aux = self.moe_aux = {"prefill": {}, "decode": []}
        logits, cache, total_T = bb.prefill(
            self.cfg, self.params, batch, max_len=self.max_len,
            aux=None if aux is None else aux["prefill"])
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
            step_aux = None
            if aux is not None:
                step_aux = {}
                aux["decode"].append(step_aux)
            logits, cache = bb.decode_step(self.cfg, self.params, tok[:, None],
                                           cache, cache_len, aux=step_aux)
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
