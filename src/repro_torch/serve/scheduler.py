"""Continuous-batching scheduler: bucketed prefill + paged slot-pool decode.

The port of ``repro.serve.scheduler``.  Admission right-pads each prompt
to the smallest configured length bucket, runs one prefill per group, and
*injects* the resulting rows into free slots of a fixed-width decode
pool.  Decoding runs in chunks of ``chunk`` steps over the whole pool:
per-slot EOS ids, token budgets and sampling temperatures live on the
device, so one set of launches serves every mix of requests.  Between
chunks the host *evicts* finished slots and admits queued requests into
the freed slots.

Where the JAX chunk is a ``while_loop`` that leaves early once no active
row runs, the port always runs ``chunk`` steps: a done row is masked on
the device (no token, no depth, no budget moves), so the steps after every
row has finished change no token, Completion or counter, and the host
never waits on the device inside a chunk.  ``steps_run`` counts the steps
dispatched; with telemetry enabled ``steps_live()`` counts those in which
a row ran (an add on the device per step, so only then).

The pool's KV cache is ``{"k", "v"}``, each (L, max_slots, kv_len, Hkv, D),
written IN PLACE: injects copy the pages a prompt covers
(``page_size``-granular, never the full pool width) and ``decode_step``
writes each row's new key at its own depth.  Slots keep whatever stale
keys the previous occupant left past an inject; decode masks them by
depth.  Long prompts admit through *chunked prefill*
(``backbone.prefill_chunk``): a prompt whose bucket exceeds
``prefill_segment`` stages one segment per round between decode chunks,
so a long admission never stalls the pool for more than one segment.

With ``SchedulerConfig.overlap`` (the default) the host runs one round
ahead of the card: round k's prefill segment and injects are enqueued
behind round k-1's decode chunk, and only then does the host wait for
round k-1's done flags.  Those (with the token buffer and counts) were
copied at dispatch into pinned host memory with ``non_blocking=True`` and
are waited on through a CUDA event, so nothing queued after the chunk is
waited on.  Every host-to-device copy of this module likewise goes through
pinned memory without blocking.  Evict/admit timing is round-identical to
``overlap=False``; completions report one round later.

With ``SchedulerConfig.prefix_cache`` the scheduler shares prompt-prefix
K/V pages across admissions (``serve.prefix_cache``): a short request
whose leading pages are resident admits through a *prefix wave* (seed
the pages into a fresh ``prefill_group``-row cache, prefill only the
suffixes in page-wide segments attending at the bucket width, one
inject), a staged one starts its segments past the resident whole
segments, and every admission pins its shareable pages until its slot is
released (``suspend`` parks the pins until the resumed admission
re-pins).  Not ported: the mesh-sharded pool (``mesh=``, ROADMAP Queue 1
item 7b), which raises NotImplementedError.

Correctness invariants (tested against one-request-at-a-time decode):
pad keys are masked out of prefill attention and pad/stale cache slots
are overwritten by decode writes before they become attendable; batch
rows are independent end to end, so evict/inject of one slot leaves every
other slot's cache bit for bit as it was.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from contextlib import nullcontext
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.common import round_up
from repro_torch.models import backbone as bb
from repro_torch.serve import telemetry as _telemetry
from repro_torch.serve.prefix_cache import PrefixCache

_NULL = nullcontext()     # reentrant: shared no-op for disabled telemetry
MESH_ITEM = "ROADMAP Queue 1 item 7b (mesh sharding)"


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    buckets: tuple[int, ...] = (8, 16, 32, 64, 128)
    max_slots: int = 8         # decode pool width (concurrent requests)
    prefill_group: int = 4     # fixed prefill batch
    chunk: int = 8             # decode steps per chunk
    page_size: int = 32        # KV copy granularity: injects move
                               # ceil(bucket / page_size) pages, not the
                               # full pool-width strip
    prefill_segment: int = 64  # buckets above this prefill in segments of
                               # this many tokens, interleaved with decode
                               # chunks (0 disables chunked prefill)
    overlap: bool = True       # pipeline host scheduling against the
                               # in-flight decode chunk: drain one round
                               # behind, prepare admissions while the
                               # device runs (False: serialized rounds)
    prefix_cache: bool = False  # share prompt-prefix KV pages across
                                # admissions (serve.prefix_cache): hits
                                # seed resident pages and prefill only
                                # the suffix
    prefix_hot_pages: int = 512  # device-resident page budget; pages a
                                 # live slot references are pinned past it
    kv_tier_mb: float = 0.0    # host cold-tier budget for demoted pages,
                               # quantized and bit-packed (0: demoted
                               # pages drop instead: exact, no reuse
                               # after demotion)
    kv_tier_bits: int = 8      # cold-tier codebook bits per element
    preempt: bool = False      # allow the streaming frontend to suspend
                               # pooled rows mid-decode (suspend/resume
                               # keeps partial tokens; resumed greedy
                               # output equals an uninterrupted run's)


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


@dataclasses.dataclass
class Suspended:
    """A request evicted mid-decode with its progress preserved.

    `request` is the request as originally submitted (prompt and full
    token budget); `generated` holds every token decoded before the
    suspension.  `submit_suspended` re-admits it through the ordinary
    prefill path — prompt + generated prefill as one longer prompt and
    the remaining budget decodes from there, so greedy output equals an
    uninterrupted run's.  `parked` (when the prefix cache is on) is the
    prefix cache's handle keeping the slot's pinned pages resident while
    the request waits to resume."""
    request: object
    generated: np.ndarray                  # (g,) int32 tokens so far
    deadline_at: Optional[float] = None    # absolute clock() deadline
    parked: Optional[object] = None        # PrefixCache.park handle


class ContinuousScheduler:
    """Drives a decode slot pool over an unbounded request queue.

    submit() enqueues and returns a request id; run() drains the queue and
    returns {rid: Completion}; step() advances one admit+decode round.
    """

    def __init__(self, cfg: ArchConfig, params, *,
                 sched: Optional[SchedulerConfig] = None,
                 max_len: int = 256, seed: int = 0, mesh=None,
                 clock=None, faults=None, telemetry=None, device=None):
        """params live on ``device`` (CUDA by default; raises when CUDA is
        absent and no device was named), and so does the pool.
        clock: wall-time source for request deadlines (default
        `time.monotonic`; tests inject a fake for determinism).
        faults: a `repro_torch.serve.faults.FaultInjector` whose
        `chunk_stalled(round)` stalls decode rounds — requests then leave
        through deadline eviction instead of hanging the drain loop — and
        whose `crashed(round)` raises EngineCrashError.
        telemetry: a `repro_torch.serve.telemetry.Telemetry`; the module
        default is disabled, and every hook guards on `tel.enabled`, so
        an uninstrumented run does no extra clock reads or copies
        (telemetry never reads `clock`)."""
        if not supports_continuous_batching(cfg):
            raise ValueError(
                f"{cfg.name}: continuous batching needs a pure-attention "
                "RoPE decoder (use ServeEngine's equal-length grouping)")
        if mesh is not None:
            raise NotImplementedError(
                f"a mesh-sharded slot pool (mesh=) waits for {MESH_ITEM}")
        self.sched = sched or SchedulerConfig()
        self.device = resolve_device(device)
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params are on {table.device}, the scheduler "
                             f"on {self.device}")
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.faults = faults
        self.tel = telemetry if telemetry is not None else _telemetry.default()
        self._clock = clock if clock is not None else time.monotonic
        self._deadlines: dict[int, float] = {}   # rid -> absolute clock()
        self._round = 0
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        S, L, dev = self.sched.max_slots, max_len, self.device
        # the pool's KV width is a power-of-two page count, as in the JAX
        # package (there so that decode attention always has a dense
        # divisor ladder to stop early on); requests still budget against
        # max_len
        page = self.sched.page_size
        n_pages = 1 << max(1, (round_up(max_len, page) // page - 1)
                           .bit_length())
        self._kv_len = page * n_pages
        self._pool = {
            "buf": torch.zeros((S, L), dtype=torch.long, device=dev),
            "gen": torch.zeros((S,), dtype=torch.long, device=dev),
            "done": torch.ones((S,), dtype=torch.bool, device=dev),
            "tok": torch.zeros((S, 1), dtype=torch.long, device=dev),
            "cache": bb.init_cache(cfg, S, self._kv_len, device=dev),
            "cache_len": torch.zeros((S,), dtype=torch.long, device=dev),
            "eos": torch.full((S,), -1, dtype=torch.long, device=dev),
            "max_new": torch.ones((S,), dtype=torch.long, device=dev),
            "temps": torch.zeros((S,), dtype=torch.float32, device=dev),
        }
        self._temps = np.zeros((S,), np.float32)   # host copy of "temps"
        self._rows = torch.arange(S, device=dev)
        self.steps_run = 0                          # decode steps dispatched
        self._steps_live = torch.zeros((), dtype=torch.long, device=dev)
        self._count_live = self.tel.enabled
        self._slots = SlotPool(S)
        self._queue: deque = deque()           # (rid, Request)
        self._staging: list[dict] = []         # chunked-prefill admissions
        self._results: dict[int, object] = {}
        self._next_rid = 0
        # suspend/resume bookkeeping: the request as submitted (so a
        # suspension can reconstruct the original prompt/budget), the
        # already-generated prefix a resumed rid prepends to every
        # stream/Completion, and the parked prefix-pin handle to drop once
        # the resumed rid is re-pinned at admission
        self._req_of: dict[int, object] = {}
        self._resume: dict[int, np.ndarray] = {}
        self._parked_tok: dict[int, object] = {}
        self._pending: Optional[dict] = None   # in-flight chunk snapshot
        # streaming hook: called between rounds with (rid, tokens_so_far)
        # for every live pooled request.  None (the default) skips the
        # per-round buffer reads entirely
        self.stream_cb: Optional[object] = None
        self.prefix = None
        if self.sched.prefix_cache:
            self.prefix = PrefixCache(
                page, hot_pages=self.sched.prefix_hot_pages,
                cold_bytes=int(self.sched.kv_tier_mb * (1 << 20)),
                bits=self.sched.kv_tier_bits)

    # ------------------------------------------------------------- device --

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the pool's device, copied from pinned memory
        without blocking the host on the queued work."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _fetch(self, names=("done", "buf", "gen")) -> dict:
        """Start copies of pool leaves to the host: pinned buffers filled
        without blocking, and an event recorded behind them (on the CPU,
        clones).  ``_landed`` waits for them."""
        if self.device.type != "cuda":
            return {"arrays": {n: self._pool[n].clone() for n in names},
                    "event": None}
        out = {}
        for n in names:
            src = self._pool[n]
            out[n] = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            out[n].copy_(src, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return {"arrays": out, "event": event}

    @staticmethod
    def _landed(fetch: dict) -> dict:
        if fetch["event"] is not None:
            fetch["event"].synchronize()
        return {n: t.numpy() for n, t in fetch["arrays"].items()}

    def _inject(self, slots: np.ndarray, rows: dict, logits0: torch.Tensor,
                prompt_lens: np.ndarray, eos: np.ndarray,
                max_new: np.ndarray, temps: np.ndarray) -> None:
        """Seed freshly prefilled requests into pool slots.

        slots: (G,) target slot per group row; dummy rows (group padding)
        carry slot == max_slots and are left out here, on the host.  The
        first token of each request is sampled from the prefill logits.

        rows arrive at the bucket's page-rounded width, so the cache copy
        moves only the pages the prompt covers; whatever the slot's
        previous occupant left past that width stays in place and is
        masked out of attention until a decode write overtakes it."""
        keep = np.flatnonzero(slots < self.sched.max_slots)
        if not keep.size:
            return
        n = keep.size
        meta = self._put(np.stack([slots[keep], keep, prompt_lens[keep],
                                   eos[keep], max_new[keep]]).astype(np.int64))
        sl, src, lens, eos_d, max_new_d = meta
        temps_k = temps[keep].astype(np.float32)
        full = n == len(slots)
        lg = logits0 if full else logits0[src]
        if (temps_k <= 0).all():
            tok0 = torch.argmax(lg, dim=-1)
        else:
            tok0 = sample_tokens(lg, self._put(temps_k), self._gen)
        pool = self._pool
        pool["buf"][sl] = 0
        pool["buf"][sl, 0] = tok0
        pool["gen"][sl] = 1
        pool["done"][sl] = (tok0 == eos_d) | (max_new_d <= 1)
        pool["tok"][sl, 0] = tok0
        for name in ("k", "v"):
            leaf, r = pool["cache"][name], rows[name]
            W = min(leaf.shape[2], r.shape[2])       # KV-axis capacities
            r = r[:, :, :W] if full else r[:, src, :W]
            leaf[:, sl, :W] = r.to(leaf.dtype)
        pool["cache_len"][sl] = lens
        pool["eos"][sl] = eos_d
        pool["max_new"][sl] = max_new_d
        pool["temps"][sl] = self._put(temps_k)
        self._temps[slots[keep]] = temps_k

    def _run_chunk(self, active: np.ndarray) -> None:
        """``chunk`` decode steps over the whole pool.  A row runs while it
        is active (occupied, not staging) and not done; rows that do not
        run keep their tokens, budget, depth and ``tok``."""
        pool, rows = self._pool, self._rows
        L = pool["buf"].shape[1]
        act = self._put(active)
        greedy = bool((self._temps[active] <= 0).all())
        for _ in range(self.sched.chunk):
            logits, _ = bb.decode_step(self.cfg, self.params, pool["tok"],
                                       pool["cache"], pool["cache_len"])
            if greedy:
                t = torch.argmax(logits, dim=-1)
            else:
                t = sample_tokens(logits, pool["temps"], self._gen)
            run = act & ~pool["done"]
            pos = pool["gen"].clamp(max=L - 1)
            pool["buf"][rows, pos] = torch.where(run, t, pool["buf"][rows, pos])
            pool["gen"] += run
            pool["done"] |= run & ((t == pool["eos"])
                                   | (pool["gen"] >= pool["max_new"]))
            pool["tok"][:, 0] = torch.where(run, t, pool["tok"][:, 0])
            # only running rows advance their depth: done/free slots keep
            # cache_len frozen (and evict resets it)
            pool["cache_len"] += run
            if self._count_live:
                self._steps_live += run.any()
        self.steps_run += self.sched.chunk

    def steps_live(self) -> int:
        """Decode steps dispatched so far in which at least one row ran,
        counted only while telemetry is enabled (reads the device: call it
        between runs, not inside one)."""
        if not self._count_live:
            raise RuntimeError("steps_live() counts only with telemetry "
                               "enabled")
        return int(self._steps_live)

    # --------------------------------------------------------------- host --

    def _span(self, name: str):
        """Wall span on the scheduler track; shared no-op when telemetry
        is disabled (no clock read, no allocation)."""
        if not self.tel.enabled:
            return _NULL
        return self.tel.span(name, track="scheduler", cat="sched",
                             round=self._round)

    def export_metrics(self) -> None:
        """Refresh the per-round gauges and the re-export of the prefix
        cache's `stats` into the registry.  Called at the end of every
        round while telemetry is enabled."""
        if not self.tel.enabled:
            return
        m = self.tel.metrics
        m.gauge("sched.pool_occupancy").set(
            sum(r is not None for r in self._slots.rids))
        m.gauge("sched.backlog").set(self.backlog())
        m.gauge("sched.staging").set(len(self._staging))
        if self.prefix is not None:
            for k, v in self.prefix.stats.items():
                m.gauge(f"prefix.{k}").set(v)
            m.gauge("prefix.hit_rate").set(self.prefix.hit_rate)
            m.gauge("prefix.hot_pages").set(self.prefix.n_hot)
            m.gauge("prefix.cold_pages").set(self.prefix.n_cold)
            m.gauge("prefix.cold_used_bytes").set(
                self.prefix.cold_used_bytes)

    def _bucket_of(self, prompt_len: int) -> int:
        fits = [b for b in self.sched.buckets
                if prompt_len <= b <= self.max_len]
        if fits:
            return min(fits)
        # a prompt above every configured bucket still buckets at page
        # granularity, so distinct long lengths share prefill shapes
        return min(round_up(prompt_len, self.sched.page_size), self.max_len)

    def submit(self, request, *, deadline_at=None) -> int:
        """deadline_at: absolute deadline on this scheduler's clock()
        timeline, overriding request.deadline_s."""
        T = len(request.tokens)
        if T < 1:
            raise ValueError("empty prompt")
        if request.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        bucket = self._bucket_of(T)
        if max(bucket, T + request.max_new_tokens) > self.max_len:
            raise ValueError(
                f"prompt {T} (+{request.max_new_tokens} new, bucket "
                f"{bucket}) exceeds scheduler max_len {self.max_len}")
        if request.extras is not None:
            raise ValueError("the continuous scheduler serves token-only "
                             "requests")
        rid = self._next_rid
        self._next_rid += 1
        if deadline_at is not None:
            self._deadlines[rid] = float(deadline_at)
        elif getattr(request, "deadline_s", None) is not None:
            if request.deadline_s <= 0:
                raise ValueError("deadline_s must be > 0")
            self._deadlines[rid] = self._clock() + request.deadline_s
        self._req_of[rid] = request
        self._queue.append((rid, request))
        return rid

    @property
    def _slot_rid(self) -> list:
        return self._slots.rids

    def backlog(self) -> int:
        """Requests admitted but not yet pooled (queued + staging)."""
        return len(self._queue) + len(self._staging)

    def has_work(self) -> bool:
        """True while anything is queued, staging, or pooled."""
        return bool(self._queue or self._staging
                    or self._slots.any_occupied())

    def pop_completion(self, rid: int):
        """Remove and return one finished request's Completion."""
        return self._results.pop(rid)

    # ------------------------------------------------ suspend / resume --

    def suspend(self, rid: int) -> Optional[Suspended]:
        """Evict a pooled request mid-decode, preserving its progress.

        Returns None when the row has in fact already finished (its
        Completion drains normally next round).  Reading the pool waits
        for the in-flight chunk, so the suspension captures every token
        decoded so far; a pending overlap snapshot then skips the released
        slot, as it does for any slot freed and re-admitted between a
        dispatch and its drain.  Pinned prefix pages are parked (refs
        held) so a prompt resume can still seed them; they are released
        when the resumed admission re-pins, or when the suspension is
        discarded."""
        slot = next((i for i, r in enumerate(self._slot_rid) if r == rid),
                    None)
        if slot is None or slot in self._staging_slots():
            raise ValueError(f"rid {rid} is not pooled (queued/staging rows "
                             "cannot suspend)")
        host = self._landed(self._fetch())
        if host["done"][slot]:
            return None
        toks = host["buf"][slot, :host["gen"][slot]].astype(np.int32)
        prefix = self._resume.pop(rid, None)
        if prefix is not None:
            toks = np.concatenate([prefix, toks])
        n_pre = 0 if prefix is None else len(prefix)
        sub = self._req_of.pop(rid)
        # undo a previous resume's prompt extension: the Suspended record
        # always carries the *original* request plus all tokens so far
        orig = dataclasses.replace(
            sub,
            tokens=np.asarray(sub.tokens, np.int32)[:len(sub.tokens) - n_pre],
            max_new_tokens=sub.max_new_tokens + n_pre, deadline_s=None)
        parked = None
        if self.prefix is not None:
            parked = self.prefix.park(slot, ("suspend", rid))
        self._unpark(rid)                      # resumed-but-never-admitted
        self._slots.release(slot, rid)
        self._pool["cache_len"][slot] = 0
        deadline_at = self._deadlines.pop(rid, None)
        if self.tel.enabled:
            self.tel.counter("sched.evicted", reason="preempted").inc()
        return Suspended(orig, toks, deadline_at, parked)

    def submit_suspended(self, sus: Suspended, *, deadline_at=None) -> int:
        """Re-admit a suspended request through the ordinary prefill
        path: prompt + generated-so-far tokens prefill as one longer
        prompt, the next token samples from the resumed prefill's logits,
        and streams/Completion carry the full token sequence.  Greedy rows
        give an uninterrupted run's tokens.  Returns the new rid."""
        req = sus.request
        gen = np.asarray(sus.generated, np.int32)
        remaining = req.max_new_tokens - len(gen)
        if remaining < 1:
            raise ValueError("suspended request has exhausted its token "
                             "budget")
        cont = dataclasses.replace(
            req, tokens=np.concatenate([np.asarray(req.tokens, np.int32),
                                        gen]),
            max_new_tokens=remaining, deadline_s=None)
        if deadline_at is None:
            deadline_at = sus.deadline_at
        rid = self.submit(cont, deadline_at=deadline_at)
        if len(gen):
            self._resume[rid] = gen
        if sus.parked is not None:
            self._parked_tok[rid] = sus.parked
        if self.tel.enabled:
            self.tel.counter("sched.resumed").inc()
        return rid

    def discard_suspended(self, sus: Suspended) -> None:
        """Drop a suspension that will never resume (its frontend shed it):
        release the parked prefix pins.  The generated tokens live in the
        Suspended record; the caller resolves the request with them."""
        if self.prefix is not None and sus.parked is not None:
            self.prefix.unpark(sus.parked)

    def _unpark(self, rid: int) -> None:
        """Drop the parked pins a resumed rid carried, once its new
        admission has pinned (or once it resolves without admitting)."""
        tok = self._parked_tok.pop(rid, None)
        if tok is not None and self.prefix is not None:
            self.prefix.unpark(tok)

    def _free_slots(self) -> list[int]:
        return self._slots.free()

    def _staging_slots(self) -> set:
        return {st["slot"] for st in self._staging}

    def _copy_width(self, bucket: int) -> int:
        """Token width of the cache rows an admission copies into the
        pool: the bucket rounded up to whole pages (never the full pool
        width)."""
        return min(self._kv_len, round_up(bucket, self.sched.page_size))

    def _is_long(self, req) -> bool:
        seg = self.sched.prefill_segment
        return bool(seg) and self._bucket_of(len(req.tokens)) > seg

    def _has_hit(self, req) -> bool:
        """True when the request's leading pages are resident: it admits
        through a prefix wave when it leads, so group formation skips it
        (a group row would prefill the prefix again)."""
        return (self.prefix is not None
                and self.prefix.lookup(req.tokens)[1] > 0)

    def _plan_one(self):
        """Form one admission decision from the queue head: a bucket
        group (returned as a dict of numpy prefill inputs, its slots
        acquired), a staging claim (returns True), or None when nothing
        can admit.  Pure host work.

        Groups are formed in FIFO order keyed by the head request's
        bucket, so the queue head is always in the next group — no
        request can be starved by a stream of other-bucket arrivals.  A
        long head (bucket > prefill_segment) claims a slot and stages
        instead; while a staging is already in flight the first short
        group behind it keeps the pool fed.

        With the prefix cache on, a short lead whose leading pages are
        resident leads a *prefix wave* (seed the pages, prefill only the
        suffixes) batched with queued requests sharing its bucket and hit
        depth, and ordinary groups are formed from hit-free requests only;
        a hit-carrying request that cannot join waits to lead, which FIFO
        bounds as it bounds buckets."""
        free = self._free_slots()
        if not free or not self._queue:
            return None
        head_rid, head_req = self._queue[0]
        if self._is_long(head_req):
            if not self._staging:
                self._queue.popleft()
                self._start_staging(head_rid, head_req, free[0])
                return True
            shorts = [(r, q) for r, q in self._queue
                      if not self._is_long(q)]
            if not shorts:
                return None
            lead_req = shorts[0][1]
        else:
            lead_req = head_req
        if self.prefix is not None:
            n_hit = self.prefix.lookup(lead_req.tokens)[1]
            if n_hit:
                return self._plan_prefix_group(lead_req, free, n_hit)
        head_bucket = self._bucket_of(len(lead_req.tokens))

        G = self.sched.prefill_group
        take, keep = [], deque()
        for rid, req in self._queue:
            if (len(take) < min(len(free), G) and not self._is_long(req)
                    and self._bucket_of(len(req.tokens)) == head_bucket
                    and not self._has_hit(req)):
                take.append((rid, req))
            else:
                keep.append((rid, req))
        if not take:
            return None
        self._queue = keep
        for (rid, _), slot in zip(take, free):
            self._slots.acquire(slot, rid)
        reqs = [req for _, req in take]
        g = self._group_rows(reqs, free, head_bucket)
        g.update(bucket=head_bucket, rids=[rid for rid, _ in take], pkeys=[])
        if self.prefix is not None:
            g["pkeys"] = [self.prefix.lookup(r.tokens)[0] for r in reqs]
        return g

    def _group_rows(self, reqs, slots, width: int) -> dict:
        """The prefill_group-row host arrays of one admission: prompts
        right-padded to ``width``, and each row's length, slot, EOS id,
        budget and temperature; padding rows hold 1 valid token and slot
        max_slots (left out at inject)."""
        G = self.sched.prefill_group
        g = {"tokens": np.zeros((G, width), np.int64),
             "lengths": np.ones((G,), np.int64),
             "slots": np.full((G,), self.sched.max_slots, np.int64),
             "eos": np.full((G,), -1, np.int64),
             "max_new": np.ones((G,), np.int64),
             "temps": np.zeros((G,), np.float32)}
        for i, (req, slot) in enumerate(zip(reqs, slots)):
            T = len(req.tokens)
            g["tokens"][i, :T] = np.asarray(req.tokens, np.int64)
            g["lengths"][i] = T
            g["slots"][i] = slot
            g["eos"][i] = req.eos_id
            g["max_new"][i] = req.max_new_tokens
            g["temps"][i] = req.temperature
        return g

    def _plan_prefix_group(self, lead_req, free: list[int],
                           n_hit: int) -> dict:
        """Form one batched prefix-hit admission: up to prefill_group short
        requests sharing the lead's bucket AND resident-page depth (their
        seeded widths, and so the suffix segments, match; the pages
        themselves may differ per row).  One suffix pass and one inject
        serve the whole wave."""
        bucket = self._bucket_of(len(lead_req.tokens))
        G = self.sched.prefill_group
        take, keep = [], deque()
        for rid, req in self._queue:
            if (len(take) < min(len(free), G) and not self._is_long(req)
                    and self._bucket_of(len(req.tokens)) == bucket):
                keys, h = self.prefix.lookup(req.tokens)
                if h == n_hit:
                    take.append((rid, req, keys))
                    continue
            keep.append((rid, req))
        if not take:
            raise RuntimeError("the hit lead must join its own prefix wave")
        self._queue = keep
        for (rid, _, _), slot in zip(take, free):
            self._slots.acquire(slot, rid)
        return {"prefix": True, "take": take, "slots": free[:len(take)],
                "bucket": bucket, "n_hit": n_hit}

    def _admit(self) -> None:
        """Plan and launch every admission the queue and free slots allow.
        Each plan launches as it forms: a group's pin() lands its pages in
        the prefix index before the next plan's lookup runs, so same-round
        arrivals sharing a prefix hit on the very first wave."""
        while True:
            g = self._plan_one()
            if g is None:
                return
            if g is True:
                continue
            if g.get("prefix"):
                self._launch_prefix(g)
            else:
                self._launch_group(g)

    def _launch_group(self, g: dict) -> None:
        """Enqueue one prepared group: per-bucket prefill + inject.  The
        host returns as soon as the work is queued.  With the prefix cache
        on, every row's shareable pages are copied from the prefill rows
        into the index and pinned for the slot's lifetime."""
        logits0, rows, _ = bb.prefill(
            self.cfg, self.params, {"tokens": self._put(g["tokens"])},
            max_len=self._copy_width(g["bucket"]),
            lengths=self._put(g["lengths"]))
        if self.tel.enabled:
            self.tel.counter("sched.admitted", path="group").inc(
                int((g["slots"] < self.sched.max_slots).sum()))
        if self.prefix is not None:
            for i, (keys, slot) in enumerate(zip(g["pkeys"], g["slots"])):
                self.prefix.record(len(keys), 0)
                if keys:
                    self.prefix.pin(int(slot), keys, rows["k"][:, i],
                                    rows["v"][:, i])
        for rid in g["rids"]:          # after pin: parked pages stay hot
            self._unpark(rid)          # until the new pins hold them
        self._inject(g["slots"], rows, logits0, g["lengths"], g["eos"],
                     g["max_new"], g["temps"])

    def _launch_prefix(self, g: dict) -> None:
        """Admit a wave of prefix-hit requests in one batch: seed each
        row's resident pages into a fresh prefill_group-row cache (the
        copy-on-write copies, hoisted to admission), then prefill just the
        suffixes in page-wide segments attending at the bucket width.
        ``prefill_chunk`` gathers logits per row, so rows whose prompts end
        in different segments each keep the logits of the segment holding
        their final token; a short row's later segments only write pad
        keys above its prompt, as a full-width group prefill leaves there.
        One inject lands the whole wave."""
        take, H = g["take"], g["n_hit"]
        page = self.sched.page_size
        Wc = self._copy_width(g["bucket"])
        seeded = H * page
        cache = bb.init_cache(self.cfg, self.sched.prefill_group, Wc,
                              device=self.device)
        for i, (_, _, keys) in enumerate(take):
            kv = self.prefix.fetch(keys[:H])
            cache["k"][:, i, :seeded] = kv["k"].to(cache["k"].dtype)
            cache["v"][:, i, :seeded] = kv["v"].to(cache["v"].dtype)
        rows = self._group_rows([req for _, req, _ in take], g["slots"], Wc)
        toks, lengths = rows["tokens"], rows["lengths"]
        logits0 = None
        for d in range(seeded, Wc, page):     # seeded <= T-1 on hit rows
            last = np.clip(lengths - 1 - d, 0, page - 1)
            lg, _ = bb.prefill_chunk(
                self.cfg, self.params, self._put(toks[:, d:d + page]), cache,
                d, attend_width=g["bucket"], last_index=self._put(last))
            ends_here = (d <= lengths - 1) & (lengths - 1 < d + page)
            logits0 = lg if logits0 is None else torch.where(
                self._put(ends_here)[:, None], lg, logits0)
            if d + page >= int(lengths.max()):
                break
        if self.tel.enabled:
            self.tel.counter("sched.admitted", path="prefix").inc(len(take))
        for i, ((rid, _, keys), slot) in enumerate(zip(take, g["slots"])):
            self.prefix.record(len(keys), H)
            self.prefix.pin(int(slot), keys, cache["k"][:, i],
                            cache["v"][:, i])
            self._unpark(rid)          # resumed rows: new pins now hold
        self._inject(rows["slots"], cache, logits0, lengths, rows["eos"],
                     rows["max_new"], rows["temps"])

    # ------------------------------------------------- chunked prefill --

    def _start_staging(self, rid: int, req, slot: int) -> None:
        """Claim a slot for a long admission; its prompt prefills one
        `prefill_segment`-token slice per scheduling round into a B = 1
        cache of whole segments covering the bucket, so every segment's
        K/V write lands inside it.  Resident prefix pages seed the staged
        cache in whole segments (staging advances a segment at a time, so
        a partial segment cannot be skipped) and `depth` starts past
        them."""
        seg = self.sched.prefill_segment
        page = self.sched.page_size
        bucket = self._bucket_of(len(req.tokens))
        T = len(req.tokens)
        n_segs = round_up(bucket, seg) // seg
        toks = np.zeros((1, n_segs * seg), np.int64)
        toks[0, :T] = np.asarray(req.tokens, np.int64)
        cache = bb.init_cache(self.cfg, 1, n_segs * seg, device=self.device)
        depth, keys = 0, []
        if self.prefix is not None:
            keys, n_hit = self.prefix.lookup(req.tokens)
            depth = (n_hit * page // seg) * seg    # whole segments only
            self.prefix.record(len(keys), depth // page)
            if depth:
                kv = self.prefix.fetch(keys[:-(-depth // page)])
                cache["k"][:, 0, :depth] = kv["k"][:, :depth].to(
                    cache["k"].dtype)
                cache["v"][:, 0, :depth] = kv["v"][:, :depth].to(
                    cache["v"].dtype)
        self._slots.acquire(slot, rid)
        self._staging.append({
            "rid": rid, "req": req, "slot": slot, "depth": depth, "T": T,
            "bucket": bucket, "tokens": toks, "logits0": None, "keys": keys,
            "cache": cache,
        })

    def _advance_staging(self) -> None:
        """Run one prefill segment for the staged admission (if any).
        Attention spans the bucket width at every segment, as a one-shot
        bucketed prefill's does; segments stop once the prompt tail has
        landed."""
        if not self._staging:
            return
        st = self._staging[0]
        seg = self.sched.prefill_segment
        d = st["depth"]
        last = min(max(st["T"] - 1 - d, 0), seg - 1)
        logits, _ = bb.prefill_chunk(
            self.cfg, self.params, self._put(st["tokens"][:, d:d + seg]),
            st["cache"], d, attend_width=st["bucket"], last_index=last)
        if d <= st["T"] - 1 < d + seg:
            st["logits0"] = logits          # segment holding the last token
        st["depth"] = d + seg
        if st["depth"] >= st["T"]:
            self._staging.remove(st)
            self._finish_staging(st)

    def _finish_staging(self, st: dict) -> None:
        """The staged cache joins the pool through the same page-granular
        inject as one-shot admissions (first token sampled there)."""
        req = st["req"]
        if self.tel.enabled:
            self.tel.counter("sched.admitted", path="staged").inc()
        if self.prefix is not None and st["keys"]:
            self.prefix.pin(st["slot"], st["keys"], st["cache"]["k"][:, 0],
                            st["cache"]["v"][:, 0])
        self._unpark(st["rid"])        # resumed rows: new pins now hold
        self._inject(np.asarray([st["slot"]]), st["cache"], st["logits0"],
                     np.asarray([st["T"]]), np.asarray([req.eos_id]),
                     np.asarray([req.max_new_tokens]),
                     np.asarray([req.temperature], np.float32))

    # ----------------------------------------------------------- loop --

    def _active_mask(self) -> np.ndarray:
        stag = self._staging_slots()
        return np.asarray([r is not None and i not in stag
                           for i, r in enumerate(self._slot_rid)])

    def _complete(self, fin: list[int], buf, gen, *,
                  timed_out: bool = False) -> list[int]:
        """Release finished slots and record their Completions; freed
        slots drop to depth 0."""
        from repro_torch.serve.engine import Completion
        if self.tel.enabled and fin:
            self.tel.counter(
                "sched.evicted",
                reason="deadline" if timed_out else "finished").inc(len(fin))
        out = []
        for i in fin:
            rid = self._slots.release(i)
            if self.prefix is not None:
                self.prefix.release(i)     # unpin the slot's prefix pages
            self._deadlines.pop(rid, None)
            self._req_of.pop(rid, None)
            self._unpark(rid)
            toks = buf[i, :gen[i]].astype(np.int32)
            prefix = self._resume.pop(rid, None)
            if prefix is not None:         # resumed rows report the full
                toks = np.concatenate([prefix, toks])      # token stream
            self._results[rid] = Completion(toks, len(toks),
                                            timed_out=timed_out)
            out.append(rid)
        if fin:
            self._pool["cache_len"][self._put(np.asarray(fin, np.int64))] = 0
        return out

    # ------------------------------------------------------ deadlines --

    def _expire_deadlines(self) -> list[int]:
        """Deadline-evict, between chunks, every request whose deadline
        has lapsed: queued requests resolve empty, a staging admission
        aborts its prefill and frees its slot, pooled slots evict with
        the tokens generated so far.  Under a stalled pool this is the
        exit that keeps `run()` from hanging."""
        if not self._deadlines:
            return []
        from repro_torch.serve.engine import Completion
        now = self._clock()
        expired = {rid for rid, at in self._deadlines.items() if at <= now}
        if not expired:
            return []
        out = []
        # queued, never admitted: nothing was generated in time (a resumed
        # request keeps the tokens it generated before its suspension)
        keep = deque()
        for rid, req in self._queue:
            if rid in expired:
                pre = self._resume.pop(rid, None)
                toks = pre if pre is not None else np.zeros((0,), np.int32)
                self._results[rid] = Completion(toks, len(toks),
                                                timed_out=True)
                self._deadlines.pop(rid)
                self._req_of.pop(rid, None)
                self._unpark(rid)
                out.append(rid)
            else:
                keep.append((rid, req))
        self._queue = keep
        # staging: abort the chunked prefill, free its claimed slot
        for st in [s for s in self._staging if s["rid"] in expired]:
            self._staging.remove(st)
            self._slots.release(st["slot"], st["rid"])
            self._deadlines.pop(st["rid"])
            self._req_of.pop(st["rid"], None)
            self._unpark(st["rid"])
            pre = self._resume.pop(st["rid"], None)
            toks = pre if pre is not None else np.zeros((0,), np.int32)
            self._results[st["rid"]] = Completion(toks, len(toks),
                                                  timed_out=True)
            out.append(st["rid"])
        # pooled: evict with partial tokens
        fin = [i for i, rid in enumerate(self._slot_rid) if rid in expired]
        if fin:
            host = self._landed(self._fetch(("buf", "gen")))
            out.extend(self._complete(fin, host["buf"], host["gen"],
                                      timed_out=True))
        return out

    def _drain(self) -> list[int]:
        """Evict finished slots after a serialized round."""
        host = self._landed(self._fetch())
        done = host["done"]
        stag = self._staging_slots()
        fin = [i for i, rid in enumerate(self._slot_rid)
               if rid is not None and done[i] and i not in stag]
        if self.stream_cb is not None:
            live = [i for i, rid in enumerate(self._slot_rid)
                    if rid is not None and i not in stag and not done[i]]
            self._stream_rows(live, host["buf"], host["gen"], self._slot_rid)
        if not fin:
            return []
        return self._complete(fin, host["buf"], host["gen"])

    def _stream_rows(self, rows: list[int], buf, gen, rids) -> None:
        """Publish tokens-so-far for still-running slots (the finishers'
        full buffers travel in their Completions instead)."""
        for i in rows:
            toks = buf[i, :gen[i]]
            pre = self._resume.get(rids[i])
            if pre is not None:            # resumed rows stream the full
                toks = np.concatenate([pre, toks])         # token stream
            self.stream_cb(rids[i], toks)

    def _snapshot_chunk(self, rids: list, active: np.ndarray) -> None:
        """Capture the just-enqueued chunk's observable state: copies of
        done / buf / gen start now, queued behind the chunk and ahead of
        anything that writes the pool next; the host waits for them only
        next round, after the following round's work is queued."""
        self._pending = {"fetch": self._fetch(), "rids": rids,
                         "active": active}

    def _drain_pending(self) -> list[int]:
        """Evict the finishers of the *previous* round's chunk.  Only
        slots that were active in that chunk AND still hold the same
        occupant are eligible: a slot freed and re-admitted in between
        carries a fresher request whose done flag this snapshot cannot
        know, and a then-staging slot's done flag is the previous
        occupant's leftover."""
        p, self._pending = self._pending, None
        if p is None:
            return []
        host = self._landed(p["fetch"])
        done = host["done"]
        eligible = [i for i, rid in enumerate(self._slot_rid)
                    if rid is not None and p["active"][i]
                    and p["rids"][i] == rid]
        fin = [i for i in eligible if done[i]]
        if self.stream_cb is not None:
            self._stream_rows([i for i in eligible if not done[i]],
                              host["buf"], host["gen"], p["rids"])
        if not fin:
            return []
        return self._complete(fin, host["buf"], host["gen"])

    def _dispatch_chunk(self) -> Optional[np.ndarray]:
        """Enqueue one decode chunk over the occupied non-staging slots;
        returns the active mask used (None when nothing is decodable, or
        when a fault has this round's executor stalled — deadlines keep
        aging either way)."""
        if self.faults is not None and \
                self.faults.chunk_stalled(self._round - 1):
            return None
        active = self._active_mask()
        if not active.any():
            return None
        self._run_chunk(active)
        return active

    def step(self) -> list[int]:
        """One scheduling round.  Serialized mode: advance the staged
        prefill a segment, admit groups while slots are free, decode one
        chunk, wait on the drain.  Overlap mode pipelines the same round
        against the device (see `_step_overlapped`).  Returns completed
        request ids.  Expired deadlines evict first, so a
        deadline-carrying request never costs another prefill segment or
        decode chunk past its budget."""
        self._round += 1                # 0-based round index while inside:
                                        # _dispatch_chunk sees _round - 1
        if self.faults is not None and self.faults.crashed(self._round - 1):
            from repro_torch.serve.faults import EngineCrashError
            raise EngineCrashError(
                f"scripted engine crash at round {self._round - 1}")
        with self._span("round"):
            expired = self._expire_deadlines()
            if self.sched.overlap:
                out = expired + self._step_overlapped()
            else:
                with self._span("prefill_segment"):
                    self._advance_staging()
                with self._span("admit"):
                    self._admit()
                with self._span("decode_chunk"):
                    dispatched = self._dispatch_chunk()
                if dispatched is None:
                    out = expired
                else:
                    with self._span("evict"):
                        out = expired + self._drain()
        self.export_metrics()
        return out

    def _step_overlapped(self) -> list[int]:
        """One pipelined round: round k's prefill segment and injects are
        enqueued, and its admissions bucketed, while round k-1's chunk is
        still in flight; the host's one wait (round k-1's done flags,
        copied since dispatch) sits behind them.  Chunk k-1's finishers
        free their slots before chunk k is enqueued, a second admission
        pass fills them, and completions report one round late."""
        with self._span("prefill_segment"):
            self._advance_staging()
        with self._span("admit"):
            self._admit()
        with self._span("evict"):
            out = self._drain_pending()
        with self._span("admit"):
            self._admit()
        rids = list(self._slot_rid)            # occupancy at dispatch time
        with self._span("decode_chunk"):
            active = self._dispatch_chunk()
        if active is not None:
            self._snapshot_chunk(rids, active)
        return out

    def run(self) -> dict:
        """Drain queue and pool; returns (and forgets) {rid: Completion}."""
        while self._queue or self._staging or self._slots.any_occupied():
            self.step()
        out, self._results = self._results, {}
        return out
