"""Overload-robust async streaming frontend over the continuous scheduler.

The port of ``repro.serve.frontend``: the same admission control, events,
preemption, recovery hooks and closed-loop simulator over the port's
``ContinuousScheduler`` (on CUDA unless ``device="cpu"`` is named).  On
one clock and one schedule its events, rejections and ``SimReport`` rows
are the JAX package's exactly.

The engine's `generate` is drain-style: callers hand over a closed batch
and block for every token.  Production traffic is an open stream, and an
open stream's failure mode is overload — `ContinuousScheduler.submit`
accepts unbounded work, so a client stampede means unbounded queue
growth and blown deadlines.  This module makes overload a first-class,
*bounded* state:

  * **Per-request streaming** — typed per-token events (`FirstToken`,
    `Delta`, `Finish`) published as each decode chunk lands, through the
    scheduler's own overlap loop (`ContinuousScheduler.stream_cb`:
    overlap rounds stream from the drained chunk's snapshot, serialized
    rounds from the pool).  Consumed synchronously via `step()`/`run()`
    or as async iterators via `stream()` + `serve_forever()`.
  * **Admission control** — a bounded admission queue with priority
    classes (``INTERACTIVE > BATCH > BEST_EFFORT``), per-class default
    deadlines, and earliest-deadline-first order within a class (FIFO on
    ties, like the gateway's event heap).  Admission beyond
    ``max_queue``, or past the estimated-queueing-delay SLO budget,
    raises a typed `Overloaded` carrying a retry-after hint — the
    *rejected* rung of the PR-6 degradation ladder, one step above
    *shed* (rejected work never cost a prefill; shed work at least
    arrived).
  * **Backpressure** — the frontend feeds the scheduler only as fast as
    the decode slot pool drains (`feed_depth` meters the scheduler's
    backlog), so saturation surfaces at admission instead of deep in
    the pool; ``stream(..., wait=True)`` turns the rejection into an
    awaited slow-down.  A circuit breaker opens at a high-water queue
    depth, sheds BEST_EFFORT traffic first, and recovers
    *hysteretically* — it only re-admits once depth falls below the
    low-water mark, so a saturated pool cannot flap between accept and
    reject.
  * **Priority preemption** — with ``SchedulerConfig.preempt``, an
    INTERACTIVE request that has waited past ``preempt_wait_ms`` with
    the pool full *suspends* the lowest-priority, latest-deadline
    pooled row mid-decode (`ContinuousScheduler.suspend`): the victim
    re-enters its class queue with its partial tokens preserved and
    resumes with the same greedy tokens when the pool drains — the
    suspended → resumed lifecycle, one rung gentler than *shed*.
  * **Request journal** — an attached `recovery.RequestJournal` records
    submit/admit/token-chunk/preempt/finish write-ahead on the shared
    clock timeline; after an `EngineCrash`, `recovery.recover` replays
    the journal into a fresh frontend (`restore`) and regenerates every
    in-flight request's tokens, with exactly-once `Finish` delivery.
  * **One clock** — the frontend, the scheduler's deadline evictions and
    the closed-loop simulator all read the same injectable clock
    (`VirtualClock` / `repro_torch.serve.event_loop.EventLoop.now`), the
    same discipline the offload gateway's discrete-event heap uses — so the
    overload simulations are deterministic, like the gateway's.

Pass-through contract (tested): with overload features disabled — no
``max_queue``, no SLO, no class deadlines, one priority class — every
request is fed to the scheduler in submission order and greedy tokens are
those of calling `ContinuousScheduler.submit` + `run()` directly.
Attaching a stream callback never changes tokens (it only reads), and a
run with no subscriber does no extra device->host copies.
"""
from __future__ import annotations

import asyncio
import dataclasses
import enum
import heapq
import itertools
import math
import time
from typing import Optional

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.serve import telemetry as _telemetry
from repro_torch.serve.scheduler import (
    ContinuousScheduler,
    SchedulerConfig,
    Suspended,
)

# the full degradation ladder, most to least service delivered; the
# frontend itself resolves requests as served / shed / rejected, the
# offload gateway adds degraded / fallback (repro_torch.serve.gateway)
LADDER = ("served", "degraded", "shed", "rejected", "fallback")

DEFAULT_RETRY_S = 0.05      # retry-after hint before any throughput
                            # estimate exists (nothing has completed yet)


class Priority(enum.IntEnum):
    """Admission priority classes, most to least important.  Lower value
    admits first; the circuit breaker sheds from the bottom up."""
    INTERACTIVE = 0
    BATCH = 1
    BEST_EFFORT = 2

    @classmethod
    def parse(cls, name: str) -> "Priority":
        key = name.strip().upper().replace("-", "_")
        try:
            return cls[key]
        except KeyError:
            raise ValueError(
                f"unknown priority {name!r} (expected one of "
                f"{[p.name.lower().replace('_', '-') for p in cls]})")


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Admission-control knobs.  The defaults disable every overload
    feature (unbounded queue, no SLO, no class deadlines): the frontend
    is then a pure streaming pass-through over the scheduler."""
    max_queue: Optional[int] = None   # bound on admitted-but-unscheduled
                                      # requests (frontend + scheduler
                                      # backlog); None = unbounded
    slo_ms: Optional[float] = None    # queueing-delay budget: reject when
                                      # the estimated wait exceeds it
    class_deadline_ms: tuple = (None, None, None)
                                      # per-Priority default deadline
                                      # applied when a request carries
                                      # none (INTERACTIVE, BATCH,
                                      # BEST_EFFORT); None = no deadline
    breaker_high: float = 0.75        # breaker opens at this fraction of
                                      # max_queue ...
    breaker_low: float = 0.25         # ... and only closes again below
                                      # this one (hysteresis)
    feed_depth: Optional[int] = None  # scheduler backlog the feeder
                                      # maintains; None = max_slots +
                                      # prefill_group (keep the pool fed,
                                      # keep ordering at the frontend)
    ewma: float = 0.3                 # service-rate estimator smoothing
    preempt_wait_ms: float = 0.0      # INTERACTIVE queue-wait budget:
                                      # once an interactive waiter has
                                      # aged past it with the pool full,
                                      # the lowest-priority latest-
                                      # deadline pooled row is suspended
                                      # to make room (needs
                                      # SchedulerConfig.preempt; 0 =
                                      # preempt as soon as one waits)

    def __post_init__(self):
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(f"FrontendConfig.max_queue must be >= 1 or "
                             f"None (got {self.max_queue!r})")
        if self.slo_ms is not None and not self.slo_ms > 0:
            raise ValueError(f"FrontendConfig.slo_ms must be > 0 or None "
                             f"(got {self.slo_ms!r})")
        if not 0.0 <= self.breaker_low < self.breaker_high <= 1.0:
            raise ValueError(
                f"FrontendConfig breaker watermarks need "
                f"0 <= low < high <= 1, got low={self.breaker_low} "
                f"high={self.breaker_high}")
        if len(self.class_deadline_ms) != len(Priority):
            raise ValueError("FrontendConfig.class_deadline_ms needs one "
                             f"entry per priority class "
                             f"(got {self.class_deadline_ms!r})")
        if not 0.0 < self.ewma <= 1.0:
            raise ValueError(f"FrontendConfig.ewma must be in (0, 1], "
                             f"got {self.ewma!r}")
        if self.feed_depth is not None and self.feed_depth < 1:
            raise ValueError(f"FrontendConfig.feed_depth must be >= 1 or "
                             f"None (got {self.feed_depth!r})")
        if not self.preempt_wait_ms >= 0:
            raise ValueError(f"FrontendConfig.preempt_wait_ms must be "
                             f">= 0, got {self.preempt_wait_ms!r}")


# ------------------------------------------------------- typed events --


@dataclasses.dataclass(frozen=True)
class FirstToken:
    """The request's first generated token — TTFT is ``t`` minus the
    submission instant."""
    rid: int
    token: int
    t: float


@dataclasses.dataclass(frozen=True)
class Delta:
    """One subsequent token, published as its decode chunk lands."""
    rid: int
    token: int
    t: float


@dataclasses.dataclass(frozen=True)
class Finish:
    """Terminal event: ``status`` is a `LADDER` rung ("served" or
    "shed" from the frontend) and ``tokens`` the full output (partial
    when deadline-shed mid-decode)."""
    rid: int
    status: str
    tokens: np.ndarray
    t: float


class Overloaded(RuntimeError):
    """Typed admission rejection — the *rejected* ladder rung.

    ``retry_after_s`` is the frontend's estimate of when the queue will
    have drained below its high-water mark; a well-behaved client backs
    off at least that long.  ``queue_depth`` is the depth that triggered
    the refusal, ``reason`` one of "queue full" / "slo" / "breaker".
    """

    def __init__(self, reason: str, retry_after_s: float, queue_depth: int):
        self.reason = reason
        self.retry_after_s = float(retry_after_s)
        self.queue_depth = int(queue_depth)
        super().__init__(
            f"admission rejected ({reason}): queue depth {queue_depth}, "
            f"retry after {self.retry_after_s:.3f}s")


class VirtualClock:
    """Injectable simulated clock: reads return ``now``; a simulation
    advances it.  Shared between the frontend and its scheduler, so
    deadlines, stream timestamps and admission estimates live on one
    deterministic timeline (the same posture as the gateway's
    `EventLoop.now`)."""

    def __init__(self, t0: float = 0.0):
        self.now = float(t0)

    def __call__(self) -> float:
        return self.now


# ---------------------------------------------------------- frontend --


class StreamingFrontend:
    """Admission-controlled streaming interface to one decode pool.

    `submit()` admits (or rejects, typed) a request into per-class EDF
    queues; `step()` runs one scheduler round, feeding admitted
    requests into the pool as it drains, and returns the round's stream
    events; `run()` drains everything (batch callers); `stream()` is
    the asyncio per-request iterator, driven by `serve_forever()`.
    """

    def __init__(self, cfg: ArchConfig, params, *,
                 frontend: Optional[FrontendConfig] = None,
                 sched: Optional[SchedulerConfig] = None,
                 max_len: int = 256, seed: int = 0, mesh=None,
                 clock=None, faults=None, telemetry=None, journal=None,
                 device=None):
        """journal: a `repro_torch.serve.recovery.RequestJournal` recording
        submit/admit/token-chunk/preempt/finish events on this
        frontend's clock timeline (write-ahead: every record lands
        before its effect is observable).  All journal writes reuse
        clock reads the frontend already makes, so an attached journal
        changes no token or event timestamp; None (the default) skips the
        writes entirely.  params and the scheduler's pool live on
        ``device`` (CUDA by default; raises when CUDA is absent and no
        device was named)."""
        self.fcfg = frontend or FrontendConfig()
        self.journal = journal
        self.tel = telemetry if telemetry is not None else _telemetry.default()
        self._clock = clock if clock is not None else time.monotonic
        self.sched = ContinuousScheduler(
            cfg, params, sched=sched, max_len=max_len, seed=seed,
            mesh=mesh, clock=self._clock, faults=faults,
            telemetry=self.tel, device=device)
        self.sched.stream_cb = self._on_stream
        sc = self.sched.sched
        self._feed_cap = (self.fcfg.feed_depth if self.fcfg.feed_depth
                          is not None else sc.max_slots + sc.prefill_group)
        self._classes: list[list] = [[] for _ in Priority]  # EDF heaps of
        self._seq = itertools.count()            # (deadline, seq, rid)
        self._reqs: dict[int, object] = {}       # waiting rid -> Request
                                                 # (or Suspended: preempted,
                                                 # awaiting resume)
        self._deadline: dict[int, float] = {}    # rid -> absolute deadline
        self._prio: dict[int, Priority] = {}     # rid -> admission class
        self._t_submit: dict[int, float] = {}    # rid -> admission instant
                                                 # (reuses the submit clock
                                                 # read; preemption budgets
                                                 # age against it)
        self._next_rid = 0
        self._to_sched: dict[int, int] = {}
        self._from_sched: dict[int, int] = {}
        self._published: dict[int, int] = {}     # rid -> tokens emitted
        self._subs: dict[int, object] = {}       # rid -> event callback
        self._results: dict[int, tuple] = {}     # rid -> (status, tokens)
        self.events: list = []                   # every event, in order
        self.rejections: list = []               # (t, Priority, Overloaded)
        self.breaker_open = False
        self._rate: Optional[float] = None       # served requests / s
        self._t_admit: dict[int, float] = {}     # rid -> submit instant
                                                 # (telemetry-enabled only:
                                                 # queue_wait span starts)
        self._t_last = self._clock()
        self._step_events: list = []
        self._closed = False

    # ------------------------------------------------------ admission --

    def _n_waiting(self) -> int:
        return len(self._reqs)

    def queue_depth(self) -> int:
        """Admitted-but-unscheduled work: the frontend's EDF queues plus
        the scheduler backlog the feeder has already released.  This is
        the quantity `max_queue` bounds and the breaker watches."""
        return self._n_waiting() + self.sched.backlog()

    def _n_ahead(self, priority: Priority) -> int:
        """Work that must clear the pool before a new request of this
        class can start: everything waiting at its class or better, the
        scheduler backlog, and the requests already holding slots."""
        waiting = sum(len(self._classes[p]) for p in Priority
                      if p <= priority)
        pooled = sum(r is not None for r in self.sched._slot_rid)
        return waiting + self.sched.backlog() + pooled

    def est_delay_s(self, priority: Priority) -> float:
        """Estimated queueing delay for a new request of this class,
        from the EWMA of observed service rate.  Zero until the first
        completion lands (nothing to extrapolate from — admit)."""
        if not self._rate:
            return 0.0
        return self._n_ahead(priority) / self._rate

    def _retry_after(self, depth: int) -> float:
        """Hint: time for the queue to drain below the low-water mark at
        the observed service rate (the point the breaker would close)."""
        if self.fcfg.max_queue is not None:
            excess = depth - self.fcfg.breaker_low * self.fcfg.max_queue
        else:
            excess = depth
        excess = max(excess, 1.0)
        if self._rate:
            return excess / self._rate
        if self.fcfg.slo_ms is not None:
            return self.fcfg.slo_ms * 1e-3
        return DEFAULT_RETRY_S

    def _update_breaker(self) -> None:
        if self.fcfg.max_queue is None:
            return
        was = self.breaker_open
        depth = self.queue_depth()
        if depth >= self.fcfg.breaker_high * self.fcfg.max_queue:
            self.breaker_open = True
        elif depth <= self.fcfg.breaker_low * self.fcfg.max_queue:
            self.breaker_open = False
        if self.tel.enabled and was != self.breaker_open:
            self.tel.counter(
                "frontend.breaker_transitions",
                to="open" if self.breaker_open else "closed").inc()

    def _reject(self, reason: str, priority: Priority, depth: int):
        err = Overloaded(reason, self._retry_after(depth), depth)
        self.rejections.append((self._clock(), priority, err))
        if self.tel.enabled:
            self.tel.counter("frontend.admission", verdict="rejected",
                             reason=reason.replace(" ", "_"),
                             priority=priority.name).inc()
        raise err

    def submit(self, request, priority: Priority = Priority.INTERACTIVE,
               ) -> int:
        """Admit one request; returns its stream id.  Raises `Overloaded`
        (typed, with a retry-after hint) when the queue is at its bound,
        the estimated queueing delay exceeds the SLO budget, or the
        circuit breaker is open and the request is BEST_EFFORT."""
        priority = Priority(priority)
        self._update_breaker()
        depth = self.queue_depth()
        if self.breaker_open and priority == Priority.BEST_EFFORT:
            self._reject("breaker", priority, depth)
        if self.fcfg.max_queue is not None and depth >= self.fcfg.max_queue:
            self._reject("queue full", priority, depth)
        if self.fcfg.slo_ms is not None:
            est = self.est_delay_s(priority)
            if est > self.fcfg.slo_ms * 1e-3:
                self._reject("slo", priority, depth)
        now = self._clock()
        rid = self._next_rid
        self._next_rid += 1
        dl_s = request.deadline_s
        if dl_s is None:
            dl_ms = self.fcfg.class_deadline_ms[priority]
            dl_s = None if dl_ms is None else dl_ms * 1e-3
        deadline = math.inf if dl_s is None else now + dl_s
        self._reqs[rid] = request
        self._deadline[rid] = deadline
        self._prio[rid] = priority
        self._t_submit[rid] = now
        if self.journal is not None:
            self._journal_submit(rid, request, priority, deadline, now)
        if self.tel.enabled:
            self.tel.counter("frontend.admission", verdict="admitted",
                             priority=priority.name).inc()
            self._t_admit[rid] = now     # queue_wait span start (reuses
                                         # the admission clock read)
        heapq.heappush(self._classes[priority],
                       (deadline, next(self._seq), rid))
        if self.fcfg.max_queue is None:
            self._feed()          # pass-through: the scheduler sees the
        return rid                # exact submission order, unmetered

    # -------------------------------------------------------- feeding --

    def _journal_submit(self, rid: int, request, priority: Priority,
                        deadline: float, now: float) -> None:
        """Write-ahead record of everything recovery needs to re-create
        this admission: the prompt, budget, sampling knobs, class, and
        absolute deadline (on the shared clock timeline)."""
        self.journal.append(
            "submit", rid, now,
            prompt=np.asarray(request.tokens, np.int64).tolist(),
            max_new=int(request.max_new_tokens),
            eos=int(request.eos_id), temp=float(request.temperature),
            prio=priority.name,
            deadline=None if deadline == math.inf else float(deadline))

    def _feed(self) -> None:
        """Release admitted requests into the scheduler, best class
        first and EDF within it, while the scheduler backlog is below
        the feed depth (unmetered when no queue bound is set).  Requests
        whose deadline already lapsed while waiting resolve as *shed*
        without ever costing a prefill — a suspended one resolves with
        the tokens it generated before preemption."""
        while True:
            if (self.fcfg.max_queue is not None
                    and self.sched.backlog() >= self._feed_cap):
                return
            item = None
            for p in Priority:
                if self._classes[p]:
                    item = heapq.heappop(self._classes[p])
                    break
            if item is None:
                return
            deadline, _, rid = item
            req = self._reqs.pop(rid)
            now = self._clock()          # one read per item, as before
            if deadline <= now:
                self._shed_waiting(rid, req)
                continue
            if self.tel.enabled and rid in self._t_admit:
                self.tel.trace.add("queue_wait", self._t_admit.pop(rid),
                                   now, track=f"req {rid}", cat="frontend")
            deadline_at = None if deadline == math.inf else deadline
            if isinstance(req, Suspended):
                srid = self.sched.submit_suspended(req,
                                                   deadline_at=deadline_at)
            else:
                srid = self.sched.submit(req, deadline_at=deadline_at)
            self._to_sched[rid] = srid
            self._from_sched[srid] = rid
            if self.journal is not None:
                self.journal.append("admit", rid, now)

    def _shed_waiting(self, rid: int, req) -> None:
        """Resolve a waiting request as shed; a suspended one keeps its
        pre-preemption tokens (preemption never silently drops work) and
        releases its parked prefix pins."""
        if isinstance(req, Suspended):
            self.sched.discard_suspended(req)
            self._finish_local(rid, "shed",
                               toks=np.asarray(req.generated, np.int32))
        else:
            self._finish_local(rid, "shed")

    def _expire_waiting(self) -> None:
        """Shed waiting requests whose deadline lapsed in the queue (the
        EDF heap keeps them at the front of their class)."""
        now = self._clock()
        for p in Priority:
            h = self._classes[p]
            while h and h[0][0] <= now:
                _, _, rid = heapq.heappop(h)
                self._shed_waiting(rid, self._reqs.pop(rid))

    # ----------------------------------------------------- preemption --

    def _maybe_preempt(self) -> None:
        """Make room for aged INTERACTIVE waiters by suspending pooled
        lower-class rows (`SchedulerConfig.preempt` gates this; off by
        default, so the pass-through contract is untouched).  The victim
        is the lowest-priority, latest-deadline pooled row; it re-enters
        its own class queue as a `Suspended` — bypassing admission
        control, so a preempted request can never be rejected or
        silently dropped — and resumes with the same greedy tokens when
        the pool drains.  Waiters only become visible here while they sit in the
        frontend's class queues, i.e. under a bounded `max_queue` with a
        feeder metering the scheduler backlog."""
        if not self.sched.sched.preempt:
            return
        h = self._classes[Priority.INTERACTIVE]
        if not h or self.sched._free_slots():
            return
        now = self._clock()
        budget = self.fcfg.preempt_wait_ms * 1e-3
        waiters = sum(1 for _, _, rid in h
                      if now - self._t_submit.get(rid, now) >= budget)
        if not waiters:
            return
        stag = self.sched._staging_slots()
        cands = []
        for slot, srid in enumerate(self.sched._slot_rid):
            if srid is None or slot in stag:
                continue
            rid = self._from_sched.get(srid)
            if rid is None:
                continue
            prio = self._prio.get(rid, Priority.INTERACTIVE)
            if prio > Priority.INTERACTIVE:
                cands.append((int(prio),
                              self._deadline.get(rid, math.inf), rid, srid))
        cands.sort(reverse=True)         # worst class, latest deadline
        for _, _, rid, srid in cands[:waiters]:
            sus = self.sched.suspend(srid)
            if sus is None:
                continue                 # already finished: drains normally
            del self._from_sched[srid]
            del self._to_sched[rid]
            prio = self._prio[rid]
            self._reqs[rid] = sus
            heapq.heappush(self._classes[prio],
                           (self._deadline.get(rid, math.inf),
                            next(self._seq), rid))
            if self.journal is not None:
                self.journal.append("preempt", rid, now,
                                    n=int(len(sus.generated)))
            if self.tel.enabled:
                self.tel.counter("frontend.preempted",
                                 victim=prio.name).inc()

    # --------------------------------------------------------- events --

    def _emit(self, ev) -> None:
        self.events.append(ev)
        self._step_events.append(ev)
        sub = self._subs.get(ev.rid)
        if sub is not None:
            sub(ev)

    def _emit_tokens(self, rid: int, toks: np.ndarray) -> None:
        """Publish any not-yet-seen prefix tokens as FirstToken/Delta."""
        n = self._published.get(rid, 0)
        if len(toks) <= n:
            return
        t = self._clock()
        if self.journal is not None:     # write-ahead: the chunk is
            self.journal.append(         # durable before it is emitted
                "chunk", rid, t, toks=[int(x) for x in toks[n:]])
        for k in range(n, len(toks)):
            cls = FirstToken if k == 0 else Delta
            self._emit(cls(rid, int(toks[k]), t))
        self._published[rid] = len(toks)

    def _on_stream(self, srid: int, toks: np.ndarray) -> None:
        """`ContinuousScheduler.stream_cb`: tokens-so-far for a live
        pooled request, once per scheduling round."""
        rid = self._from_sched.get(srid)
        if rid is not None:
            self._emit_tokens(rid, toks)

    def _finish_local(self, rid: int, status: str, *,
                      toks: Optional[np.ndarray] = None) -> None:
        """Resolve a request without a scheduler completion: a queue
        shed (no tokens) or a preempted-then-shed suspension (``toks``
        carries its pre-preemption output, tail-published first so the
        stream and the journal both see every token)."""
        self._deadline.pop(rid, None)
        self._prio.pop(rid, None)
        self._t_submit.pop(rid, None)
        if toks is None:
            toks = np.zeros((0,), np.int32)
        if len(toks):
            self._emit_tokens(rid, toks)     # tail the stream never saw
        self._published.pop(rid, None)
        self._results[rid] = (status, toks)
        t = self._clock()
        if self.tel.enabled:
            self.tel.counter("frontend.finish", status=status).inc()
            t0 = self._t_admit.pop(rid, None)
            if t0 is not None:
                self.tel.trace.add("queue_wait", t0, t,
                                   track=f"req {rid}", cat="frontend",
                                   status=status)
        if self.journal is not None:
            self.journal.append("finish", rid, t, status=status,
                                n=int(len(toks)))
        self._emit(Finish(rid, status, toks, t))

    def _finish_sched(self, srid: int) -> str:
        rid = self._from_sched.pop(srid)
        self._to_sched.pop(rid)
        self._deadline.pop(rid, None)
        self._prio.pop(rid, None)
        self._t_submit.pop(rid, None)
        comp = self.sched.pop_completion(srid)
        toks = np.asarray(comp.tokens)
        self._emit_tokens(rid, toks)     # tail the stream never saw
        self._published.pop(rid, None)
        status = "shed" if comp.timed_out else "served"
        self._results[rid] = (status, toks)
        if self.tel.enabled:
            self.tel.counter("frontend.finish", status=status).inc()
        t = self._clock()
        if self.journal is not None:
            self.journal.append("finish", rid, t, status=status,
                                n=int(len(toks)))
        self._emit(Finish(rid, status, toks, t))
        return status

    # ----------------------------------------------------------- loop --

    def has_work(self) -> bool:
        return bool(self._n_waiting() or self.sched.has_work())

    def step(self) -> list:
        """One frontend round: shed expired waiters, feed the scheduler
        up to the backpressure depth, run one scheduler round, resolve
        its completions, update the service-rate estimate and the
        breaker.  Returns this round's events, in emission order."""
        self._step_events = []
        self._expire_waiting()
        self._maybe_preempt()
        self._feed()
        done = self.sched.step()
        n_served = sum(self._finish_sched(srid) == "served"
                       for srid in done)
        now = self._clock()
        dt = now - self._t_last
        self._t_last = now
        if n_served and dt > 0:
            inst = n_served / dt
            a = self.fcfg.ewma
            self._rate = (inst if self._rate is None
                          else (1 - a) * self._rate + a * inst)
        self._update_breaker()
        if self.tel.enabled:
            m = self.tel.metrics
            for p in Priority:
                m.gauge("frontend.queue_depth",
                        priority=p.name).set(len(self._classes[p]))
            m.gauge("frontend.queue_depth_total").set(self.queue_depth())
            m.gauge("frontend.service_rate_rps").set(self._rate or 0.0)
            m.gauge("frontend.breaker_open").set(int(self.breaker_open))
        return self._step_events

    def run(self) -> dict:
        """Drain every admitted request; returns (and forgets)
        {rid: (status, tokens)} — statuses are LADDER rungs ("served" /
        "shed"; rejected submissions raised `Overloaded` instead and
        appear in `self.rejections`)."""
        while self.has_work():
            self.step()
        out, self._results = self._results, {}
        return out

    # ------------------------------------------------------- recovery --

    def restore(self, rid: int, request,
                priority: Priority = Priority.INTERACTIVE, *,
                deadline_at: Optional[float] = None,
                generated=None) -> int:
        """Re-install a journaled request under its *original* rid after
        a crash (`serve.recovery.recover` drives this).  Admission
        control is bypassed — the request was already admitted before
        the crash, so re-rejecting it would lose accepted work.  With
        ``generated`` (the journaled token chunks) it re-enters as a
        `Suspended` and resumes through the ordinary prefill path;
        `_published` starts past those tokens, so the pre-crash stream
        is never re-emitted and exactly one `Finish` is ever published
        per rid across the crashed and recovered frontends.  The
        restoration is re-journaled (submit + chunk), so the recovered
        frontend's own journal is self-contained against a second
        crash."""
        priority = Priority(priority)
        if rid in self._reqs or rid in self._to_sched or rid in self._results:
            raise ValueError(f"rid {rid} already live here")
        self._next_rid = max(self._next_rid, rid + 1)
        now = self._clock()
        deadline = math.inf if deadline_at is None else float(deadline_at)
        gen = np.asarray([] if generated is None else generated, np.int32)
        item = request
        if len(gen):
            item = Suspended(request, gen,
                             None if deadline == math.inf else deadline,
                             None)
        self._reqs[rid] = item
        self._deadline[rid] = deadline
        self._prio[rid] = priority
        self._t_submit[rid] = now
        self._published[rid] = len(gen)  # pre-crash tokens were streamed
        if self.journal is not None:
            self._journal_submit(rid, request, priority, deadline, now)
            if len(gen):
                self.journal.append("chunk", rid, now,
                                    toks=[int(x) for x in gen])
        if self.tel.enabled:
            self.tel.counter("frontend.admission", verdict="restored",
                             priority=priority.name).inc()
            self._t_admit[rid] = now
        heapq.heappush(self._classes[priority],
                       (deadline, next(self._seq), rid))
        if self.fcfg.max_queue is None:
            self._feed()
        return rid

    # ---------------------------------------------------------- async --

    async def stream(self, request,
                     priority: Priority = Priority.INTERACTIVE, *,
                     wait: bool = False, poll_s: float = 0.0):
        """Async iterator of this request's typed events, ending with
        `Finish`.  With ``wait=True`` an `Overloaded` rejection of an
        INTERACTIVE/BATCH request becomes backpressure: the caller
        sleeps the retry-after hint and retries instead of failing
        (BEST_EFFORT always fails fast — it is what the breaker sheds).
        Run `serve_forever()` on the same loop to drive the rounds."""
        while True:
            try:
                rid = self.submit(request, priority)
                break
            except Overloaded as e:
                if not wait or priority == Priority.BEST_EFFORT:
                    raise
                await asyncio.sleep(max(e.retry_after_s, poll_s))
        q: asyncio.Queue = asyncio.Queue()
        self._subs[rid] = q.put_nowait
        try:
            while True:
                ev = await q.get()
                yield ev
                if isinstance(ev, Finish):
                    return
        finally:
            self._subs.pop(rid, None)

    async def serve_forever(self, *, idle_s: float = 1e-3) -> None:
        """Round loop for the async API: runs `step()` whenever work
        exists, yields to submitters between rounds, idles otherwise.
        `close()` stops it after the current round."""
        self._closed = False
        while not self._closed:
            if self.has_work():
                self.step()
                await asyncio.sleep(0)       # let submitters interleave
            else:
                await asyncio.sleep(idle_s)

    def close(self) -> None:
        self._closed = True


# ------------------------------------------------- simulated workload --


@dataclasses.dataclass(frozen=True)
class SimClient:
    """One closed-loop client: issues ``requests`` in order, the next
    ``think_s`` after the previous resolves (served, shed or rejected).
    ``start_s`` is the nominal first-arrival instant — mapped through
    any scripted `ArrivalBurst` by the simulator, so a stampede compresses
    the fleet's session starts exactly like the gateway's arrivals."""
    requests: tuple
    priority: Priority = Priority.INTERACTIVE
    start_s: float = 0.0
    think_s: float = 0.0


@dataclasses.dataclass
class SimRecord:
    client: int
    priority: Priority
    t_submit: float
    status: str = ""                  # served | shed | rejected
    t_first: float = math.nan
    t_done: float = math.nan
    n_tokens: int = 0
    retry_after_s: float = 0.0
    token_ts: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class SimReport:
    """Per-request outcomes of one simulated closed-loop run, plus the
    metric views the SLO bench and the overload tests share."""
    records: list
    sim_s: float

    def of(self, *prios: Priority) -> list:
        return [r for r in self.records if r.priority in prios]

    def status_rate(self, *statuses: str) -> float:
        return float(np.mean([r.status in statuses for r in self.records]))

    @property
    def reject_rate(self) -> float:
        return self.status_rate("rejected")

    @property
    def goodput_rps(self) -> float:
        """Served (in-deadline, token-bearing) requests per simulated
        second — the half of the offered load that became useful work."""
        n = sum(r.status == "served" for r in self.records)
        return n / self.sim_s if self.sim_s > 0 else 0.0

    def ttft_ms(self, *prios: Priority) -> np.ndarray:
        recs = self.of(*prios) if prios else self.records
        return np.asarray([(r.t_first - r.t_submit) * 1e3 for r in recs
                           if r.status == "served"])

    def itl_ms(self) -> np.ndarray:
        """Inter-token gaps across every served multi-token request."""
        gaps: list[float] = []
        for r in self.records:
            if r.status == "served" and len(r.token_ts) > 1:
                gaps.extend(np.diff(np.asarray(r.token_ts)) * 1e3)
        return np.asarray(gaps)


def drive_closed_loop(fe: StreamingFrontend, clients: list[SimClient], *,
                      clock: VirtualClock, round_s: float,
                      faults=None) -> SimReport:
    """Run a closed-loop fleet against a frontend on a virtual clock.

    Each scheduler round costs ``round_s`` of simulated time (the
    discrete-event stand-in for the decode chunk's service time — the
    same modeling move the gateway makes with `DeviceModel`); arrivals
    due at or before the current instant submit between rounds, and a
    client whose request resolves — or is rejected — schedules its next
    one ``think_s`` later.  Deterministic end to end: tokens are greedy
    and seeded, the clock only moves by round arithmetic, and rejection
    decisions depend on nothing but queue state and the clock — so the
    SLO bench pins its TTFT/ITL/reject-rate rows as exact values, the
    way every gateway row is pinned.
    """
    if fe._clock is not clock:
        raise ValueError("the frontend and the simulator must share the clock")
    n_next = [0] * len(clients)      # next request index per client
    due = []                         # (t, client) heap of pending submits
    for c, cl in enumerate(clients):
        if cl.requests:
            t0 = cl.start_s
            if faults is not None:
                t0 = faults.arrival_time(c, t0)
            heapq.heappush(due, (t0, c))
    records: list[SimRecord] = []
    live: dict[int, SimRecord] = {}  # frontend rid -> record
    t0 = min(t for t, _ in due) if due else 0.0
    t_end = t0

    def submit_due() -> None:
        nonlocal t_end
        while due and due[0][0] <= clock.now:
            _, c = heapq.heappop(due)
            cl = clients[c]
            j = n_next[c]
            n_next[c] = j + 1
            rec = SimRecord(client=c, priority=cl.priority,
                            t_submit=clock.now)
            records.append(rec)
            try:
                rid = fe.submit(cl.requests[j], cl.priority)
                live[rid] = rec
            except Overloaded as e:
                rec.status = "rejected"
                rec.t_done = clock.now
                rec.retry_after_s = e.retry_after_s
                t_end = max(t_end, clock.now)
                if j + 1 < len(cl.requests):
                    heapq.heappush(due, (clock.now + cl.think_s, c))

    while due or fe.has_work():
        submit_due()
        if not fe.has_work():
            # idle frontend: jump the clock to the next arrival
            clock.now = max(clock.now, due[0][0])
            continue
        clock.now += round_s         # this round's service time elapses
        for ev in fe.step():
            rec = live.get(ev.rid)
            if rec is None:
                continue
            if isinstance(ev, (FirstToken, Delta)):
                if isinstance(ev, FirstToken):
                    rec.t_first = ev.t
                rec.token_ts.append(ev.t)
            elif isinstance(ev, Finish):
                live.pop(ev.rid)
                rec.status = ev.status
                rec.t_done = ev.t
                rec.n_tokens = len(ev.tokens)
                t_end = max(t_end, ev.t)
                c = rec.client
                if n_next[c] < len(clients[c].requests):
                    heapq.heappush(due, (ev.t + clients[c].think_s, c))
    return SimReport(records=records, sim_s=t_end - t0)
