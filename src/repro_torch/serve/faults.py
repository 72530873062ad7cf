"""Seeded, scriptable fault injection for the offload serving stack.

A copy of ``repro.serve.faults`` (numpy only).  The port's offload
gateway consumes it; the decode-scheduler faults (`SlotPoolStall`,
`EngineCrash`) and `serve.recovery` wait for the continuous scheduler.

The gateway simulation's benign failure model (i.i.d. drops with a fixed
retransmit timeout) never exercises the failure modes a weak-device
deployment actually sees: burst loss on a fading channel, a link that
goes dark for hundreds of milliseconds, a device stalled by an interrupt
storm, a gateway whose slot pool stops draining.  This module models
those as *deterministic, seeded schedules* so chaos runs replay exactly:

  * ``Blackout``        — a window during which every transmit attempt on
    the affected links is lost (forced drops, no final-attempt rescue).
  * ``BurstLoss``       — a Gilbert–Elliott two-state channel: a per-link
    Markov chain alternates between a good state (low loss) and a bad
    state (near-total loss), advanced one step per transmit attempt.
  * ``LinkDegrade``     — a window of reduced bandwidth and/or extra
    i.i.d. loss on the affected links.
  * ``DeviceStall``     — extra on-device compute latency in a window
    (GC pause / interrupt storm on the MCU).
  * ``GatewayStall``    — extra Remote-NN service latency for batches
    launched in a window (the slot pool holds its slots longer).
  * ``PayloadCorruption`` — delivered payloads have their LZW code
    stream flipped or truncated; the gateway's hardened decode turns
    this into a typed erasure instead of a crash.
  * ``ArrivalBurst``      — a client stampede: arrivals nominally spread
    over a window land compressed toward its start, multiplying offered
    load by ``factor`` without changing total demand.  Consumed by the
    gateway's arrival events and by the streaming frontend's simulated
    client loop, so overload is scriptable and replayable like every other
    fault.
  * ``EngineCrash``       — the decode scheduler dies at the start of a
    given round (`EngineCrashError`), losing the pool and every
    in-flight request; `serve.recovery` replays them from the request
    journal.

`FaultInjector` owns all fault randomness (per-client RNGs seeded from
one root seed), so the channels' own RNG streams — and therefore every
fault-free run — stay bit-identical with an injector attached.  The
injector is queried by `Channel.transmit` (via `link()` views), by the
gateway event loop (stalls, corruption) and by the decode scheduler
(chunk stalls); with an empty schedule every query is a no-op.

`parse_faults` turns a compact CLI spec ("blackout:0.05:0.2;burst") into
a schedule (the JAX package's `launch.serve --faults`; the port's
launcher is not written yet).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _window_ok(t0: float, t1: float, what: str) -> None:
    _check(0.0 <= t0 < t1, f"{what}: need 0 <= t0 < t1, got [{t0}, {t1})")


@dataclasses.dataclass(frozen=True)
class Blackout:
    """All transmit attempts on the affected links are lost in [t0, t1)."""
    t0: float = 0.0
    t1: float = math.inf
    clients: "tuple[int, ...] | None" = None     # None = every client

    def __post_init__(self):
        _window_ok(self.t0, self.t1, "Blackout")


@dataclasses.dataclass(frozen=True)
class BurstLoss:
    """Gilbert–Elliott burst loss: a two-state Markov chain per link.

    The chain advances one step per transmit attempt inside the window;
    attempts drop with the current state's loss probability.  Defaults
    give ~3-attempt bursts of near-total loss on an otherwise clean link.
    """
    t0: float = 0.0
    t1: float = math.inf
    p_good_bad: float = 0.1        # P(good -> bad) per attempt
    p_bad_good: float = 0.3        # P(bad -> good) per attempt
    loss_good: float = 0.0
    loss_bad: float = 1.0
    clients: "tuple[int, ...] | None" = None

    def __post_init__(self):
        _window_ok(self.t0, self.t1, "BurstLoss")
        for name in ("p_good_bad", "p_bad_good", "loss_good", "loss_bad"):
            v = getattr(self, name)
            _check(0.0 <= v <= 1.0, f"BurstLoss.{name} must be in [0, 1], "
                                    f"got {v}")


@dataclasses.dataclass(frozen=True)
class LinkDegrade:
    """Reduced bandwidth and/or extra i.i.d. loss in [t0, t1)."""
    t0: float = 0.0
    t1: float = math.inf
    bandwidth_scale: float = 1.0   # serialization time divides by this
    extra_loss: float = 0.0        # additional i.i.d. per-attempt loss
    clients: "tuple[int, ...] | None" = None

    def __post_init__(self):
        _window_ok(self.t0, self.t1, "LinkDegrade")
        _check(self.bandwidth_scale > 0.0,
               f"LinkDegrade.bandwidth_scale must be > 0, "
               f"got {self.bandwidth_scale}")
        _check(0.0 <= self.extra_loss <= 1.0,
               f"LinkDegrade.extra_loss must be in [0, 1], "
               f"got {self.extra_loss}")


@dataclasses.dataclass(frozen=True)
class DeviceStall:
    """Extra on-device compute seconds for requests started in [t0, t1)."""
    t0: float = 0.0
    t1: float = math.inf
    stall_s: float = 0.05
    clients: "tuple[int, ...] | None" = None

    def __post_init__(self):
        _window_ok(self.t0, self.t1, "DeviceStall")
        _check(self.stall_s > 0.0,
               f"DeviceStall.stall_s must be > 0, got {self.stall_s}")


@dataclasses.dataclass(frozen=True)
class GatewayStall:
    """Extra Remote-NN service seconds for batches launched in [t0, t1):
    the feature slot pool holds its slots that much longer."""
    t0: float = 0.0
    t1: float = math.inf
    stall_s: float = 0.05

    def __post_init__(self):
        _window_ok(self.t0, self.t1, "GatewayStall")
        _check(self.stall_s > 0.0,
               f"GatewayStall.stall_s must be > 0, got {self.stall_s}")


@dataclasses.dataclass(frozen=True)
class PayloadCorruption:
    """Delivered payloads are corrupted with ``prob`` in [t0, t1): the
    LZW code stream is truncated or bit-flipped on the air.  The gateway
    detects this (`PayloadCorruptionError`) and zero-fills the request's
    offloaded channels instead of crashing or retrying."""
    t0: float = 0.0
    t1: float = math.inf
    prob: float = 1.0
    clients: "tuple[int, ...] | None" = None

    def __post_init__(self):
        _window_ok(self.t0, self.t1, "PayloadCorruption")
        _check(0.0 < self.prob <= 1.0,
               f"PayloadCorruption.prob must be in (0, 1], got {self.prob}")


@dataclasses.dataclass(frozen=True)
class ArrivalBurst:
    """Client stampede: an arrival nominally at ``t`` in [t0, t1) lands
    at ``t0 + (t - t0) / factor`` instead — the window's arrivals
    compress into its first ``1/factor``-th, so offered load inside the
    burst multiplies by ``factor`` while total demand is unchanged.
    Deterministic (no RNG): the same schedule maps the same arrival
    times on every run, which is what lets the overload benches pin
    reject/shed rates as exact rows."""
    t0: float = 0.0
    t1: float = math.inf
    factor: float = 10.0
    clients: "tuple[int, ...] | None" = None

    def __post_init__(self):
        _window_ok(self.t0, self.t1, "ArrivalBurst")
        _check(self.factor >= 1.0,
               f"ArrivalBurst.factor must be >= 1, got {self.factor}")


@dataclasses.dataclass(frozen=True)
class SlotPoolStall:
    """Decode-scheduler fault: scheduling rounds in [r0, r1) dispatch no
    decode chunk (the executor is stalled); deadlines keep aging, so
    deadline-evict — not the stall — decides when requests leave."""
    r0: int = 0
    r1: int = 1 << 30

    def __post_init__(self):
        _check(0 <= self.r0 < self.r1,
               f"SlotPoolStall: need 0 <= r0 < r1, got [{self.r0}, {self.r1})")


@dataclasses.dataclass(frozen=True)
class EngineCrash:
    """Decode-scheduler fault: the engine dies at the start of
    scheduling round ``r`` (0-based) — `ContinuousScheduler.step` raises
    `EngineCrashError`, losing the pool and every in-flight chunk.  With
    a request journal attached, `serve.recovery` reconstructs the
    frontend from the journaled events and replays the in-flight
    requests bit-identically; without one, this is the fault that proves
    work *would* be lost."""
    r: int = 0

    def __post_init__(self):
        _check(self.r >= 0, f"EngineCrash: need r >= 0, got {self.r}")


class EngineCrashError(RuntimeError):
    """The scripted `EngineCrash` fired: the scheduler's state is gone.
    Callers holding a journal hand it to `serve.recovery.recover`."""


FaultEvent = (Blackout, BurstLoss, LinkDegrade, DeviceStall, GatewayStall,
              PayloadCorruption, ArrivalBurst, SlotPoolStall, EngineCrash)


def _applies(ev, client: int) -> bool:
    return ev.clients is None or client in ev.clients


class _GEChain:
    """One link's Gilbert–Elliott state, advanced per transmit attempt."""

    def __init__(self, spec: BurstLoss, rng: np.random.RandomState):
        self.spec = spec
        self.rng = rng
        self.bad = False

    def attempt_lost(self) -> bool:
        s = self.spec
        flip = float(self.rng.uniform())
        if self.bad:
            self.bad = flip >= s.p_bad_good
        else:
            self.bad = flip < s.p_good_bad
        loss = s.loss_bad if self.bad else s.loss_good
        if loss <= 0.0:
            return False
        if loss >= 1.0:
            return True
        return float(self.rng.uniform()) < loss


class LinkFaultView:
    """Per-client view handed to `Channel.transmit`: answers, for one
    attempt at simulated time t, whether the attempt is force-lost and
    how much the link's bandwidth is scaled.  All randomness comes from
    the injector's per-client RNG, never the channel's own stream."""

    def __init__(self, injector: "FaultInjector", client: int):
        self._inj = injector
        self.client = client

    def bandwidth_scale(self, t: float) -> float:
        scale = 1.0
        for ev in self._inj.degrades:
            if _applies(ev, self.client) and ev.t0 <= t < ev.t1:
                scale *= ev.bandwidth_scale
        return scale

    def attempt_lost(self, t: float) -> bool:
        inj, c = self._inj, self.client
        for ev in inj.blackouts:
            if _applies(ev, c) and ev.t0 <= t < ev.t1:
                return True
        lost = False
        for ev, chain in inj.chains_for(c):
            if ev.t0 <= t < ev.t1 and chain.attempt_lost():
                lost = True              # chain still advances when another
        if lost:                         # event already lost the attempt
            return True
        rng = inj.rng_for(c)
        for ev in inj.degrades:
            if (_applies(ev, c) and ev.t0 <= t < ev.t1 and ev.extra_loss > 0
                    and float(rng.uniform()) < ev.extra_loss):
                return True
        return False


class FaultInjector:
    """A seeded fault schedule queried by every layer of the stack.

    The same (schedule, seed) pair replays the exact same fault decisions
    on every run — fault randomness is isolated per client, so one
    client's retries never perturb another's loss sequence."""

    def __init__(self, schedule: "tuple | list" = (), *, seed: int = 0):
        events = tuple(schedule)
        for ev in events:
            _check(isinstance(ev, FaultEvent),
                   f"unknown fault event {type(ev).__name__}")
        self.schedule = events
        self.seed = seed
        self.blackouts = tuple(e for e in events if isinstance(e, Blackout))
        self.bursts = tuple(e for e in events if isinstance(e, BurstLoss))
        self.degrades = tuple(e for e in events if isinstance(e, LinkDegrade))
        self.dev_stalls = tuple(e for e in events
                                if isinstance(e, DeviceStall))
        self.gw_stalls = tuple(e for e in events
                               if isinstance(e, GatewayStall))
        self.corruptions = tuple(e for e in events
                                 if isinstance(e, PayloadCorruption))
        self.pool_stalls = tuple(e for e in events
                                 if isinstance(e, SlotPoolStall))
        self.crashes = tuple(e for e in events
                             if isinstance(e, EngineCrash))
        self.arrival_bursts = tuple(e for e in events
                                    if isinstance(e, ArrivalBurst))
        self._rngs: dict[int, np.random.RandomState] = {}
        self._chains: dict[int, list] = {}
        self._views: dict[int, LinkFaultView] = {}

    # ------------------------------------------------------------ state --
    def rng_for(self, client: int) -> np.random.RandomState:
        rng = self._rngs.get(client)
        if rng is None:
            rng = self._rngs[client] = np.random.RandomState(
                (self.seed * 1_000_003 + 9_176 * client + 7) % (1 << 31))
        return rng

    def chains_for(self, client: int) -> list:
        chains = self._chains.get(client)
        if chains is None:
            chains = self._chains[client] = [
                (ev, _GEChain(ev, self.rng_for(client)))
                for ev in self.bursts if _applies(ev, client)]
        return chains

    def link(self, client: int) -> LinkFaultView:
        view = self._views.get(client)
        if view is None:
            view = self._views[client] = LinkFaultView(self, client)
        return view

    # ----------------------------------------------------------- stalls --
    def device_stall_extra(self, client: int, t: float) -> float:
        return sum(ev.stall_s for ev in self.dev_stalls
                   if _applies(ev, client) and ev.t0 <= t < ev.t1)

    def server_stall_extra(self, t: float) -> float:
        return sum(ev.stall_s for ev in self.gw_stalls if ev.t0 <= t < ev.t1)

    def chunk_stalled(self, round_idx: int) -> bool:
        return any(ev.r0 <= round_idx < ev.r1 for ev in self.pool_stalls)

    def crashed(self, round_idx: int) -> bool:
        return any(ev.r == round_idx for ev in self.crashes)

    # --------------------------------------------------------- arrivals --
    def arrival_time(self, client: int, t: float) -> float:
        """Map one nominal arrival time through the stampede schedule:
        arrivals inside an `ArrivalBurst` window compress toward its
        start by the burst factor; everything else passes through
        unchanged (so an empty schedule is exactly the identity)."""
        for ev in self.arrival_bursts:
            if _applies(ev, client) and ev.t0 <= t < ev.t1:
                return ev.t0 + (t - ev.t0) / ev.factor
        return t

    # ------------------------------------------------------- corruption --
    def corrupt(self, client: int, t: float, codes: list) -> "list | None":
        """A corrupted copy of a payload's LZW code stream, or None when
        no corruption event fires.  Truncation drops a suffix; flips xor
        a random bit into one code — typically caught by the hardened
        decoder or the framing length check (a flip that lands on
        another valid code is undetectable without checksums and serves
        a garbled frame, like a real radio would)."""
        for ev in self.corruptions:
            if not (_applies(ev, client) and ev.t0 <= t < ev.t1):
                continue
            rng = self.rng_for(client)
            if float(rng.uniform()) >= ev.prob:
                continue
            bad = list(codes)
            if not bad:
                return bad
            if int(rng.randint(2)) or len(bad) == 1:
                i = int(rng.randint(len(bad)))
                bad[i] = int(bad[i]) ^ (1 << int(rng.randint(14)))
            else:
                bad = bad[:int(rng.randint(1, len(bad)))]
            return bad
        return None


def parse_faults(spec: str) -> tuple:
    """Compact CLI fault schedule: ';'-separated events, ':'-separated
    fields (times in seconds of simulated time).

      blackout[:t0:t1]         link dark in [t0, t1)      (default whole run)
      burst[:t0:t1[:pgb:pbg]]  Gilbert–Elliott burst loss
      degrade[:t0:t1[:scale[:loss]]]   bandwidth scale + extra loss
      devstall[:t0:t1[:s]]     extra device compute seconds
      gwstall[:t0:t1[:s]]      extra gateway service seconds
      corrupt[:t0:t1[:p]]      payload corruption probability
      stampede[:t0:t1[:f]]     client stampede: the window's arrivals
                               compress toward t0 by factor f (offered
                               load x f inside the burst)

    e.g. --faults "blackout:0.05:0.2;burst;corrupt:0:1:0.3"
    """
    out = []
    for item in spec.split(";"):
        item = item.strip()
        if not item:
            continue
        kind, *fs = item.split(":")
        f = [float(x) for x in fs]
        window = {"t0": f[0], "t1": f[1]} if len(f) >= 2 else {}
        if kind == "blackout":
            out.append(Blackout(**window))
        elif kind == "burst":
            extra = ({"p_good_bad": f[2], "p_bad_good": f[3]}
                     if len(f) >= 4 else {})
            out.append(BurstLoss(**window, **extra))
        elif kind == "degrade":
            extra = {"bandwidth_scale": f[2]} if len(f) >= 3 else {}
            if len(f) >= 4:
                extra["extra_loss"] = f[3]
            out.append(LinkDegrade(**window, **extra))
        elif kind == "devstall":
            extra = {"stall_s": f[2]} if len(f) >= 3 else {}
            out.append(DeviceStall(**window, **extra))
        elif kind == "gwstall":
            extra = {"stall_s": f[2]} if len(f) >= 3 else {}
            out.append(GatewayStall(**window, **extra))
        elif kind == "corrupt":
            extra = {"prob": f[2]} if len(f) >= 3 else {}
            out.append(PayloadCorruption(**window, **extra))
        elif kind == "stampede":
            extra = {"factor": f[2]} if len(f) >= 3 else {}
            out.append(ArrivalBurst(**window, **extra))
        else:
            raise ValueError(f"unknown fault kind {kind!r} in --faults spec")
    return tuple(out)
