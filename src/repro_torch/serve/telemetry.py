"""Process-wide but injectable telemetry: metrics + trace spans.

A copy of ``repro.serve.telemetry``: pure Python, no tensors.

One registry serves every layer of the stack (frontend, scheduler,
gateway, engine/kernels):

* ``Counter`` / ``Gauge`` / ``Histogram`` — the histogram keeps fixed
  ascending bucket bounds and answers p50/p99 in closed form from the
  cumulative counts (linear interpolation inside the selected bucket);
  an ``exact=True`` mode retains the raw samples so benchmark helpers
  can reproduce ``np.percentile`` bit-for-bit.
* ``Tracer`` — span-based, Chrome-trace ("X" complete events) export
  loadable in Perfetto.  Spans carry *seconds* on whatever timeline the
  caller lives on: simulated components stamp ``EventLoop.now`` /
  ``VirtualClock`` timestamps through :meth:`Tracer.add`, wall-clock
  components use the :meth:`Telemetry.span` context manager, so
  simulated and wall runs produce structurally comparable traces.
* ``Telemetry`` — the facade components accept (``telemetry=None``
  falls back to the module-wide disabled default).  The hard contract:
  while ``enabled`` is False, instrumentation sites are skipped
  entirely — zero device→host copies, zero RNG or clock reads — so
  greedy tokens and seeded simulations stay bit-identical.

The telemetry clock is deliberately *not* the component's injected
scheduler clock: test clocks advance on every read, so borrowing them
would perturb deadline math.  Wall spans read ``time.perf_counter`` (or
whatever ``clock=`` was passed) and only when enabled.
"""
from __future__ import annotations

import json
import math
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "Span", "Tracer", "Telemetry", "default",
]


# ---------------------------------------------------------------------------
# instruments


class Counter:
    """Monotonic event count."""

    __slots__ = ("name", "labels", "n")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self.n = 0

    def inc(self, by: int = 1) -> None:
        self.n += by

    @property
    def value(self) -> int:
        return self.n


class Gauge:
    """Last-written value (pool occupancy, queue depth, EWMA estimate)."""

    __slots__ = ("name", "labels", "v")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self.v = 0.0

    def set(self, v: float) -> None:
        self.v = float(v)

    @property
    def value(self) -> float:
        return self.v


DEFAULT_BOUNDS = (1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2,
                  5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def exponential(start: float, factor: float, count: int) -> Tuple[float, ...]:
    """Geometric bucket bounds: ``start * factor**i`` for i in [0, count)."""
    return tuple(start * factor ** i for i in range(count))


class Histogram:
    """Fixed-bucket histogram with closed-form percentiles.

    Bucket ``i`` counts observations in ``(bounds[i-1], bounds[i]]``;
    an implicit overflow bucket catches everything past ``bounds[-1]``.
    ``percentile(q)`` walks the cumulative counts to the bucket holding
    the q-th observation and interpolates linearly inside it, using the
    observed min/max to tighten the open-ended edge buckets.

    ``exact=True`` additionally retains every sample and answers
    percentiles via ``np.percentile`` — benchmark helpers use this mode
    so deduplicating their percentile math cannot move row values.
    """

    __slots__ = ("name", "labels", "bounds", "counts", "count", "total",
                 "_min", "_max", "_samples")

    def __init__(self, name: str = "", bounds: Tuple[float, ...] = DEFAULT_BOUNDS,
                 labels: Tuple[Tuple[str, str], ...] = (), exact: bool = False):
        if list(bounds) != sorted(bounds):
            raise ValueError("histogram bounds must be ascending")
        self.name = name
        self.labels = labels
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)   # +1: overflow
        self.count = 0
        self.total = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._samples: Optional[List[float]] = [] if exact else None

    @classmethod
    def exact(cls, name: str = "") -> "Histogram":
        return cls(name, exact=True)

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v < self._min:
            self._min = v
        if v > self._max:
            self._max = v
        if self._samples is not None:
            self._samples.append(v)
        lo, hi = 0, len(self.bounds)
        while lo < hi:                       # first bound >= v
            mid = (lo + hi) // 2
            if self.bounds[mid] < v:
                lo = mid + 1
            else:
                hi = mid
        self.counts[lo] += 1

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else math.nan

    def percentile(self, q: float) -> float:
        """q in [0, 100]; NaN when empty."""
        if not self.count:
            return math.nan
        if self._samples is not None:
            import numpy as np
            return float(np.percentile(self._samples, q))
        # rank of the q-th observation (same convention as np.percentile's
        # linear interpolation, applied at bucket granularity)
        rank = q / 100.0 * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            if cum + c >= rank or i == len(self.counts) - 1:
                lo = self.bounds[i - 1] if i > 0 else self._min
                hi = self.bounds[i] if i < len(self.bounds) else self._max
                lo = max(lo, self._min)
                hi = min(hi, self._max)
                if hi <= lo or c == 0:
                    return lo
                frac = min(max((rank - cum) / c, 0.0), 1.0)
                return lo + (hi - lo) * frac
            cum += c
        return self._max

    def p50(self) -> float:
        return self.percentile(50.0)

    def p99(self) -> float:
        return self.percentile(99.0)


# ---------------------------------------------------------------------------
# registry


def _label_key(labels: Dict[str, object]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Create-or-get instrument store keyed by (name, labels)."""

    def __init__(self) -> None:
        self._instruments: Dict[tuple, object] = {}

    def _get(self, cls, name: str, labels: Dict[str, object], **kw):
        key = (cls.__name__, name, _label_key(labels))
        inst = self._instruments.get(key)
        if inst is None:
            inst = cls(name, labels=_label_key(labels), **kw)
            self._instruments[key] = inst
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, bounds: Tuple[float, ...] = DEFAULT_BOUNDS,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, bounds=bounds)

    def instruments(self) -> List[object]:
        return list(self._instruments.values())

    # -- exporters ----------------------------------------------------------

    def to_dict(self) -> dict:
        """Flat JSON-able dump (``--metrics-json``)."""
        out: dict = {}
        for inst in self._instruments.values():
            key = inst.name
            if inst.labels:
                key += "{" + ",".join(f"{k}={v}" for k, v in inst.labels) + "}"
            if isinstance(inst, Histogram):
                out[key] = {
                    "count": inst.count, "sum": inst.total,
                    "p50": inst.p50(), "p99": inst.p99(),
                    "min": inst._min if inst.count else None,
                    "max": inst._max if inst.count else None,
                }
            else:
                out[key] = inst.value
        return out

    @staticmethod
    def _prom_name(name: str) -> str:
        return "".join(c if c.isalnum() or c == "_" else "_" for c in name)

    def prometheus_text(self) -> str:
        """Prometheus-style exposition text (the stderr metrics dump)."""
        lines: List[str] = []
        typed: set = set()
        for inst in sorted(self._instruments.values(), key=lambda i: i.name):
            pname = self._prom_name(inst.name)
            lbl = "{" + ",".join(f'{self._prom_name(k)}="{v}"'
                                 for k, v in inst.labels) + "}" \
                if inst.labels else ""
            if isinstance(inst, Counter):
                if pname not in typed:
                    lines.append(f"# TYPE {pname} counter")
                    typed.add(pname)
                lines.append(f"{pname}{lbl} {inst.n}")
            elif isinstance(inst, Gauge):
                if pname not in typed:
                    lines.append(f"# TYPE {pname} gauge")
                    typed.add(pname)
                lines.append(f"{pname}{lbl} {inst.v:.6g}")
            else:
                if pname not in typed:
                    lines.append(f"# TYPE {pname} histogram")
                    typed.add(pname)
                base = lbl[1:-1] if lbl else ""
                cum = 0
                for b, c in zip(inst.bounds, inst.counts):
                    cum += c
                    sep = "," if base else ""
                    lines.append(f'{pname}_bucket{{{base}{sep}le="{b:g}"}} '
                                 f"{cum}")
                sep = "," if base else ""
                lines.append(f'{pname}_bucket{{{base}{sep}le="+Inf"}} '
                             f"{inst.count}")
                lines.append(f"{pname}_sum{lbl} {inst.total:.6g}")
                lines.append(f"{pname}_count{lbl} {inst.count}")
        return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------------
# tracing


@dataclass
class Span:
    """Closed interval on some track's timeline, in seconds."""
    name: str
    t0: float
    t1: float
    track: str = "main"
    cat: str = ""
    args: dict = field(default_factory=dict)

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


class Tracer:
    """Span collector with a Chrome-trace exporter.

    Simulated components record finished intervals with :meth:`add`
    (explicit event-loop timestamps — the tracer never reads a clock on
    their behalf); wall-clock components use ``Telemetry.span``.  Tracks
    map to Chrome tids so Perfetto renders one lane per logical actor
    (scheduler, gateway, ``client 3`` …), with nesting inferred from
    interval containment.
    """

    def __init__(self) -> None:
        self.spans: List[Span] = []

    def add(self, name: str, t0: float, t1: float, *, track: str = "main",
            cat: str = "", **args) -> Span:
        sp = Span(name, float(t0), float(t1), track, cat, args)
        self.spans.append(sp)
        return sp

    def by_track(self, track: str) -> List[Span]:
        return [s for s in self.spans if s.track == track]

    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON (``{"traceEvents": [...]}``).

        Timestamps are microseconds as the format requires; "M" metadata
        rows name each track's lane.
        """
        tids: Dict[str, int] = {}
        events: List[dict] = []
        for sp in self.spans:
            if sp.track not in tids:
                tid = tids[sp.track] = len(tids)
                events.append({"ph": "M", "name": "thread_name", "pid": 1,
                               "tid": tid, "args": {"name": sp.track}})
        for sp in sorted(self.spans, key=lambda s: (s.t0, -s.t1)):
            ev = {"ph": "X", "name": sp.name, "cat": sp.cat or "span",
                  "pid": 1, "tid": tids[sp.track],
                  "ts": sp.t0 * 1e6, "dur": max(sp.dur, 0.0) * 1e6}
            if sp.args:
                ev["args"] = dict(sp.args)
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)


# ---------------------------------------------------------------------------
# facade


class Telemetry:
    """Injectable bundle of a registry, a tracer, and a wall clock.

    ``enabled=False`` (the module default) is the no-subscriber state:
    every instrumentation site in the stack guards on ``tel.enabled``
    and is skipped outright, so the disabled path performs zero
    device→host copies and zero RNG/clock reads.  The instruments stay
    usable either way — only the *component hooks* are gated.
    """

    def __init__(self, enabled: bool = True,
                 clock: Callable[[], float] = time.perf_counter):
        self.enabled = enabled
        self.clock = clock
        self.metrics = MetricsRegistry()
        self.trace = Tracer()
        self._jit_seen: Dict[int, int] = {}

    # registry passthroughs
    def counter(self, name: str, **labels) -> Counter:
        return self.metrics.counter(name, **labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self.metrics.gauge(name, **labels)

    def histogram(self, name: str, bounds=DEFAULT_BOUNDS, **labels) -> Histogram:
        return self.metrics.histogram(name, bounds, **labels)

    @contextmanager
    def span(self, name: str, *, track: str = "main", cat: str = "",
             **args) -> Iterator[Optional[Span]]:
        """Wall-clock span; no clock read when disabled."""
        if not self.enabled:
            yield None
            return
        t0 = self.clock()
        try:
            yield None
        finally:
            self.trace.add(name, t0, self.clock(), track=track, cat=cat,
                           **args)

    # -- jit compile accounting --------------------------------------------

    def note_compiles(self, name: str, fn, shape: object = "") -> None:
        """Attribute new entries in ``fn``'s jit cache to ``shape``.

        Call after invoking the jitted ``fn``: any growth of
        ``fn._cache_size()`` since the last call is counted against the
        program-shape key the caller just ran (bucket width, buffer
        length, …).  Keyed by ``id(fn)`` so per-instance ``jax.jit``
        wrappers are tracked independently.
        """
        try:
            n = fn._cache_size()
        except Exception:
            return
        key = id(fn)
        last = self._jit_seen.get(key)
        if last is None:
            self._jit_seen[key] = n
            if n:
                self.metrics.counter(f"jit.{name}.compiles",
                                     shape=str(shape)).inc(n)
            return
        if n > last:
            self.metrics.counter(f"jit.{name}.compiles",
                                 shape=str(shape)).inc(n - last)
        self._jit_seen[key] = n

    def compile_count(self, prefix: str = "") -> int:
        """Total jit compiles recorded (optionally for one ``jit.<prefix>``)."""
        want = f"jit.{prefix}" if prefix else "jit."
        return sum(c.n for c in self.metrics.instruments()
                   if isinstance(c, Counter) and c.name.startswith(want)
                   and c.name.endswith(".compiles"))


_DEFAULT = Telemetry(enabled=False)


def default() -> Telemetry:
    """The process-wide registry (disabled until someone enables it)."""
    return _DEFAULT
