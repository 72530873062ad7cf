"""Crash-consistent request journal + replay recovery for the frontend.

The port of ``repro.serve.recovery``, with its own copy of the journal's
record format (one ``<crc32 hex> <canonical JSON>`` line per event), so a
journal written by either package reads in the other.

The streaming frontend's degradation ladder bounds *overload*, but two
failure modes still lose admitted work outright: an engine crash
mid-round discards every in-flight request's partial tokens, and nothing
durable records what was admitted in the first place.  This module makes
"no admitted request is ever lost" a mechanical property:

  * **RequestJournal** — an append-only write-ahead log of typed events
    (``submit``/``admit``/``chunk``/``preempt``/``finish``) stamped on
    the frontend's shared clock timeline.  Each JSONL record carries a
    crc32 over its payload, so a torn final line (the partial write a
    real crash leaves) is detected and dropped rather than parsed —
    everything before it is intact by append-only discipline.  Journal
    writes reuse clock reads the frontend already makes and cost one
    dict + one flushed line each, cheap enough to leave on; with no
    path, events are kept in memory only (tests, benches).
  * **recovery_plan** — folds a journal into (a) requests that finished
    before the crash, with their full token streams reassembled from
    ``chunk`` records, and (b) replay items: admitted-but-unfinished
    requests as (original rid, Request, class, absolute deadline,
    tokens generated so far).  A request whose journaled tokens already
    exhaust its budget or end at EOS lost only its ``finish`` record to
    the crash — it resolves directly instead of replaying.
  * **recover** — installs every replay item into a fresh frontend
    under its original rid (`StreamingFrontend.restore`: admission
    control bypassed, pre-crash tokens resume through the scheduler's
    suspend/resume path), drains it, and merges with the pre-crash
    finishes.  The merge asserts disjointness: exactly one ``Finish``
    is ever delivered per rid across the crashed and recovered runs.

Greedy determinism is what makes replay *exact* rather than
best-effort: a resumed request prefills prompt + journaled tokens and
argmax-decodes the remainder, so the recovered stream has the crash-free
run's tokens (tested by sweeping `EngineCrash` across every scheduling
round of a pinned workload).
"""
from __future__ import annotations

import dataclasses
import json
import zlib
from typing import Optional

import numpy as np

from repro_torch.serve import telemetry as _telemetry
from repro_torch.serve.engine import Request
from repro_torch.serve.frontend import Priority

EVENT_KINDS = ("submit", "admit", "chunk", "preempt", "finish")


class RequestJournal:
    """Append-only write-ahead request journal.

    Every record is one line: ``<crc32 hex> <canonical JSON>``, flushed
    on append so a crash can tear at most the line being written —
    which the crc then rejects on read.  ``events`` mirrors the records
    in memory (the only store when ``path`` is None), so an in-process
    recovery never re-parses the file.  With telemetry enabled, appends
    count into ``journal.events{ev=...}``; disabled telemetry costs
    nothing (no clock reads — timestamps come from the caller).
    """

    def __init__(self, path: Optional[str] = None, *, telemetry=None):
        self.path = path
        self.events: list[dict] = []
        self.tel = telemetry if telemetry is not None else _telemetry.default()
        self._f = open(path, "a", encoding="utf-8") if path else None

    def append(self, ev: str, rid: int, t: float, **fields) -> dict:
        if ev not in EVENT_KINDS:
            raise ValueError(f"unknown journal event {ev!r}")
        rec = {"ev": ev, "rid": int(rid), "t": float(t), **fields}
        self.events.append(rec)
        if self._f is not None:
            body = json.dumps(rec, separators=(",", ":"), sort_keys=True)
            self._f.write(f"{zlib.crc32(body.encode()):08x} {body}\n")
            self._f.flush()
        if self.tel.enabled:
            self.tel.counter("journal.events", ev=ev).inc()
        return rec

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "RequestJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @staticmethod
    def read(path: str) -> list[dict]:
        """Parse a journal file, stopping at the first torn or corrupt
        line (crash consistency: append-only means everything before a
        bad line is intact; everything after it never happened)."""
        out: list[dict] = []
        with open(path, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split(" ", 1)
                if len(parts) != 2:
                    break
                crc, body = parts
                try:
                    if int(crc, 16) != zlib.crc32(body.encode()):
                        break
                    rec = json.loads(body)
                except ValueError:
                    break
                if not isinstance(rec, dict) or rec.get("ev") not in \
                        EVENT_KINDS:
                    break
                out.append(rec)
        return out


# ------------------------------------------------------------- replay --


@dataclasses.dataclass(frozen=True)
class ReplayItem:
    """One admitted-but-unfinished request, ready to `restore`."""
    rid: int
    request: Request
    priority: Priority
    deadline_at: Optional[float]
    generated: np.ndarray            # journaled tokens (may be empty)


@dataclasses.dataclass
class RecoveryPlan:
    """What a journal implies: pre-crash resolutions and replay work."""
    finished: dict                   # rid -> (status, tokens)
    replay: list                     # [ReplayItem], submission order


def recovery_plan(events: list[dict]) -> RecoveryPlan:
    """Fold journal events into finished results + replay items.

    ``chunk`` records are concatenated per rid (each holds only the
    tokens newly published that round).  A rid with a ``finish`` record
    resolved before the crash; a rid whose journaled tokens already
    exhaust its budget or end at its EOS id lost only the finish record
    and resolves directly as served — replaying it would have nothing
    left to decode.  Everything else replays from prompt + journaled
    tokens under its original rid.
    """
    subs: dict[int, dict] = {}
    chunks: dict[int, list[int]] = {}
    finished: dict[int, tuple] = {}
    for rec in events:
        rid, ev = rec["rid"], rec["ev"]
        if ev == "submit":
            subs[rid] = rec
        elif ev == "chunk":
            chunks.setdefault(rid, []).extend(rec["toks"])
        elif ev == "finish":
            toks = np.asarray(chunks.get(rid, []), np.int32)
            finished[rid] = (rec["status"], toks[:rec["n"]])
    replay: list[ReplayItem] = []
    for rid, rec in subs.items():
        if rid in finished:
            continue
        gen = np.asarray(chunks.get(rid, []), np.int32)
        if len(gen) and (len(gen) >= rec["max_new"]
                         or int(gen[-1]) == rec["eos"]):
            finished[rid] = ("served", gen)     # finish record was the
            continue                            # only thing the crash ate
        req = Request(tokens=np.asarray(rec["prompt"], np.int32),
                      max_new_tokens=int(rec["max_new"]),
                      eos_id=int(rec["eos"]),
                      temperature=float(rec["temp"]))
        replay.append(ReplayItem(rid, req, Priority[rec["prio"]],
                                 rec.get("deadline"), gen))
    replay.sort(key=lambda it: it.rid)          # original admission order
    return RecoveryPlan(finished=finished, replay=replay)


def recover(fe, journal_or_events, *, drive=None) -> dict:
    """Reconstruct a crashed frontend's requests into ``fe`` and drain.

    ``journal_or_events`` is the crashed run's `RequestJournal` (or its
    raw event list / a `RequestJournal.read` result).  Every replay item
    is `restore`d under its original rid, the frontend is drained
    (``drive`` overrides ``fe.run()`` for virtual-clock loops), and
    the results merge with the pre-crash finishes.  The merge asserts
    the two sets are disjoint — exactly-once completion delivery — and
    covers every journaled submission, so the return maps each admitted
    rid to its (status, tokens) with a crash-free run's greedy tokens.
    """
    events = (journal_or_events.events
              if isinstance(journal_or_events, RequestJournal)
              else list(journal_or_events))
    plan = recovery_plan(events)
    tel = fe.tel
    with tel.span("recovery.replay", track="recovery", cat="recovery",
                  n_replay=len(plan.replay),
                  n_finished=len(plan.finished)):
        for item in plan.replay:
            fe.restore(item.rid, item.request, item.priority,
                       deadline_at=item.deadline_at,
                       generated=item.generated)
        out = drive() if drive is not None else fe.run()
    if tel.enabled:
        tel.counter("recovery.replayed").inc(len(plan.replay))
        tel.counter("recovery.recovered_finished").inc(len(plan.finished))
    merged = dict(plan.finished)
    for rid, res in out.items():
        if rid in merged:
            raise RuntimeError(
                f"rid {rid} finished both before and after the crash")
        merged[rid] = res
    return merged
