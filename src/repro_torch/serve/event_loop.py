"""The serving stack's one discrete-event clock.

A copy of ``repro.serve.event_loop``: pure Python, no tensors.

Before this module the stack kept two clocks: the offload gateway ran a
private ``(time, prio, seq)`` heap inside its ``run()`` loop, and the
continuous-batching scheduler's overlap loop advanced an implicit
"round" clock of its own — gateway arrivals, decode rounds, deadline
evictions and stream callbacks could never be ordered against each
other.  `EventLoop` is that heap lifted out and shared: the gateway
pushes its arrival/serve/response events here, the streaming
frontend's simulated client loop pushes request arrivals and scheduler
rounds here, and both hand the same ``now`` to the scheduler as its
deadline clock — so one timeline orders admission, decode, eviction and
token delivery.

Ordering contract (identical to the gateway's historical heap, which
keeps every seeded simulation bit-identical through the refactor):
events pop in ``(time, prio, seq)`` order — time first, then priority
(the gateway uses the earliest deadline; 0.0 when none, so deadline-free
runs are untouched), then a monotone sequence number that keeps
same-instant same-priority events FIFO.  Runs are therefore
deterministic: the heap never compares payloads.
"""
from __future__ import annotations

import heapq
import itertools


class EventLoop:
    """A ``(time, prio, seq)`` discrete-event heap with a shared clock.

    ``now`` holds the timestamp of the most recently popped event (the
    simulation's current instant); passing ``lambda: loop.now`` as a
    scheduler's ``clock`` puts request deadlines on the same timeline as
    the events that age them.
    """

    def __init__(self, t0: float = 0.0):
        self.now = float(t0)
        self._heap: list[tuple] = []
        self._seq = itertools.count()

    def push(self, t: float, kind: str, data, prio: float = 0.0) -> None:
        heapq.heappush(self._heap, (t, prio, next(self._seq), kind, data))

    def pop(self) -> tuple[float, str, object]:
        """Pop the next event and advance ``now`` to its timestamp."""
        t, _, _, kind, data = heapq.heappop(self._heap)
        self.now = t
        return t, kind, data

    def peek_time(self) -> "float | None":
        return self._heap[0][0] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)
