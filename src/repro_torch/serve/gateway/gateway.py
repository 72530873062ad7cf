"""Event-driven multi-client offload gateway.

The port of ``repro.serve.gateway.gateway``.  Each Remote-NN batch is one
host->device copy of the fixed-width feature batch and of the Local-NN
logits, one ``remote_forward`` on the params' device (TF32 off), and one
device->host copy of the logits.  Simulated timestamps never come from
the device or from host timing: only the ``gateway.codec_ms`` histogram
and ``GatewayReport.wall_s`` read the wall clock.

Closes the device<->cloud loop the per-image offload runtime leaves open:
N simulated weak devices (`Fleet`) push LZW-compressed feature payloads
over lossy rate-limited links (`Channel`) into a gateway that batches
arrivals into fixed-width Remote-NN inference calls and returns combined
logits with per-request end-to-end latency and device-energy accounting.

Time is discrete-event simulated on the serving stack's shared
`repro_torch.serve.event_loop.EventLoop` (a (time, prio, seq) heap; prio
breaks same-instant ties toward the earliest deadline and seq keeps the
rest FIFO, so runs are deterministic — the same loop class drives the
streaming frontend's overload benches, so gateway arrivals and decode
rounds share one clock discipline), while the Remote-NN logits are
*actually computed*: arriving payloads are LZW-decoded, batch-bit-
unpacked, dequantized and run through `remote_forward` over a
fixed-width feature slot pool — the continuous scheduler's admit/evict
discipline applied to feature batches, with one batch shape per pool
width (zero rows pad a partial batch).  Requests admit into free
`SlotPool` slots when a batch launches and release them when it
completes; arrivals beyond the pool width queue for the next launch.

Failure posture (`repro_torch.serve.faults` wires the faults in): every
layer responds instead of hanging, stepping down a degradation ladder —

  * served    — payload decoded, Remote NN + combine (the clean path);
  * degraded  — the payload arrived corrupted (`PayloadCorruptionError`
    or a framing-length mismatch): the gateway zero-fills every
    offloaded channel (`control.ERASED`, the keep-prefix masking taken
    to its floor) and still serves Remote NN + combine — accuracy pays,
    not a round trip;
  * shed      — the payload arrived, but its deadline passed before (or
    lapses at) batch admission: the gateway drops it and the device uses
    its Local-NN logits;
  * rejected  — the payload arrived but the gateway's admission queue
    was already at ``GatewayConfig.max_queue``: overload is refused at
    the door instead of buffered without bound, and the device falls
    back to its Local-NN logits immediately (with an unbounded queue —
    the default — this rung never fires and every run is bit-identical
    to the pre-admission-control gateway);
  * fallback  — the radio gave up (retry budget or deadline exhausted on
    a dark link): the device serves its own Local-NN logits, bit-
    identical to the standalone local path, the moment it stops retrying.

Requests carrying deadlines admit earliest-deadline-first; with none set
admission is FIFO and every code path is bit-identical to the fault-free
gateway.  With no SLO set every client stays on the static rate profile
and the gateway's logits are bit-identical to `run_offload_inference` on
each request's image alone (tested); with an SLO, per-client
`RateController`s trade quantization bits / offloaded-channel fraction
against the measured latency.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch import fp32_math
from repro_torch.compress.lzw import (
    PayloadCorruptionError, lzw_decode, packed_nbytes, unpack_indices_batch,
)
from repro_torch.configs.agilenn_cifar import AgileNNConfig
from repro_torch.core.agile import remote_forward
from repro_torch.serve import telemetry as _telemetry
from repro_torch.serve.device_model import DeviceModel
from repro_torch.serve.event_loop import EventLoop
from repro_torch.serve.gateway.fleet import DeviceClient, Fleet, Payload
from repro_torch.serve.scheduler import SlotPool
from repro_torch.serve.telemetry import exponential

_MS_BOUNDS = exponential(0.25, 2.0, 16)    # 0.25 ms .. ~8.2 s


@dataclasses.dataclass(frozen=True)
class GatewayConfig:
    batch_width: int = 8        # Remote-NN feature slot pool width
    batch_window_s: float = 2e-3  # idle gateway waits this long after an
                                  # arrival for the pool to fill
    max_queue: "int | None" = None  # admission-queue bound: an arrival
                                    # finding this many payloads already
                                    # queued is *rejected* (typed ladder
                                    # rung above shed) and the device
                                    # falls back to Local-NN immediately.
                                    # None (default) = unbounded, bit-
                                    # identical to the pre-bound gateway

    def __post_init__(self):
        if self.batch_width < 1:
            raise ValueError(f"GatewayConfig.batch_width must be >= 1 "
                             f"(got {self.batch_width!r})")
        if self.batch_window_s < 0:
            raise ValueError(f"GatewayConfig.batch_window_s must be >= 0 "
                             f"(got {self.batch_window_s!r})")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(f"GatewayConfig.max_queue must be >= 1 or "
                             f"None (got {self.max_queue!r})")


@dataclasses.dataclass
class RequestTrace:
    client: int
    req: int
    channel: str
    bits: int
    keep: int                  # transmitted remote channels
    payload_bytes: int
    attempts: int
    t_born: float              # inference requested on-device
    t_sent: float              # local compute done, radio starts
    t_arrive: float            # payload lands at the gateway
    t_serve: float             # admitted into a Remote-NN batch
    t_done: float              # combined logits back at the device
    e2e_s: float
    energy_j: float
    logits: np.ndarray
    pred: int
    label: int
    status: str = "served"     # served | degraded | shed | rejected |
                               # fallback
    deadline_missed: bool = False


@dataclasses.dataclass
class GatewayReport:
    traces: list[RequestTrace]
    wall_s: float
    sim_s: float
    n_clients: int

    def e2e_ms(self) -> np.ndarray:
        return np.asarray([t.e2e_s for t in self.traces]) * 1e3

    def latency_percentile_ms(self, q: float) -> float:
        return float(np.percentile(self.e2e_ms(), q))

    @property
    def clients_per_s(self) -> float:
        """Sustained client inferences per *wall* second — the throughput
        of the real pipeline (payload codecs, event loop, batched
        Remote-NN calls), not of the simulated clock."""
        return len(self.traces) / self.wall_s

    @property
    def device_energy_mj(self) -> float:
        return float(np.mean([t.energy_j for t in self.traces])) * 1e3

    def status_rate(self, *statuses: str) -> float:
        return float(np.mean([t.status in statuses for t in self.traces]))

    @property
    def fallback_rate(self) -> float:
        """Fraction of requests resolved by Local-NN logits alone (the
        radio gave up, or the gateway shed a missed deadline)."""
        return self.status_rate("fallback", "shed")

    @property
    def degraded_rate(self) -> float:
        """Fraction served with zero-filled (erased) payload channels."""
        return self.status_rate("degraded")

    @property
    def rejected_rate(self) -> float:
        """Fraction refused at the gateway's admission bound (the
        overload rung: the queue was full when the payload landed)."""
        return self.status_rate("rejected")

    @property
    def deadline_miss_rate(self) -> float:
        return float(np.mean([t.deadline_missed for t in self.traces]))

    def summary(self) -> dict:
        by_channel: dict[str, list[float]] = {}
        for t in self.traces:
            by_channel.setdefault(t.channel, []).append(t.e2e_s * 1e3)
        return {
            "clients": self.n_clients,
            "requests": len(self.traces),
            "e2e_p50_ms": self.latency_percentile_ms(50),
            "e2e_p99_ms": self.latency_percentile_ms(99),
            "clients_per_s": self.clients_per_s,
            "device_energy_mj": self.device_energy_mj,
            "payload_bytes_mean": float(np.mean(
                [t.payload_bytes for t in self.traces])),
            "attempts_mean": float(np.mean(
                [t.attempts for t in self.traces])),
            "bits_mean": float(np.mean([t.bits for t in self.traces])),
            "accuracy": float(np.mean(
                [t.pred == t.label for t in self.traces])),
            "fallback_rate": self.fallback_rate,
            "degraded_rate": self.degraded_rate,
            "rejected_rate": self.rejected_rate,
            "deadline_miss_rate": self.deadline_miss_rate,
            "sim_s": self.sim_s,
            "p50_ms_by_channel": {k: float(np.percentile(v, 50))
                                  for k, v in sorted(by_channel.items())},
        }


@dataclasses.dataclass
class _InFlight:
    payload: Payload
    client: DeviceClient
    t_born: float
    t_start: float
    t_sent: float
    t_arrive: float
    attempts: int
    energy_j: float
    t_serve: float = 0.0       # stamped when the batch launches
    slot: int = -1             # pool slot (= Remote-NN batch row) occupied
    deadline: float = math.inf  # absolute; heap/admission priority
    status: str = "served"     # downgraded to "degraded" on erasure
    delivery: object = None    # the radio's Delivery (attempt windows for
                               # telemetry hop spans)


class OffloadGateway:
    def __init__(self, cfg: AgileNNConfig, params, fleet: Fleet,
                 gw: "GatewayConfig | None" = None, *,
                 server: "DeviceModel | None" = None, faults=None,
                 telemetry=None):
        assert fleet.cfg is cfg or fleet.cfg == cfg
        self.cfg = cfg
        self.params = params
        self.fleet = fleet
        self.gw = gw or GatewayConfig()
        self.server = server or DeviceModel()
        self.faults = faults               # serve.faults.FaultInjector
        self.tel = telemetry if telemetry is not None \
            else _telemetry.default()
        self._slots = SlotPool(self.gw.batch_width)

    # ------------------------------------------------------ remote batch --
    def _batch_logits(self, batch: list[_InFlight]) -> np.ndarray:
        """Decode payloads -> dequantize -> one fixed-width Remote-NN +
        combine call.  Rows are grouped by radio framing so the bit
        unpack runs vectorized per group; channels beyond a payload's
        importance prefix stay zero.  A payload that fails to decode
        (corruption) keeps its WHOLE row zero — the `control.ERASED`
        floor of the masking ladder — and is marked degraded; the call
        still serves it."""
        t_codec = self.tel.clock() if self.tel.enabled else 0.0
        W = self.gw.batch_width
        fh, Cr = self.fleet.feat_hw, self.fleet.n_remote
        deq = np.zeros((W, fh, fh, Cr), np.float32)
        ll = np.zeros((W, self.fleet.local_logits.shape[1]), np.float32)
        groups: dict[tuple, list[_InFlight]] = {}
        for item in batch:
            p = item.payload
            ll[item.slot] = self.fleet.local_logits[item.client.row0 + p.req]
            groups.setdefault((p.bits, p.keep, p.count), []).append(item)
        for (bits, keep, count), members in groups.items():
            ok, packed = [], []
            expect = packed_nbytes(bits, count)
            for it in members:
                try:
                    data = lzw_decode(it.payload.codes)
                except PayloadCorruptionError:
                    it.status = "degraded"
                    continue
                if len(data) != expect:    # framing mismatch: erased too
                    it.status = "degraded"
                    continue
                ok.append(it)
                packed.append(data)
            if not ok:
                continue
            idx = unpack_indices_batch(packed, bits, count)
            vals = self.fleet.centers_for(bits)[idx]
            rows = [it.slot for it in ok]
            deq[rows, :, :, :keep] = vals.reshape(-1, fh, fh, keep)
        if self.tel.enabled:
            # wall cost of the gateway-side codec (LZW decode + unpack +
            # dequantize) — the device-side encode is simulated time,
            # folded into the device_compute span
            self.tel.histogram("gateway.codec_ms", bounds=_MS_BOUNDS) \
                .observe((self.tel.clock() - t_codec) * 1e3)
        dev = self.fleet.device
        with fp32_math():
            out = remote_forward(self.cfg, self.params,
                                 torch.from_numpy(deq).to(dev),
                                 torch.from_numpy(ll).to(dev))
        return out.cpu().numpy()

    # -------------------------------------------------------- telemetry --
    def _note_request(self, item: _InFlight, t_done: float, status: str,
                      *, remote: bool) -> None:
        """Emit one resolved request's hop spans (simulated timestamps —
        no clock reads) and counters.  The spans tile the request's e2e
        window: device queue/compute, each radio attempt with its
        backoff gap, uplink propagation, gateway queue wait, the remote
        slot-pool batch, and the response leg."""
        tel = self.tel
        if not tel.enabled:
            return
        p = item.payload
        track = f"c{item.client.index} r{p.req}"
        add = tel.trace.add
        add("request", item.t_born, t_done, track=track, cat="gateway",
            status=status, client=item.client.index, req=p.req,
            channel=item.client.spec.channel.name)
        if item.t_start > item.t_born:
            add("device_queue", item.t_born, item.t_start, track=track,
                cat="gateway")
        add("device_compute", item.t_start, item.t_sent, track=track,
            cat="gateway", payload_bytes=p.nbytes, bits=p.bits, keep=p.keep)
        d = item.delivery
        prev = item.t_sent
        if d is not None:
            for k, (a0, a1, lost) in enumerate(d.attempt_log):
                if a0 > prev:
                    add("radio_backoff", prev, a0, track=track,
                        cat="gateway", before_attempt=k + 1)
                add("radio_attempt", a0, a1, track=track, cat="gateway",
                    attempt=k + 1, lost=lost)
                prev = a1
            if d.delivered and item.t_arrive > prev:
                add("uplink", prev, item.t_arrive, track=track,
                    cat="gateway")
        if remote:
            prop = item.client.spec.channel.propagation_s
            if item.t_serve > item.t_arrive:
                add("queue_wait", item.t_arrive, item.t_serve, track=track,
                    cat="gateway")
            add("remote_batch", item.t_serve, t_done - prop, track=track,
                cat="gateway", slot=item.slot)
            add("response", t_done - prop, t_done, track=track,
                cat="gateway")
        m = tel.metrics
        m.counter("gateway.requests", status=status).inc()
        m.counter("gateway.radio_attempts").inc(item.attempts)
        m.histogram("gateway.e2e_ms", bounds=_MS_BOUNDS).observe(
            (t_done - item.t_born) * 1e3)

    # -------------------------------------------------------- event loop --
    def run(self, loop: "EventLoop | None" = None) -> GatewayReport:
        fleet, gw, faults = self.fleet, self.gw, self.faults
        t_wall = time.perf_counter()
        loop = loop if loop is not None else EventLoop()
        push = loop.push

        def born_at(client: int, j: int) -> float:
            """Request j's arrival instant, mapped through any scripted
            `ArrivalBurst` stampede (identity with no faults)."""
            t = float(fleet.clients[client].born[j])
            return faults.arrival_time(client, t) if faults is not None \
                else t

        next_req = [0] * len(fleet.clients)
        for c in fleet.clients:
            if c.spec.n_requests:
                push(born_at(c.index, 0), "dev", c.index)

        queue: list[_InFlight] = []
        busy = [False]
        epoch = [0]
        traces: list[RequestTrace] = []
        t_end = 0.0

        def resolve_local(item: _InFlight, t_done: float, status: str,
                          missed: bool) -> None:
            """Degradation floor: the device answers with its own
            Local-NN logits (bit-identical to the standalone local path —
            they were computed before the radio ever keyed up)."""
            nonlocal t_end
            p = item.payload
            row = item.client.row0 + p.req
            lrow = fleet.local_logits[row]
            e2e = t_done - item.t_born
            item.client.controller.observe(e2e)
            traces.append(RequestTrace(
                client=item.client.index, req=p.req,
                channel=item.client.spec.channel.name,
                bits=p.bits, keep=p.keep, payload_bytes=p.nbytes,
                attempts=item.attempts, t_born=item.t_born,
                t_sent=item.t_sent, t_arrive=item.t_arrive,
                t_serve=t_done, t_done=t_done, e2e_s=e2e,
                energy_j=item.energy_j, logits=lrow.copy(),
                pred=int(np.argmax(lrow)),
                label=int(fleet.labels[row]),
                status=status, deadline_missed=missed))
            t_end = max(t_end, t_done)
            self._note_request(item, t_done, status, remote=False)

        def start_batch(t0: float) -> None:
            epoch[0] += 1                    # pending window flushes lapse
            # shed-on-miss: a queued request whose deadline has lapsed by
            # launch time is pointless to serve — resolve it as a local
            # fallback (the device stopped waiting at its deadline)
            missed = [it for it in queue if it.deadline <= t0]
            if missed:
                queue[:] = [it for it in queue if it.deadline > t0]
                for it in missed:
                    resolve_local(it, it.deadline, "shed", True)
                if not queue:
                    return
            if any(it.deadline < math.inf for it in queue):
                queue.sort(key=lambda it: it.deadline)   # EDF; stable ->
            free = self._slots.free()                    # FIFO inside ties
            take, queue[:] = queue[:len(free)], queue[len(free):]
            for slot, item in zip(free, take):
                self._slots.acquire(slot, item)
                item.slot = slot             # slot id IS the batch row
            logits = self._batch_logits(take)
            for item in take:
                item.t_serve = t0
            service = self.server.server_time(
                len(take) * fleet.remote_macs)
            if faults is not None:           # stalled slot pool: the batch
                service += faults.server_stall_extra(t0)   # holds its slots
            if self.tel.enabled:
                self.tel.histogram(
                    "gateway.batch_size",
                    bounds=tuple(float(w) for w in
                                 range(1, gw.batch_width + 1))
                ).observe(len(take))
                self.tel.trace.add("remote_batch", t0, t0 + service,
                                   track="gateway", cat="gateway",
                                   batch=len(take))
            busy[0] = True
            push(t0 + service, "serve", (take, logits))

        while loop:
            t, kind, data = loop.pop()
            if kind == "dev":
                c = fleet.clients[data]
                j = next_req[data]
                born = born_at(data, j)
                payload = fleet.make_payload(c, j)   # profile at send time
                t_compute = fleet.compute_time(c)
                if faults is not None:
                    t_compute += faults.device_stall_extra(data, t)
                t_sent = t + t_compute
                deadline = (born + c.spec.deadline_ms * 1e-3
                            if c.spec.deadline_ms is not None else math.inf)
                d = c.channel.transmit(
                    payload.nbytes, t_sent,
                    deadline_s=None if deadline == math.inf else deadline,
                    link=faults.link(data) if faults is not None else None)
                energy = (c.device.p_cpu_w * t_compute
                          + c.device.p_tx_w * d.airtime_s)
                item = _InFlight(
                    payload=payload, client=c, t_born=born, t_start=t,
                    t_sent=t_sent, t_arrive=d.arrive_s,
                    attempts=d.attempts, energy_j=energy, deadline=deadline,
                    delivery=d)
                if faults is not None and d.delivered:
                    bad = faults.corrupt(data, t_sent, payload.codes)
                    if bad is not None:
                        item.payload = dataclasses.replace(payload,
                                                           codes=bad)
                if d.delivered:
                    push(d.arrive_s, "recv", item,
                         prio=deadline if deadline < math.inf else 0.0)
                else:
                    # radio gave up (dark link or deadline): Local-NN
                    # fallback at the moment it stopped retrying
                    resolve_local(item, d.device_free_s, "fallback",
                                  d.expired)
                next_req[data] = j + 1
                if j + 1 < c.spec.n_requests:
                    push(max(d.device_free_s, born_at(data, j + 1)),
                         "dev", data)
            elif kind == "recv":
                if data.deadline <= t:       # landed past its deadline:
                    resolve_local(data, data.deadline, "shed", True)
                    continue                 # the device already gave up
                if gw.max_queue is not None and len(queue) >= gw.max_queue:
                    # admission bound: overload is refused at the door —
                    # the device hears "rejected" now and serves its own
                    # Local-NN logits instead of parking in an unbounded
                    # backlog whose deadline it would miss anyway
                    resolve_local(data, t, "rejected", False)
                    continue
                queue.append(data)
                if self.tel.enabled:
                    self.tel.gauge("gateway.queue_depth").set(len(queue))
                if not busy[0]:
                    if len(queue) >= gw.batch_width:
                        start_batch(t)
                    else:
                        push(t + gw.batch_window_s, "flush", epoch[0])
            elif kind == "flush":
                if data == epoch[0] and not busy[0] and queue:
                    start_batch(t)
            elif kind == "serve":
                batch, logits = data
                busy[0] = False
                for item in batch:
                    self._slots.release(item.slot)
                    t_resp = t + item.client.spec.channel.propagation_s
                    push(t_resp, "resp", (item, logits[item.slot]))
                if queue:                    # backlog built up while busy
                    start_batch(t)
            elif kind == "resp":
                item, lrow = data
                e2e = t - item.t_born
                item.client.controller.observe(e2e)
                p = item.payload
                row = item.client.row0 + p.req
                traces.append(RequestTrace(
                    client=item.client.index, req=p.req,
                    channel=item.client.spec.channel.name,
                    bits=p.bits, keep=p.keep, payload_bytes=p.nbytes,
                    attempts=item.attempts, t_born=item.t_born,
                    t_sent=item.t_sent, t_arrive=item.t_arrive,
                    t_serve=item.t_serve, t_done=t, e2e_s=e2e,
                    energy_j=item.energy_j, logits=lrow.copy(),
                    pred=int(np.argmax(lrow)),
                    label=int(self.fleet.labels[row]),
                    status=item.status,
                    deadline_missed=t > item.deadline))
                t_end = max(t_end, t)
                self._note_request(item, t, item.status, remote=True)

        t_begin = min(born_at(c.index, 0) for c in fleet.clients
                      if c.spec.n_requests)
        return GatewayReport(traces=traces,
                             wall_s=time.perf_counter() - t_wall,
                             sim_s=float(t_end - t_begin),
                             n_clients=len(fleet.clients))
