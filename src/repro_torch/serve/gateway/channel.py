"""Lossy rate-limited link between a weak device and the offload gateway.

A copy of ``repro.serve.gateway.channel`` (numpy only).

Payload bytes translate into *time* instead of being free: every transmit
attempt pays the serialization delay (bytes * 8 / bandwidth) plus
propagation and uniform jitter; attempts are lost i.i.d. with
``drop_prob`` and retried after a retransmission timeout that backs off
exponentially (``backoff_mult``/``backoff_max_s``, optional jitter), so a
degraded channel stretches both the request's gateway-arrival time and
the radio-on seconds the device pays transmit energy for.

Delivery is *not* guaranteed.  Under the benign i.i.d. loss model the
final attempt still delivers (the app layer keeps retrying; ``attempts``
records what the retries cost), which keeps clean simulations fully
accounted.  But a fault-injected link (`repro_torch.serve.faults`) can force
losses — a blackout or a Gilbert–Elliott bad state drops every attempt —
and a per-request ``deadline_s`` bounds how long the radio keeps trying;
when the retry budget or the deadline is exhausted `transmit` returns
``delivered=False`` and the caller degrades gracefully (Local-NN
fallback) instead of spinning.  ``max_attempts=0`` means "app retries
forever", but the channel still caps the loop (`RETRY_SAFETY_CAP`) so a
100%-loss link terminates the discrete-event loop as a failed delivery
rather than hanging it.

Presets mirror the paper's §7 links (ESP-WROOM WiFi at UDP 6 Mbps, a
270 kbps narrowband option) plus a lossy-WiFi variant for the rate
controller to push against.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

# attempts ceiling when max_attempts == 0 ("retry forever"): a blackout
# must end the transmit as a failed delivery, never hang the event loop
RETRY_SAFETY_CAP = 64


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    name: str = "wifi"
    bandwidth_bps: float = 6e6          # ESP-WROOM WiFi, UDP (paper §7)
    propagation_s: float = 2e-3
    jitter_s: float = 0.0               # uniform [0, jitter_s) per attempt
    drop_prob: float = 0.0              # i.i.d. per-attempt loss
    retransmit_timeout_s: float = 20e-3
    max_attempts: int = 8               # 0 = unbounded (RETRY_SAFETY_CAP
                                        # still bounds the transmit loop)
    backoff_mult: float = 1.0           # wait_i = timeout * mult**(i-1) ...
    backoff_max_s: float = math.inf     # ... capped here (1.0 = fixed wait)
    backoff_jitter: float = 0.0         # fraction of the wait drawn
                                        # uniformly on top (decorrelates
                                        # synchronized retries)

    def __post_init__(self):
        def bad(field, why):
            raise ValueError(f"ChannelConfig.{field} {why} "
                             f"(got {getattr(self, field)!r})")
        if not self.bandwidth_bps > 0:
            bad("bandwidth_bps", "must be > 0")
        if self.propagation_s < 0:
            bad("propagation_s", "must be >= 0")
        if self.jitter_s < 0:
            bad("jitter_s", "must be >= 0")
        if not 0.0 <= self.drop_prob <= 1.0:
            bad("drop_prob", "must be a probability in [0, 1]")
        if not self.retransmit_timeout_s > 0:
            bad("retransmit_timeout_s", "must be > 0")
        if self.max_attempts < 0:
            bad("max_attempts", "must be >= 0 (0 = retry forever)")
        if self.backoff_mult < 1.0:
            bad("backoff_mult", "must be >= 1.0")
        if not self.backoff_max_s > 0:
            bad("backoff_max_s", "must be > 0")
        if self.backoff_jitter < 0:
            bad("backoff_jitter", "must be >= 0")


WIFI_UDP = ChannelConfig()
NARROWBAND = ChannelConfig(name="narrowband", bandwidth_bps=270e3,
                           propagation_s=25e-3)
LOSSY_WIFI = ChannelConfig(name="lossy-wifi", drop_prob=0.15, jitter_s=3e-3)


@dataclasses.dataclass(frozen=True)
class Delivery:
    arrive_s: float          # payload reaches the gateway (gave up: = t_free)
    device_free_s: float     # radio released (device may start next request)
    airtime_s: float         # radio actively transmitting (tx energy)
    attempts: int
    delivered: bool = True   # False: retry budget / deadline exhausted
    expired: bool = False    # True: the per-request deadline stopped the
                             # retries (a deadline miss, not a dead link)
    attempt_log: tuple = ()  # per-attempt (t_start, t_end, lost) windows —
                             # the gaps between them are the backoff waits;
                             # telemetry turns each into a radio span


class Channel:
    """One device's link; owns a seeded RNG so fleet runs are
    deterministic and two same-seed channels replay identical loss/jitter
    sequences.  Fault randomness lives in the injector's per-client RNGs
    (`faults.LinkFaultView`), so attaching one never perturbs this
    channel's own draw sequence — a fault-free run is bit-identical with
    or without an (idle) injector."""

    def __init__(self, cfg: ChannelConfig, seed: int = 0):
        self.cfg = cfg
        self._rng = np.random.RandomState(seed)

    def serialize_s(self, nbytes: int) -> float:
        return nbytes * 8.0 / self.cfg.bandwidth_bps

    def _retry_wait(self, attempts: int) -> float:
        """Backoff before retry #attempts (the default mult=1.0 keeps the
        seed's fixed-timeout arithmetic bit-exact)."""
        cfg = self.cfg
        if cfg.backoff_mult == 1.0:
            wait = cfg.retransmit_timeout_s
        else:
            wait = min(cfg.retransmit_timeout_s
                       * cfg.backoff_mult ** (attempts - 1),
                       cfg.backoff_max_s)
        if cfg.backoff_jitter > 0:
            wait += float(self._rng.uniform(0.0, cfg.backoff_jitter * wait))
        return wait

    def transmit(self, nbytes: int, t_send: float, *,
                 deadline_s: "float | None" = None,
                 link=None) -> Delivery:
        """Push one payload; returns when it lands or the radio gives up.

        deadline_s: absolute simulated time after which no further retry
        is attempted (the in-flight attempt still completes).
        link: a `faults.LinkFaultView` forcing losses / scaling bandwidth.
        """
        cfg = self.cfg
        ser = self.serialize_s(nbytes)
        cap = cfg.max_attempts if cfg.max_attempts > 0 else RETRY_SAFETY_CAP
        t, attempts, airtime, scaled = t_send, 0, 0.0, False
        delivered, expired = True, False
        log: list = []
        while True:
            attempts += 1
            t_att = t                    # this attempt's on-air window start
            ser_i = ser
            if link is not None:
                scale = link.bandwidth_scale(t)
                if scale != 1.0:
                    ser_i, scaled = ser / scale, True
            t += ser_i
            airtime += ser_i
            jitter = (float(self._rng.uniform(0.0, cfg.jitter_s))
                      if cfg.jitter_s > 0 else 0.0)
            if link is not None and link.attempt_lost(t):
                # forced loss: no final-attempt rescue — a dark link
                # delivers nothing, however many times the app retries
                log.append((t_att, t, True))
                if attempts >= cap:
                    delivered = False
                    break
            elif (attempts >= cfg.max_attempts > 0
                    or float(self._rng.uniform()) >= cfg.drop_prob):
                log.append((t_att, t, False))
                break
            elif attempts >= cap:        # max_attempts == 0 under benign
                log.append((t_att, t, True))
                delivered = False        # 100% loss: the safety cap ends
                break                    # the loop as a failed delivery
            else:
                log.append((t_att, t, True))
            wait = self._retry_wait(attempts)
            if deadline_s is not None and t + wait >= deadline_s:
                delivered, expired = False, True   # no retry can land in time
                break
            t += wait
        if delivered and deadline_s is not None and t >= deadline_s:
            # the attempt itself overran the deadline (a slow link's
            # serialization alone can): a late arrival is a deadline miss,
            # not a delivery — report it like a stopped retry so the
            # caller degrades instead of pushing a stale payload upstream
            delivered, expired = False, True
        # fault-free fast path keeps the seed's closed-form airtime
        airtime = airtime if scaled else attempts * ser
        if not delivered:
            return Delivery(arrive_s=t, device_free_s=t, airtime_s=airtime,
                            attempts=attempts, delivered=False,
                            expired=expired, attempt_log=tuple(log))
        return Delivery(arrive_s=t + cfg.propagation_s + jitter,
                        device_free_s=t, airtime_s=airtime,
                        attempts=attempts, attempt_log=tuple(log))
