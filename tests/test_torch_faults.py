"""The port's fault injection and degradation ladder on the CPU.

Against the JAX package, on bridged ``PRNGKey(0)`` params at
``gateway_demo_config()``: the pinned runs of ``benchmarks/faults.py``
(16 clients x 6, deadline 150 ms, ``FaultInjector(seed=7)``: chaos,
total blackout, stampede) give exactly equal request traces and
``faults.*`` row values, logits within 1e-4 abs + rel; one injector's
decisions (arrivals, losses, bandwidth, corruption, stalls) replay JAX's
exactly.

Within the port: config validation, the channel's retry / backoff /
deadline closed forms, an idle injector bit-identical to none, a total
blackout resolving every request as a Local-NN fallback bit-identical to
the local path, corruption degrading to the erased floor, EDF admission,
slot-pool churn without leaks or double assignment, and the gateway's
pool empty after chaos."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.agilenn_cifar import gateway_demo_config as jax_config  # noqa: E402
from repro.core.agile import init_agile_params as jax_init  # noqa: E402
from repro.serve import faults as jfaults  # noqa: E402
from repro.serve import gateway as jg  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.agilenn_cifar import gateway_demo_config  # noqa: E402
from repro_torch.core.agile import agile_forward, remote_forward  # noqa: E402
from repro_torch.serve import faults as tfaults  # noqa: E402
from repro_torch.serve import gateway as tg  # noqa: E402
from repro_torch.serve.gateway.channel import RETRY_SAFETY_CAP  # noqa: E402
from repro_torch.serve.scheduler import SlotError, SlotPool  # noqa: E402

JCFG, CFG = jax_config(), gateway_demo_config()
LOGIT_TOL = 1e-4          # as tests/test_torch_gateway.py: 2-channel GroupNorm
PIN_CLIENTS, PIN_REQS, PIN_DEADLINE_MS = 16, 6, 150.0     # benchmarks/faults.py
LADDER = {"served", "degraded", "shed", "rejected", "fallback"}
TRACE_FIELDS = ("client", "req", "channel", "bits", "keep", "payload_bytes",
                "attempts", "t_born", "t_sent", "t_arrive", "t_serve",
                "t_done", "e2e_s", "energy_j", "status", "deadline_missed")


@pytest.fixture(scope="module")
def params():
    jp = jax_init(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")


def trace_key(report):
    return [tuple(getattr(t, f) for f in TRACE_FIELDS) for t in report.traces]


def _schedules(f):
    """The three pinned schedules of benchmarks/faults.py, built from the
    faults module ``f`` of either package, with their gateway configs."""
    return {
        "chaos": ((f.Blackout(0.05, 0.25),
                   f.BurstLoss(0.0, 1.0, p_good_bad=0.2, p_bad_good=0.3),
                   f.PayloadCorruption(0.0, 1.0, prob=0.25),
                   f.GatewayStall(0.10, 0.30, stall_s=0.02)), {}),
        "blackout": ((f.Blackout(),), {}),
        "stampede": ((f.ArrivalBurst(factor=10.0),
                      f.LinkDegrade(bandwidth_scale=0.5, extra_loss=0.1)),
                     {"max_queue": 4}),
    }


@pytest.fixture(scope="module")
def pinned(params):
    jp, tp = params
    out = {}
    for name in ("chaos", "blackout", "stampede"):
        reports = []
        for g, f, cfg, p in ((jg, jfaults, JCFG, jp), (tg, tfaults, CFG, tp)):
            schedule, gw_kw = _schedules(f)[name]
            fleet = g.Fleet(cfg, p, g.mixed_fleet(
                PIN_CLIENTS, n_requests=PIN_REQS, deadline_ms=PIN_DEADLINE_MS), seed=0)
            reports.append(g.OffloadGateway(
                cfg, p, fleet, g.GatewayConfig(batch_width=8, **gw_kw),
                faults=f.FaultInjector(schedule, seed=7)).run())
        out[name] = tuple(reports)
    return out


def _faults_rows(chaos, blackout, stampede):
    """The eight ``faults.*`` rows of benchmarks/faults.py."""
    return {
        "faults.fallback_rate": chaos.fallback_rate,
        "faults.deadline_miss_rate": chaos.deadline_miss_rate,
        "faults.degraded_rate": chaos.degraded_rate,
        "faults.e2e_p99_ms": chaos.latency_percentile_ms(99),
        "faults.blackout_accuracy_proxy": blackout.summary()["accuracy"],
        "faults.stampede_rejected_rate": stampede.rejected_rate,
        "faults.stampede_served_rate": stampede.status_rate("served"),
        "faults.stampede_e2e_p99_ms": stampede.latency_percentile_ms(99),
    }


# ------------------------------------------------ pinned fault runs ---

@pytest.mark.parametrize("run", ["chaos", "blackout", "stampede"])
def test_pinned_fault_run_traces_exactly_equal_jax(pinned, run):
    jr, tr = pinned[run]
    assert len(tr.traces) == PIN_CLIENTS * PIN_REQS
    assert {t.status for t in tr.traces} <= LADDER
    assert trace_key(tr) == trace_key(jr)
    assert tr.sim_s == jr.sim_s


@pytest.mark.parametrize("run", ["chaos", "blackout", "stampede"])
def test_pinned_fault_run_logits_within_bar(pinned, run):
    """Logits within LOGIT_TOL; predictions equal unless JAX's top-2
    margin is within twice the bar (none is, today)."""
    jr, tr = pinned[run]
    swapped = []
    for a, b in zip(jr.traces, tr.traces):
        np.testing.assert_allclose(b.logits, a.logits, atol=LOGIT_TOL, rtol=LOGIT_TOL)
        if a.pred != b.pred:
            top = np.sort(a.logits)[-2:]
            margin = float(top[1] - top[0])
            assert margin <= 2 * (LOGIT_TOL + LOGIT_TOL * abs(float(top[1])))
            swapped.append((a.client, a.req, margin))
    print(f"{run}: predictions swapped at a near-tie: {swapped}")
    assert swapped == []


@pytest.mark.parametrize("row", [
    "faults.fallback_rate", "faults.deadline_miss_rate", "faults.degraded_rate",
    "faults.e2e_p99_ms", "faults.blackout_accuracy_proxy",
    "faults.stampede_rejected_rate", "faults.stampede_served_rate",
    "faults.stampede_e2e_p99_ms"])
def test_pinned_faults_rows_exactly_equal_jax(pinned, row):
    want = _faults_rows(*(pinned[r][0] for r in ("chaos", "blackout", "stampede")))
    got = _faults_rows(*(pinned[r][1] for r in ("chaos", "blackout", "stampede")))
    assert got[row] == want[row]


def test_pinned_runs_keep_the_benchmark_contract(pinned):
    """benchmarks/faults.py's asserts, on the port's runs."""
    chaos, blackout, stampede = (pinned[r][1] for r in ("chaos", "blackout",
                                                         "stampede"))
    assert blackout.fallback_rate == 1.0
    assert stampede.rejected_rate > 0.0
    assert chaos.degraded_rate > 0.0 and chaos.fallback_rate > 0.0


# ----------------------------------------------- injector decisions ---

def _decision_schedule(f):
    return (f.Blackout(0.3, 0.4, clients=(1,)),
            f.BurstLoss(0.0, 2.0, p_good_bad=0.3, p_bad_good=0.4, loss_good=0.05,
                        loss_bad=0.9),
            f.LinkDegrade(0.1, 1.5, bandwidth_scale=0.5, extra_loss=0.2,
                          clients=(0, 2)),
            f.DeviceStall(0.2, 0.6, stall_s=0.03, clients=(2,)),
            f.DeviceStall(0.5, 0.9, stall_s=0.01),
            f.GatewayStall(0.25, 0.7, stall_s=0.04),
            f.PayloadCorruption(0.0, 1.0, prob=0.6),
            f.ArrivalBurst(0.2, 0.8, factor=4.0, clients=(0, 1)))


@pytest.mark.parametrize("client", [0, 1, 2, 3])
def test_injector_decisions_match_jax(client):
    """One schedule and seed: arrival times, forced losses, bandwidth
    scales, stall extras and corrupted code streams exactly equal to
    JAX's injector, with another client's draws interleaved."""
    a = jfaults.FaultInjector(_decision_schedule(jfaults), seed=13)
    b = tfaults.FaultInjector(_decision_schedule(tfaults), seed=13)
    codes = list(np.random.RandomState(client).randint(0, 4000, 60))
    other = (client + 1) % 4
    for t in np.linspace(0.0, 1.9, 80):
        t = float(t)
        for inj in (a, b):
            inj.link(other).attempt_lost(t)
        assert a.arrival_time(client, t) == b.arrival_time(client, t)
        assert a.link(client).attempt_lost(t) == b.link(client).attempt_lost(t)
        assert (a.link(client).bandwidth_scale(t)
                == b.link(client).bandwidth_scale(t))
        assert (a.device_stall_extra(client, t)
                == b.device_stall_extra(client, t))
        assert a.server_stall_extra(t) == b.server_stall_extra(t)
        assert a.corrupt(client, t, codes) == b.corrupt(client, t, codes)


@pytest.mark.parametrize("spec", [
    "blackout:0.05:0.2; burst:0:1:0.2:0.4; degrade:0:1:0.5:0.1;"
    "devstall:0:1:0.03; gwstall:0:1:0.02; corrupt:0:1:0.3",
    "blackout", "burst;degrade:0:2:0.25", "stampede:0:1:5;corrupt"])
def test_parse_faults_matches_jax(spec):
    a, b = jfaults.parse_faults(spec), tfaults.parse_faults(spec)
    assert [type(e).__name__ for e in a] == [type(e).__name__ for e in b]
    assert [dataclasses.asdict(e) for e in a] == [dataclasses.asdict(e) for e in b]


def test_scheduler_fault_queries_match_jax():
    sched = lambda f: (f.SlotPoolStall(3, 7), f.EngineCrash(5))  # noqa: E731
    a = jfaults.FaultInjector(sched(jfaults))
    b = tfaults.FaultInjector(sched(tfaults))
    for r in range(10):
        assert a.chunk_stalled(r) == b.chunk_stalled(r)
        assert a.crashed(r) == b.crashed(r)
    assert issubclass(tfaults.EngineCrashError, RuntimeError)


# ----------------------------------------------- config validation ---

@pytest.mark.parametrize("kw", [
    {"bandwidth_bps": -1.0}, {"bandwidth_bps": 0.0},
    {"propagation_s": -1e-3}, {"jitter_s": -1e-3},
    {"drop_prob": -0.1}, {"drop_prob": 1.5},
    {"retransmit_timeout_s": 0.0}, {"retransmit_timeout_s": -0.1},
    {"max_attempts": -1}, {"backoff_mult": 0.5},
    {"backoff_max_s": 0.0}, {"backoff_jitter": -0.1},
])
def test_channel_config_rejects_bad_params(kw):
    with pytest.raises(ValueError, match=next(iter(kw))):
        tg.ChannelConfig(**kw)


@pytest.mark.parametrize("kw", [
    {"channel": "wifi"}, {"arrival_rate_hz": 0.0},
    {"arrival_rate_hz": -5.0}, {"n_requests": -1},
    {"slo_ms": 0.0}, {"deadline_ms": 0.0}, {"deadline_ms": -10.0},
])
def test_client_spec_rejects_bad_params(kw):
    with pytest.raises(ValueError, match=next(iter(kw))):
        tg.ClientSpec(**kw)


@pytest.mark.parametrize("make", [
    lambda: tfaults.Blackout(0.2, 0.1),
    lambda: tfaults.BurstLoss(p_good_bad=1.5),
    lambda: tfaults.LinkDegrade(bandwidth_scale=0.0),
    lambda: tfaults.LinkDegrade(extra_loss=2.0),
    lambda: tfaults.DeviceStall(stall_s=0.0),
    lambda: tfaults.GatewayStall(stall_s=-1.0),
    lambda: tfaults.PayloadCorruption(prob=0.0),
    lambda: tfaults.ArrivalBurst(factor=0.5),
    lambda: tfaults.SlotPoolStall(5, 5),
    lambda: tfaults.EngineCrash(-1),
])
def test_fault_events_reject_bad_params(make):
    with pytest.raises(ValueError):
        make()


@pytest.mark.parametrize("kw,field", [
    ({"batch_width": 0}, "batch_width"),
    ({"batch_window_s": -1e-3}, "batch_window_s"),
    ({"max_queue": 0}, "max_queue")])
def test_gateway_config_rejects_bad_params(kw, field):
    with pytest.raises(ValueError, match=field):
        tg.GatewayConfig(**kw)


def test_injector_rejects_unknown_event_and_kind():
    with pytest.raises(ValueError, match="unknown fault event"):
        tfaults.FaultInjector(("not-a-fault",))
    with pytest.raises(ValueError, match="unknown fault kind"):
        tfaults.parse_faults("meteor:0:1")


# ------------------------------------------ channel retry arithmetic ---

def test_backoff_waits_closed_form():
    cfg = tg.ChannelConfig(bandwidth_bps=1e6, drop_prob=1.0, max_attempts=5,
                           retransmit_timeout_s=0.1, backoff_mult=2.0,
                           backoff_max_s=0.3, propagation_s=0.0)
    d = tg.Channel(cfg, seed=0).transmit(1250, t_send=0.0)
    assert d.attempts == 5 and d.delivered
    assert d.device_free_s == pytest.approx(5 * 0.01 + 0.1 + 0.2 + 0.3 + 0.3)
    fixed = tg.ChannelConfig(bandwidth_bps=1e6, drop_prob=1.0, max_attempts=3,
                             retransmit_timeout_s=0.1)
    df = tg.Channel(fixed, seed=0).transmit(1250, t_send=0.0)
    assert df.device_free_s == pytest.approx(3 * 0.01 + 2 * 0.1)


def test_backoff_jitter_bounded_and_deterministic():
    cfg = tg.ChannelConfig(bandwidth_bps=1e6, drop_prob=1.0, max_attempts=4,
                           retransmit_timeout_s=0.1, backoff_jitter=0.5)
    a = tg.Channel(cfg, seed=7).transmit(1250, 0.0)
    b = tg.Channel(cfg, seed=7).transmit(1250, 0.0)
    assert a == b
    base = 4 * 0.01 + 3 * 0.1
    assert base <= a.device_free_s <= base + 3 * 0.05 + 1e-12


def test_deadline_stops_retries_as_expired():
    cfg = tg.ChannelConfig(bandwidth_bps=1e6, drop_prob=1.0, max_attempts=8,
                           retransmit_timeout_s=0.1)
    d = tg.Channel(cfg, seed=0).transmit(1250, t_send=0.0, deadline_s=0.25)
    assert not d.delivered and d.expired and d.attempts == 3
    assert d.arrive_s == d.device_free_s == pytest.approx(0.23)


def test_attempt_overrunning_deadline_is_expired_not_delivered():
    cfg = tg.ChannelConfig(bandwidth_bps=1e6, propagation_s=0.0)
    late = tg.Channel(cfg, seed=0).transmit(125000, 0.0, deadline_s=0.5)
    assert not late.delivered and late.expired and late.attempts == 1
    assert late.arrive_s == late.device_free_s == pytest.approx(1.0)
    ok = tg.Channel(cfg, seed=0).transmit(125000, 0.0, deadline_s=1.5)
    assert ok.delivered and not ok.expired
    assert ok.device_free_s == pytest.approx(1.0)


def test_retry_forever_terminates_under_total_loss():
    cfg = tg.ChannelConfig(bandwidth_bps=1e8, drop_prob=1.0, max_attempts=0,
                           retransmit_timeout_s=1e-4)
    d = tg.Channel(cfg, seed=0).transmit(100, t_send=0.0)
    assert not d.delivered and not d.expired and d.attempts == RETRY_SAFETY_CAP


def test_forced_loss_has_no_final_attempt_rescue():
    cfg = tg.ChannelConfig(bandwidth_bps=1e6, drop_prob=1.0, max_attempts=4,
                           retransmit_timeout_s=0.01)
    assert tg.Channel(cfg, seed=0).transmit(1250, 0.0).delivered
    inj = tfaults.FaultInjector((tfaults.Blackout(),), seed=0)
    d = tg.Channel(cfg, seed=0).transmit(1250, 0.0, link=inj.link(0))
    assert not d.delivered and not d.expired and d.attempts == 4


def test_degrade_scales_bandwidth_and_airtime():
    inj = tfaults.FaultInjector((tfaults.LinkDegrade(0.0, 10.0, bandwidth_scale=0.5),))
    cfg = tg.ChannelConfig(bandwidth_bps=1e6, propagation_s=0.0)
    d = tg.Channel(cfg, seed=0).transmit(1250, 0.0, link=inj.link(3))
    assert d.delivered and d.attempts == 1 and d.airtime_s == pytest.approx(0.02)
    clean = tg.Channel(cfg, seed=0).transmit(1250, 20.0, link=inj.link(3))
    assert clean.airtime_s == pytest.approx(0.01)


def test_fault_schedule_replays_deterministically():
    sched = (tfaults.BurstLoss(0.0, 1.0, p_good_bad=0.3, p_bad_good=0.3),
             tfaults.LinkDegrade(0.0, 1.0, extra_loss=0.2))
    a = tfaults.FaultInjector(sched, seed=4)
    b = tfaults.FaultInjector(sched, seed=4)
    seq_a = [a.link(1).attempt_lost(t) for t in np.linspace(0, 0.9, 50)]
    seq_b = []
    for t in np.linspace(0, 0.9, 50):
        b.link(2).attempt_lost(t)
        seq_b.append(b.link(1).attempt_lost(t))
    assert seq_a == seq_b
    assert any(seq_a) and not all(seq_a)


# -------------------------------------------- gateway degradation ---

def _run(tp, specs, *, seed=0, width=4, faults=None, gw=None):
    fleet = tg.Fleet(CFG, tp, specs, seed=seed)
    gateway = tg.OffloadGateway(CFG, tp, fleet, gw or tg.GatewayConfig(batch_width=width),
                                faults=faults)
    return fleet, gateway, gateway.run()


def test_idle_injector_is_bit_identical_to_none(params):
    _, tp = params
    specs = tg.mixed_fleet(6, n_requests=3, slo_ms=8.0, deadline_ms=500.0)
    _, _, plain = _run(tp, specs, seed=5)
    _, _, idle = _run(tp, specs, seed=5, faults=tfaults.FaultInjector(()))
    assert trace_key(plain) == trace_key(idle)
    assert all(a.logits.tobytes() == b.logits.tobytes()
               for a, b in zip(plain.traces, idle.traces))
    assert plain.fallback_rate == idle.fallback_rate == 0.0


def test_total_blackout_all_fallback_bit_identical_local(params):
    """Every request a Local-NN fallback whose logits equal the port's
    standalone local path bitwise, the retry-forever link included."""
    _, tp = params
    forever = dataclasses.replace(tg.WIFI_UDP, max_attempts=0,
                                  retransmit_timeout_s=1e-3)
    specs = (tg.ClientSpec(channel=tg.WIFI_UDP, n_requests=3),
             tg.ClientSpec(channel=forever, n_requests=3))
    fleet, _, report = _run(tp, specs,
                            faults=tfaults.FaultInjector((tfaults.Blackout(),)))
    assert len(report.traces) == 6 and report.fallback_rate == 1.0
    assert all(t.status == "fallback" for t in report.traces)
    for t in report.traces:
        row = fleet.clients[t.client].row0 + t.req
        assert t.logits.tobytes() == fleet.local_logits[row].tobytes()
        ref = agile_forward(CFG, tp, fleet.images[row:row + 1])[1]["local_logits"]
        assert t.logits.tobytes() == ref.numpy()[0].tobytes()
        assert t.pred == int(np.argmax(ref.numpy()[0]))


@pytest.mark.parametrize("seed", [11, 23])
def test_fault_run_fixed_seed_determinism(params, seed):
    _, tp = params
    sched = (tfaults.Blackout(0.02, 0.1), tfaults.BurstLoss(0.0, 2.0, p_good_bad=0.3),
             tfaults.PayloadCorruption(0.0, 2.0, prob=0.5),
             tfaults.DeviceStall(0.0, 0.5, stall_s=0.01),
             tfaults.GatewayStall(0.0, 0.5, stall_s=0.01))
    specs = tg.mixed_fleet(8, n_requests=3, deadline_ms=120.0)
    _, _, r1 = _run(tp, specs, faults=tfaults.FaultInjector(sched, seed=seed))
    _, _, r2 = _run(tp, specs, faults=tfaults.FaultInjector(sched, seed=seed))
    assert len(r1.traces) == 24 and trace_key(r1) == trace_key(r2)
    assert all(a.logits.tobytes() == b.logits.tobytes()
               for a, b in zip(r1.traces, r2.traces))
    _, _, r3 = _run(tp, specs, faults=tfaults.FaultInjector(sched, seed=seed + 1))
    assert trace_key(r1) != trace_key(r3)


def test_corruption_degrades_to_erased_floor(params):
    """Detected corruption serves with every offloaded channel zero-filled:
    the logits equal the port's Remote NN on zeros + combine, bitwise."""
    _, tp = params
    specs = (tg.ClientSpec(channel=tg.WIFI_UDP, n_requests=8),)
    fleet, _, report = _run(tp, specs, faults=tfaults.FaultInjector(
        (tfaults.PayloadCorruption(prob=1.0),), seed=2))
    assert len(report.traces) == 8 and report.degraded_rate > 0.5
    fh, Cr = fleet.feat_hw, fleet.n_remote
    for t in report.traces:
        if t.status != "degraded":
            continue
        row = fleet.clients[t.client].row0 + t.req
        ref = remote_forward(CFG, tp, torch.zeros(1, fh, fh, Cr),
                             torch.from_numpy(fleet.local_logits[row:row + 1]))
        assert t.logits.tobytes() == ref.numpy()[0].tobytes()


def test_deadline_sheds_and_marks_misses(params):
    _, tp = params
    specs = tg.mixed_fleet(6, n_requests=3, deadline_ms=60.0)
    fleet, _, report = _run(tp, specs, width=2, faults=tfaults.FaultInjector(
        (tfaults.GatewayStall(0.0, 100.0, stall_s=0.25),)))
    assert len(report.traces) == 18
    assert len({(t.client, t.req) for t in report.traces}) == 18
    assert report.deadline_miss_rate > 0
    for t in report.traces:
        deadline = t.t_born + 0.060
        if t.status in ("shed", "fallback") and t.deadline_missed:
            assert t.t_done <= deadline + 1e-12
            row = fleet.clients[t.client].row0 + t.req
            assert t.logits.tobytes() == fleet.local_logits[row].tobytes()
        elif t.status == "served":
            assert t.deadline_missed == (t.t_done > deadline)


def test_edf_admission_serves_tightest_deadline_first(params):
    """A stalled width-1 pool: the later narrowband request with the
    tightest deadline jumps the queued WiFi one; without deadlines the
    same contention resolves FIFO."""
    _, tp = params

    def specs(deadlines):
        d0, d1, d2 = deadlines
        return (tg.ClientSpec(channel=tg.WIFI_UDP, n_requests=1,
                              arrival_rate_hz=1e4, deadline_ms=d0),
                tg.ClientSpec(channel=tg.WIFI_UDP, n_requests=1,
                              arrival_rate_hz=1e4, deadline_ms=d1),
                tg.ClientSpec(channel=tg.NARROWBAND, n_requests=1,
                              arrival_rate_hz=1e4, deadline_ms=d2))

    gw = tg.GatewayConfig(batch_width=1)
    stall = lambda: tfaults.FaultInjector(  # noqa: E731
        (tfaults.GatewayStall(0.0, 100.0, stall_s=0.1),))
    _, _, report = _run(tp, specs((5000.0, 5000.0, 300.0)), gw=gw, faults=stall())
    by_client = {t.client: t for t in report.traces}
    assert len(by_client) == 3
    assert all(t.status == "served" for t in report.traces)
    first = min(report.traces, key=lambda t: t.t_serve)
    queued = [t for t in report.traces if t is not first]
    assert by_client[2] in queued
    assert by_client[2].t_arrive == max(t.t_arrive for t in report.traces)
    assert all(t.t_arrive < first.t_serve + 0.1 for t in queued)
    other = next(t for t in queued if t is not by_client[2])
    assert by_client[2].t_serve < other.t_serve
    _, _, fifo = _run(tp, specs((None, None, None)), gw=gw, faults=stall())
    order = sorted(fifo.traces, key=lambda t: t.t_serve)
    arrivals = sorted(fifo.traces, key=lambda t: t.t_arrive)
    assert [t.client for t in order] == [t.client for t in arrivals]


def test_device_and_gateway_stalls_stretch_latency(params):
    _, tp = params
    specs = (tg.ClientSpec(channel=tg.WIFI_UDP, n_requests=2),)
    _, _, base = _run(tp, specs)
    _, _, stalled = _run(tp, specs, faults=tfaults.FaultInjector(
        (tfaults.DeviceStall(0.0, 100.0, stall_s=0.02),
         tfaults.GatewayStall(0.0, 100.0, stall_s=0.03))))
    assert len(stalled.traces) == 2
    assert (stalled.latency_percentile_ms(50)
            >= base.latency_percentile_ms(50) + 20.0)


def test_bounded_queue_rejects_at_admission(params):
    """A stampede into a 2-deep queue takes the rejected rung: those
    requests resolve at once, on their Local-NN logits."""
    _, tp = params
    specs = tg.mixed_fleet(8, n_requests=3)
    fleet, _, report = _run(tp, specs, gw=tg.GatewayConfig(batch_width=2, max_queue=2),
                            faults=tfaults.FaultInjector(
                                (tfaults.ArrivalBurst(factor=20.0),)))
    assert len(report.traces) == 24 and report.rejected_rate > 0
    for t in report.traces:
        if t.status == "rejected":
            row = fleet.clients[t.client].row0 + t.req
            assert t.t_done == t.t_arrive and not t.deadline_missed
            assert t.logits.tobytes() == fleet.local_logits[row].tobytes()


# ------------------------------------------------- slot pool churn ---

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slot_pool_churn_never_leaks_or_double_assigns(seed):
    """Randomized acquire / release / preempt / resume churn keeps the pool
    invariants; misuse raises SlotError."""
    rng = np.random.RandomState(seed)
    pool = SlotPool(6)
    live, suspended, next_rid = {}, [], 0
    for _ in range(500):
        choice = rng.randint(4)
        if live and (len(pool.free()) == 0 or choice == 0):
            slot = int(rng.choice(sorted(live)))
            assert pool.release(slot) == live.pop(slot)
        elif live and choice == 1:
            slot = int(rng.choice(sorted(live)))
            rid = live.pop(slot)
            assert pool.release(slot, rid) == rid
            suspended.append(rid)
        elif suspended and pool.free() and choice == 2:
            rid = suspended.pop(int(rng.randint(len(suspended))))
            slot = int(rng.choice(pool.free()))
            pool.acquire(slot, rid)
            live[slot] = rid
        elif pool.free():
            slot = int(rng.choice(pool.free()))
            pool.acquire(slot, next_rid)
            live[slot] = next_rid
            next_rid += 1
        free, occ = set(pool.free()), dict(pool.occupied())
        assert free | set(occ) == set(range(6)) and not free & set(occ)
        assert occ == live and len(pool) == 6
        assert pool.any_occupied() == bool(live)
    if not pool.free():
        slot0 = sorted(live)[0]
        pool.release(slot0)
        live.pop(slot0)
    slot = pool.free()[0]
    pool.acquire(slot, next_rid)
    with pytest.raises(SlotError, match="already occupied"):
        pool.acquire(slot, next_rid + 1)
    with pytest.raises(SlotError, match="owned by"):
        pool.release(slot, next_rid + 1)
    assert pool.rids[slot] == next_rid
    assert pool.release(slot, next_rid) == next_rid
    with pytest.raises(SlotError, match="released twice"):
        pool.release(slot)


@pytest.mark.parametrize("width", [1, 3, 8])
def test_gateway_pool_returns_to_empty_after_chaos(params, width):
    _, tp = params
    sched = (tfaults.Blackout(0.01, 0.08), tfaults.PayloadCorruption(prob=0.4),
             tfaults.GatewayStall(0.0, 0.2, stall_s=0.05))
    _, gateway, report = _run(tp, tg.mixed_fleet(6, n_requests=4, deadline_ms=80.0),
                              seed=1, gw=tg.GatewayConfig(batch_width=width),
                              faults=tfaults.FaultInjector(sched, seed=5))
    assert len(report.traces) == 24
    assert gateway._slots.free() == list(range(width))
    assert not gateway._slots.any_occupied()
