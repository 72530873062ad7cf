"""The port's multi-client offload gateway on the CPU.

Against the JAX package, on bridged ``PRNGKey(0)`` params at
``gateway_demo_config()``: the fleet's images, labels and indices are
identical (0 index flips), the benchmark's pinned 32-client runs
(``benchmarks/gateway.py``: mixed links, 6 requests, W = 8, static and
SLO = 30 ms) give exactly equal request traces and ``gateway.*`` row
values, and the logits agree within 1e-4 abs + rel (a 2-channel
GroupNorm at width 16 puts them 2e-5 apart).  The channel, the rate
controller and the host requantizer replay the JAX draws exactly.

Within the port, bitwise: the static gateway equals per-image
``agile_forward``, pool widths 2 and 8 give the same logits, same-seed
runs replay, and the fleet's batched codec frames every request as the
per-request codec does."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.compress.lzw import compress_payload as jax_compress  # noqa: E402
from repro.configs.agilenn_cifar import gateway_demo_config as jax_config  # noqa: E402
from repro.core.agile import init_agile_params as jax_init  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.serve import event_loop as jloop  # noqa: E402
from repro.serve import gateway as jg  # noqa: E402
from repro.serve import telemetry as jtel  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.compress.lzw import compress_payload, pack_indices  # noqa: E402
from repro_torch.compress.quantize import quantization_bits  # noqa: E402
from repro_torch.configs.agilenn_cifar import gateway_demo_config  # noqa: E402
from repro_torch.core.agile import agile_forward, init_agile_params  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.serve import event_loop as tloop  # noqa: E402
from repro_torch.serve import gateway as tg  # noqa: E402
from repro_torch.serve import telemetry as ttel  # noqa: E402
from repro_torch.serve.offload import run_offload_inference  # noqa: E402

JCFG, CFG = jax_config(), gateway_demo_config()
# port vs JAX logits: per-pixel GroupNorm with 2 channels per group at
# width 16 rounds differently in the two frameworks (measured 2.2e-5)
LOGIT_TOL = 1e-4
PIN_CLIENTS, PIN_REQS, PIN_WIDTH = 32, 6, 8       # benchmarks/gateway.py
TRACE_FIELDS = ("client", "req", "channel", "bits", "keep", "payload_bytes",
                "attempts", "t_born", "t_sent", "t_arrive", "t_serve",
                "t_done", "e2e_s", "energy_j", "status", "deadline_missed")


@pytest.fixture(scope="module")
def params():
    """(JAX params at PRNGKey(0), the port's params bridged from them)."""
    jp = jax_init(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")


def trace_key(report):
    return [tuple(getattr(t, f) for f in TRACE_FIELDS) for t in report.traces]


def assert_logits_match(jax_report, port_report):
    """Logits within LOGIT_TOL abs + rel; predictions equal unless JAX's
    top-2 margin is within twice the bar (each such request is printed).
    Returns the requests whose prediction differs."""
    swapped = []
    for a, b in zip(jax_report.traces, port_report.traces):
        np.testing.assert_allclose(b.logits, a.logits, atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)
        if a.pred != b.pred:
            top = np.sort(a.logits)[-2:]
            margin = float(top[1] - top[0])
            assert margin <= 2 * (LOGIT_TOL + LOGIT_TOL * abs(float(top[1]))), \
                f"request {(a.client, a.req)}: preds differ at margin {margin}"
            swapped.append((a.client, a.req, margin))
    if swapped:
        print(f"predictions swapped at a near-tie: {swapped}")
    return swapped


# ------------------------------------------------------ fleet inputs ---

@pytest.mark.parametrize("size,n_classes,seed,batch", [
    (16, 10, 0, 192), (32, 10, 3, 7), (96, 10, 0, 4), (16, 4, 5, 9)])
def test_synthetic_images_byte_identical_to_jax(size, n_classes, seed, batch):
    spec = dict(image_size=size, n_classes=n_classes, seed=seed)
    want = jsyn.SyntheticImages(jsyn.ImageDatasetSpec(**spec)).batch(batch, seed + 1)
    got = tsyn.SyntheticImages(tsyn.ImageDatasetSpec(**spec)).batch(batch, seed + 1)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and w.tobytes() == g.tobytes()


@pytest.fixture(scope="module")
def pinned_fleets(params):
    """The benchmark's pinned static fleet, built by both packages."""
    jp, tp = params
    jf = jg.Fleet(JCFG, jp, jg.mixed_fleet(PIN_CLIENTS, n_requests=PIN_REQS), seed=0)
    tf = tg.Fleet(CFG, tp, tg.mixed_fleet(PIN_CLIENTS, n_requests=PIN_REQS), seed=0)
    return jf, tf


def test_pinned_fleet_inputs_match_jax(pinned_fleets):
    """Images and labels byte-identical, 0 index flips of 58,368, the
    fleet's host arrays in JAX's dtypes and shapes."""
    jf, tf = pinned_fleets
    assert tf.n_requests == jf.n_requests == PIN_CLIENTS * PIN_REQS
    assert tf.images.tobytes() == jf.images.tobytes()
    assert tf.labels.tobytes() == jf.labels.tobytes()
    flips = int(np.sum(tf.idx != jf.idx))
    print(f"pinned fleet index flips: {flips} of {jf.idx.size}")
    assert flips == 0 and tf.idx.dtype == jf.idx.dtype
    np.testing.assert_allclose(tf.f_remote, jf.f_remote, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tf.local_logits, jf.local_logits, atol=1e-5,
                               rtol=1e-5)
    assert tf.local_logits.dtype == jf.local_logits.dtype == np.float32
    assert (tf.feat_hw, tf.n_remote, tf.full_bits, tf.local_macs, tf.remote_macs) == \
        (jf.feat_hw, jf.n_remote, jf.full_bits, jf.local_macs, jf.remote_macs)
    assert tf.device.type == "cpu"


def test_pinned_fleet_clients_match_jax(pinned_fleets):
    jf, tf = pinned_fleets
    for a, b in zip(jf.clients, tf.clients):
        assert (a.index, a.row0, a.spec.channel.name) == (b.index, b.row0,
                                                          b.spec.channel.name)
        assert a.born.tobytes() == b.born.tobytes()
        assert dataclasses.asdict(a.device) == dataclasses.asdict(b.device)
        assert jf.compute_time(a) == tf.compute_time(b)
        assert a.controller.ladder == tuple(
            jg.RateProfile(p.bits, p.keep_frac) for p in b.controller.ladder)


# ------------------------------------------------- pinned gateway runs ---

def _pinned_runs(jp, tp):
    out = {}
    for name, slo in (("static", None), ("adaptive", 30.0)):
        reports = []
        for g, cfg, p in ((jg, JCFG, jp), (tg, CFG, tp)):
            fleet = g.Fleet(cfg, p, g.mixed_fleet(PIN_CLIENTS, n_requests=PIN_REQS,
                                                  slo_ms=slo), seed=0)
            reports.append(g.OffloadGateway(
                cfg, p, fleet, g.GatewayConfig(batch_width=PIN_WIDTH)).run())
        out[name] = tuple(reports)
    return out


@pytest.fixture(scope="module")
def pinned(params):
    return _pinned_runs(*params)


def _gateway_rows(static, adaptive):
    """The simulated ``gateway.*`` rows of benchmarks/gateway.py (all but
    the wall-clock clients_per_s)."""
    return {
        "gateway.e2e_latency_p50_ms": static.latency_percentile_ms(50),
        "gateway.e2e_latency_p99_ms": static.latency_percentile_ms(99),
        "gateway.device_energy_mj": static.device_energy_mj,
        "gateway.adaptive_e2e_latency_p99_ms": adaptive.latency_percentile_ms(99),
        "gateway.adaptive_payload_bytes": adaptive.summary()["payload_bytes_mean"],
        "gateway.adaptive_device_energy_mj": adaptive.device_energy_mj,
    }


@pytest.mark.parametrize("run", ["static", "adaptive"])
def test_pinned_run_traces_exactly_equal_jax(pinned, run):
    jr, tr = pinned[run]
    assert len(tr.traces) == PIN_CLIENTS * PIN_REQS
    assert trace_key(tr) == trace_key(jr)
    assert [t.label for t in tr.traces] == [t.label for t in jr.traces]
    assert tr.sim_s == jr.sim_s and tr.n_clients == jr.n_clients


@pytest.mark.parametrize("run", ["static", "adaptive"])
def test_pinned_run_logits_within_bar(pinned, run):
    jr, tr = pinned[run]
    assert assert_logits_match(jr, tr) == []


@pytest.mark.parametrize("row", [
    "gateway.e2e_latency_p50_ms", "gateway.e2e_latency_p99_ms",
    "gateway.device_energy_mj", "gateway.adaptive_e2e_latency_p99_ms",
    "gateway.adaptive_payload_bytes", "gateway.adaptive_device_energy_mj"])
def test_pinned_gateway_rows_exactly_equal_jax(pinned, row):
    want = _gateway_rows(pinned["static"][0], pinned["adaptive"][0])
    got = _gateway_rows(pinned["static"][1], pinned["adaptive"][1])
    assert got[row] == want[row]


@pytest.mark.parametrize("run", ["static", "adaptive"])
def test_pinned_run_summary_matches_jax(pinned, run):
    """Every simulated summary value equal; accuracy equal because the
    predictions are."""
    jr, tr = pinned[run]
    a, b = jr.summary(), tr.summary()
    for s in (a, b):
        s.pop("clients_per_s")
    assert a == b
    assert tr.clients_per_s > 0


def test_adaptive_run_walks_the_ladder(pinned):
    """The 30 ms SLO moves clients off the static profile, so the
    adaptive pin exercises the requantized framings."""
    _, tr = pinned["adaptive"]
    assert {t.bits for t in tr.traces} != {3}
    assert len({t.keep for t in tr.traces}) > 1


# --------------------------------------------------- module parity ---

CHANNELS = {
    "wifi": {}, "narrowband": dict(bandwidth_bps=270e3, propagation_s=25e-3),
    "lossy": dict(drop_prob=0.15, jitter_s=3e-3),
    "backoff": dict(drop_prob=0.5, backoff_mult=2.0, backoff_max_s=0.05,
                    backoff_jitter=0.3, max_attempts=5),
    "forever": dict(drop_prob=0.9, max_attempts=0, retransmit_timeout_s=1e-3),
}


@pytest.mark.parametrize("name", sorted(CHANNELS))
def test_channel_transmit_sequence_matches_jax(name):
    """The same seed draws the same losses, jitter and backoff: 40
    transmits, some under a deadline, exactly equal deliveries."""
    kw = CHANNELS[name]
    a = jg.Channel(jg.ChannelConfig(**kw), seed=17)
    b = tg.Channel(tg.ChannelConfig(**kw), seed=17)
    for i in range(40):
        nbytes, t = 50 + 37 * i, 0.013 * i
        deadline = t + 0.03 if i % 3 == 0 else None
        da = a.transmit(nbytes, t, deadline_s=deadline)
        db = b.transmit(nbytes, t, deadline_s=deadline)
        assert dataclasses.asdict(da) == dataclasses.asdict(db)


@pytest.mark.parametrize("slo_s", [None, 0.005, 0.03, 0.2])
def test_rate_controller_walk_matches_jax(slo_s):
    lat = np.random.RandomState(4).exponential(0.03, 200)
    a = jg.RateController(jg.default_ladder(8), slo_s)
    b = tg.RateController(tg.default_ladder(8), slo_s)
    walk_a, walk_b = [], []
    for x in lat:
        a.observe(float(x))
        b.observe(float(x))
        walk_a.append((a.level, a.profile().key))
        walk_b.append((b.level, b.profile().key))
    assert walk_a == walk_b


@pytest.mark.parametrize("n_centers", [2, 4, 8, 16])
def test_ladder_and_keep_channels_match_jax(n_centers):
    la, lb = jg.default_ladder(n_centers), tg.default_ladder(n_centers)
    assert [p.key for p in la] == [p.key for p in lb]
    full = quantization_bits(n_centers)
    for pa, pb in zip(la + (jg.ERASED,), lb + (tg.ERASED,)):
        for n_remote in (1, 7, 19):
            assert (jg.keep_channels(pa, n_remote, full)
                    == tg.keep_channels(pb, n_remote, full))


@pytest.mark.parametrize("bits", [1, 2, 3, 4])
def test_subset_centers_and_requantize_match_jax(params, bits):
    """Subset codebooks equal; host requantization equal to JAX's on the
    same features, ties to the lowest index."""
    jp, tp = params
    centers = np.asarray(jp["quant"]["centers"], np.float32)
    cj = jg.subset_centers(centers, bits)
    ct = tg.subset_centers(tp["quant"]["centers"].numpy(), bits)
    assert cj.tobytes() == ct.tobytes()
    f = np.random.RandomState(bits).standard_normal((6, 4, 4, 19)).astype(np.float32)
    f[0, 0, 0, :len(ct) - 1] = (ct[:-1] + ct[1:]) / 2       # midpoints
    assert jg.requantize(f, cj).tobytes() == tg.requantize(f, ct).tobytes()


def test_event_loop_order_matches_jax():
    rng = np.random.RandomState(0)
    a, b = jloop.EventLoop(), tloop.EventLoop()
    for i in range(200):
        t, prio = float(rng.randint(20)) * 0.5, float(rng.randint(3))
        a.push(t, "e", i, prio=prio)
        b.push(t, "e", i, prio=prio)
    assert len(a) == len(b) and a.peek_time() == b.peek_time()
    seq_a = [a.pop() for _ in range(200)]
    seq_b = [b.pop() for _ in range(200)]
    assert seq_a == seq_b and a.now == b.now and not b


def test_telemetry_spans_match_jax(params):
    """With telemetry on, the gateway's simulated hop spans and counters
    equal JAX's: the spans carry event-loop timestamps, never a clock."""
    jp, tp = params
    out = []
    for g, tel_mod, cfg, p in ((jg, jtel, JCFG, jp), (tg, ttel, CFG, tp)):
        tel = tel_mod.Telemetry(enabled=True)
        fleet = g.Fleet(cfg, p, g.mixed_fleet(6, n_requests=3, slo_ms=8.0), seed=2)
        g.OffloadGateway(cfg, p, fleet, g.GatewayConfig(batch_width=4),
                         telemetry=tel).run()
        out.append(tel)
    ja, tb = out
    assert [(s.name, s.t0, s.t1, s.track, s.args) for s in ja.trace.spans] == \
        [(s.name, s.t0, s.t1, s.track, s.args) for s in tb.trace.spans]
    da, db = ja.metrics.to_dict(), tb.metrics.to_dict()
    da.pop("gateway.codec_ms"), db.pop("gateway.codec_ms")
    assert da == db
    assert tb.histogram("gateway.codec_ms",
                        bounds=tg.gateway._MS_BOUNDS).count > 0


def test_telemetry_histogram_and_export_match_jax():
    samples = np.random.RandomState(1).exponential(3.0, 500)
    ha = jtel.Histogram("h", bounds=jtel.exponential(0.25, 2.0, 16))
    hb = ttel.Histogram("h", bounds=ttel.exponential(0.25, 2.0, 16))
    for v in samples:
        ha.observe(v)
        hb.observe(v)
    for q in (0, 10, 50, 90, 99, 100):
        assert ha.percentile(q) == hb.percentile(q)
    ra, rb = jtel.MetricsRegistry(), ttel.MetricsRegistry()
    for r in (ra, rb):
        r.counter("c", kind="x").inc(3)
        r.gauge("g").set(2.5)
        r.histogram("h").observe(0.01)
    assert ra.prometheus_text() == rb.prometheus_text()
    assert ra.to_dict() == rb.to_dict()
    assert not ttel.default().enabled


# ------------------------------------------- the port's own claims ---

def _run(tp, specs, *, seed=0, width=4):
    fleet = tg.Fleet(CFG, tp, specs, seed=seed)
    return fleet, tg.OffloadGateway(CFG, tp, fleet,
                                    tg.GatewayConfig(batch_width=width)).run()


def test_static_gateway_bit_identical_to_per_image_offload(params):
    """The static gateway's logits equal per-image ``agile_forward``
    bitwise, through LZW + bit-pack framing, batching and pool padding;
    the predictions equal ``run_offload_inference``'s."""
    _, tp = params
    specs = tg.mixed_fleet(6, n_requests=2, channels=(tg.WIFI_UDP, tg.NARROWBAND))
    fleet, report = _run(tp, specs)
    assert len(report.traces) == 12
    for t in report.traces:
        row = fleet.clients[t.client].row0 + t.req
        image = fleet.images[row:row + 1]
        ref = agile_forward(CFG, tp, image)[0].numpy()[0]
        assert t.logits.tobytes() == ref.tobytes()
        preds, _ = run_offload_inference(CFG, tp, image)
        assert t.pred == int(preds[0])
        assert t.bits == 3 and t.keep == fleet.n_remote


def test_pool_width_does_not_change_logits(params):
    _, tp = params
    specs = tg.mixed_fleet(5, n_requests=2, channels=(tg.WIFI_UDP,))
    _, narrow = _run(tp, specs, width=2)
    _, wide = _run(tp, specs, width=8)
    a = {(t.client, t.req): t.logits for t in narrow.traces}
    b = {(t.client, t.req): t.logits for t in wide.traces}
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].tobytes() == b[k].tobytes()


@pytest.mark.parametrize("slo", [None, 8.0])
def test_same_seed_runs_replay(params, slo):
    _, tp = params
    specs = tg.mixed_fleet(6, n_requests=3, slo_ms=slo)
    _, r1 = _run(tp, specs, seed=5)
    _, r2 = _run(tp, specs, seed=5)
    assert trace_key(r1) == trace_key(r2)
    assert all(a.logits.tobytes() == b.logits.tobytes()
               for a, b in zip(r1.traces, r2.traces))


@pytest.fixture(scope="module")
def small_fleet(params):
    return tg.Fleet(CFG, params[1], tg.mixed_fleet(4, n_requests=3), seed=3)


@pytest.mark.parametrize("level", range(len(tg.default_ladder(8))))
def test_fleet_batched_codec_matches_per_request_codec(small_fleet, level):
    """The fleet-wide codec cache frames every request byte-identically to
    the per-request reference codec (the port's and JAX's), at every rung
    of the rate ladder; the second lookup is the cache."""
    fleet = small_fleet
    prof = tg.default_ladder(8)[level]
    keep = tg.keep_channels(prof, fleet.n_remote, fleet.full_bits)
    got = fleet._encoded_rows(prof.bits, keep)
    assert len(got) == fleet.n_requests
    for row in range(fleet.n_requests):
        if prof.bits >= fleet.full_bits and keep >= fleet.n_remote:
            idx = fleet.idx[row]
        else:
            idx = tg.requantize(fleet.f_remote[row][..., :keep],
                                fleet.centers_for(prof.bits))
        packed = pack_indices(idx, prof.bits)
        assert got[row] == compress_payload(packed) == jax_compress(packed)
    assert fleet._encoded_rows(prof.bits, keep) is got


def test_fleet_payload_cache_hits_across_requests(params):
    fleet = tg.Fleet(CFG, params[1], tg.mixed_fleet(3, n_requests=2), seed=4)
    c = fleet.clients[1]
    p1, p2 = fleet.make_payload(c, 0), fleet.make_payload(c, 0)
    assert (p1.nbytes, p1.codes, p1.count) == (p2.nbytes, p2.codes, p2.count)
    assert set(fleet._payloads) == {(fleet.full_bits, fleet.n_remote)}


def test_fleet_runs_one_device_pass(params, monkeypatch):
    """One batched device pass per fleet build, over every request."""
    from repro_torch.serve.gateway import fleet as fleet_mod

    calls = []
    real = fleet_mod.device_forward_fn

    def counting(cfg, p):
        fn = real(cfg, p)

        def run(p_, images):
            calls.append(tuple(images.shape))
            return fn(p_, images)
        return run

    monkeypatch.setattr(fleet_mod, "device_forward_fn", counting)
    fleet = tg.Fleet(CFG, params[1], tg.mixed_fleet(5, n_requests=3), seed=1)
    assert calls == [(15, CFG.image_size, CFG.image_size, 3)]
    fleet.make_payload(fleet.clients[0], 0)
    assert len(calls) == 1


def test_32_client_mixed_fleet_completes(params):
    """Every request served with ordered timestamps and closed-form device
    energy."""
    _, tp = params
    fleet, report = _run(tp, tg.mixed_fleet(32, n_requests=2), width=8)
    assert len(report.traces) == 64
    assert {t.channel for t in report.traces} == {"wifi", "narrowband",
                                                 "lossy-wifi"}
    t_compute = fleet.compute_time(fleet.clients[0])
    for t in report.traces:
        assert t.t_born <= t.t_sent - t_compute + 1e-12
        assert t.t_sent < t.t_arrive <= t.t_serve < t.t_done
        assert t.e2e_s == pytest.approx(t.t_done - t.t_born)
        c = fleet.clients[t.client]
        ser = tg.Channel(c.spec.channel).serialize_s(t.payload_bytes)
        assert t.energy_j == pytest.approx(c.device.p_cpu_w * t_compute
                                           + c.device.p_tx_w * t.attempts * ser)
    assert report.summary()["e2e_p99_ms"] > 0


def test_adaptive_rate_control_sheds_payload(params):
    _, tp = params
    slow = (tg.ClientSpec(channel=tg.NARROWBAND, n_requests=6, slo_ms=10.0),)
    fleet, report = _run(tp, slow, width=2)
    assert fleet.clients[0].controller.level > 0
    first = report.traces[0]
    last = max(report.traces, key=lambda t: t.req)
    assert first.bits == 3 and last.bits < 3
    assert last.payload_bytes < first.payload_bytes
    assert last.energy_j < first.energy_j
    calm = (tg.ClientSpec(channel=tg.NARROWBAND, n_requests=6, slo_ms=None),)
    fleet2, report2 = _run(tp, calm, width=2)
    assert fleet2.clients[0].controller.level == 0
    assert all(t.bits == 3 for t in report2.traces)


def test_channel_clean_link_closed_form():
    d = tg.Channel(tg.ChannelConfig(bandwidth_bps=1e6, propagation_s=5e-3),
                   seed=0).transmit(1250, t_send=1.0)
    assert d.attempts == 1 and d.airtime_s == pytest.approx(0.01)
    assert d.device_free_s == pytest.approx(1.01)
    assert d.arrive_s == pytest.approx(1.015)


def test_channel_full_loss_retransmits_to_cap():
    cfg = tg.ChannelConfig(bandwidth_bps=1e6, drop_prob=1.0,
                           retransmit_timeout_s=0.1, max_attempts=4)
    d = tg.Channel(cfg, seed=0).transmit(1250, t_send=0.0)
    assert d.attempts == 4 and d.airtime_s == pytest.approx(4 * 0.01)
    assert d.device_free_s == pytest.approx(4 * 0.01 + 3 * 0.1)


def test_narrowband_slower_than_wifi():
    wifi = tg.Channel(tg.WIFI_UDP, seed=0).transmit(1000, 0.0)
    nb = tg.Channel(tg.NARROWBAND, seed=0).transmit(1000, 0.0)
    assert nb.airtime_s / wifi.airtime_s == pytest.approx(6e6 / 270e3)


def test_controller_static_never_moves_and_walks_with_slo():
    ctl = tg.RateController(tg.default_ladder(8), slo_s=None)
    for lat in (1.0, 10.0, 0.0):
        ctl.observe(lat)
    assert ctl.level == 0 and ctl.profile() == tg.RateProfile(3, 1.0)
    ladder = tg.default_ladder(8)
    ctl = tg.RateController(ladder, slo_s=0.03)
    for _ in range(10):
        ctl.observe(0.08)
    assert ctl.level == len(ladder) - 1
    for _ in range(10):
        ctl.observe(0.001)
    assert ctl.level == 0


def test_gateway_surface_matches_jax():
    assert sorted(tg.__all__) == sorted(jg.__all__)
    for name in tg.__all__:
        assert hasattr(tg, name)
    for preset in ("WIFI_UDP", "NARROWBAND", "LOSSY_WIFI"):
        assert (dataclasses.asdict(getattr(tg, preset))
                == dataclasses.asdict(getattr(jg, preset)))
    assert tg.GatewayConfig().__dict__ == jg.GatewayConfig().__dict__


def test_fleet_follows_params_device(params):
    """The fleet's device is the params' device; its host arrays are numpy."""
    p = init_agile_params(CFG, 0, device="cpu")
    fleet = tg.Fleet(CFG, p, tg.mixed_fleet(2, n_requests=1), seed=0)
    assert fleet.device == p["quant"]["centers"].device
    assert isinstance(fleet.idx, np.ndarray) and fleet.idx.dtype == np.int32
