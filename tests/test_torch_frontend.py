"""The port's streaming frontend on the CPU (reduced qwen2-0.5b, JAX
weights bridged by ``backbone_params_from_numpy``).

Against the JAX package on one virtual clock: the pinned stampede of
benchmarks/stream_slo.py (12 closed-loop clients x 4 requests, 10x
ArrivalBurst, max_queue 6, SLO 250 ms) gives the same event stream (type,
rid, t, tokens), the same rejections with their retry-after hints, the
same SimReport records and the same five ``stream.*`` rows; a
pass-through frontend gives the port scheduler's tokens.  Within the
port: the breaker's hysteresis, the feed order (class, then EDF), the
typed ``Overloaded``, a deadline shed beside a rejection, and the asyncio
``stream()`` against ``run()``."""
import asyncio

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import backbone as jbb  # noqa: E402
from repro.serve import faults as jfaults  # noqa: E402
from repro.serve import frontend as jfe  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.scheduler import SchedulerConfig as JaxSchedulerConfig  # noqa: E402
from repro_torch.bridge import backbone_params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.serve import faults as tfaults  # noqa: E402
from repro_torch.serve import frontend as tfe  # noqa: E402
from repro_torch.serve.engine import Request  # noqa: E402
from repro_torch.serve.scheduler import ContinuousScheduler, SchedulerConfig  # noqa: E402
from repro_torch.serve.telemetry import Histogram  # noqa: E402

SCHED = dict(buckets=(8, 16), max_slots=2, prefill_group=1, chunk=2)
# benchmarks/stream_slo.py's pinned stampede
SLO_SCHED = dict(buckets=(8, 16), max_slots=4, prefill_group=2, chunk=2)
SLO_FRONTEND = dict(max_queue=6, slo_ms=250.0,
                    class_deadline_ms=(400.0, None, None))
ROUND_S, N_PER_CLASS, N_REQS, BURST = 0.01, 4, 4, 10.0
PORT = (tfe, SchedulerConfig, Request, tfaults)
JAX = (jfe, JaxSchedulerConfig, JaxRequest, jfaults)


@pytest.fixture(scope="module")
def system():
    jcfg = jax_get_config("qwen2-0.5b").reduced()
    cfg = get_config("qwen2-0.5b").reduced()
    jp = jbb.init_params(jcfg, jax.random.PRNGKey(0))
    tp = backbone_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                    cfg, device="cpu")
    return {"port": (cfg, tp), "jax": (jcfg, jp)}


def _frontend(system, which, *, frontend=None, clock=None, sched=SCHED,
              max_len=32, **sched_kw):
    fe_mod, conf = (PORT if which == "port" else JAX)[:2]
    cfg, params = system[which]
    extra = {"device": "cpu"} if which == "port" else {}
    return fe_mod.StreamingFrontend(
        cfg, params, frontend=frontend, sched=conf(**{**sched, **sched_kw}),
        max_len=max_len, seed=0, clock=clock, **extra)


def _requests(which, n, seed=0, max_new=5):
    cls = (PORT if which == "port" else JAX)[2]
    rng = np.random.RandomState(seed)
    return [cls(tokens=rng.randint(0, 512, int(rng.choice((4, 8, 12)))),
                max_new_tokens=max_new) for _ in range(n)]


def pctl(values, q):
    """benchmarks/common.py's exact percentile."""
    h = Histogram.exact()
    for v in np.asarray(values, np.float64).ravel():
        h.observe(float(v))
    return h.percentile(q)


def _event_key(ev):
    toks = tuple(int(x) for x in ev.tokens) if hasattr(ev, "tokens") else None
    return (type(ev).__name__, ev.rid, getattr(ev, "token", None),
            getattr(ev, "status", None), toks, ev.t)


def _stampede(system, which):
    """benchmarks/stream_slo.py's stream_slo_rows, through one package."""
    fe_mod, _, req_cls, flt = PORT if which == "port" else JAX
    rng = np.random.RandomState(0)
    clients = []
    for c in range(3 * N_PER_CLASS):
        reqs = tuple(req_cls(tokens=rng.randint(0, 512,
                                                int(rng.choice((4, 8, 12)))),
                             max_new_tokens=int(6 + rng.randint(0, 5)))
                     for _ in range(N_REQS))
        clients.append(fe_mod.SimClient(requests=reqs,
                                        priority=fe_mod.Priority(c % 3),
                                        start_s=0.1 * c, think_s=0.02))
    clock = fe_mod.VirtualClock()
    fe = _frontend(system, which, clock=clock, sched=SLO_SCHED,
                   frontend=fe_mod.FrontendConfig(**SLO_FRONTEND))
    rep = fe_mod.drive_closed_loop(
        fe, clients, clock=clock, round_s=ROUND_S,
        faults=flt.FaultInjector((flt.ArrivalBurst(factor=BURST),), seed=7))
    inter = rep.ttft_ms(fe_mod.Priority.INTERACTIVE)
    rows = {"stream.ttft_p50_ms": pctl(inter, 50),
            "stream.ttft_p99_ms": pctl(inter, 99),
            "stream.itl_p99_ms": pctl(rep.itl_ms(), 99),
            "stream.reject_rate": rep.reject_rate,
            "stream.goodput_rps": rep.goodput_rps}
    records = [(r.client, int(r.priority), r.t_submit, r.status, r.t_first,
                r.t_done, r.n_tokens, r.retry_after_s, tuple(r.token_ts))
               for r in rep.records]
    rejections = [(t, int(p), e.reason, e.retry_after_s, e.queue_depth)
                  for t, p, e in fe.rejections]
    return {"events": [_event_key(e) for e in fe.events], "rows": rows,
            "records": records, "rejections": rejections, "sim_s": rep.sim_s,
            "rounds": fe.sched._round}


@pytest.fixture(scope="module")
def stampede(system):
    return {which: _stampede(system, which) for which in ("port", "jax")}


@pytest.mark.parametrize("part", ["events", "rejections", "records", "rows",
                                  "sim_s", "rounds"])
def test_stampede_matches_jax_exactly(stampede, part):
    assert stampede["port"][part] == stampede["jax"][part]


def test_stampede_resolves_every_request_on_the_ladder(stampede):
    """Every request ends served, shed or rejected; best effort is rejected
    and interactive p99 TTFT holds the SLO."""
    recs = stampede["port"]["records"]
    assert {r[3] for r in recs} <= {"served", "shed", "rejected"}
    assert any(r[3] == "rejected" and r[1] == 2 for r in recs)
    assert all(r[7] > 0 for r in recs if r[3] == "rejected")
    assert stampede["port"]["rows"]["stream.ttft_p99_ms"] <= 250.0
    assert 0 < stampede["port"]["rows"]["stream.reject_rate"] < 1


def test_passthrough_tokens_equal_the_schedulers(system):
    """Default FrontendConfig is a pass-through: the port scheduler's own
    tokens (and JAX's), and every event stream reassembles its
    completion."""
    cfg, params = system["port"]
    reqs = _requests("port", 8)
    ref = ContinuousScheduler(cfg, params, sched=SchedulerConfig(**SCHED),
                              max_len=32, seed=0, device="cpu")
    rids = [ref.submit(r) for r in reqs]
    want = ref.run()
    got = {}
    for which in ("port", "jax"):
        fe = _frontend(system, which,
                       clock=(PORT if which == "port" else JAX)[0].VirtualClock())
        fids = [fe.submit(r) for r in _requests(which, 8)]
        res = fe.run()
        got[which] = [(res[f][0], res[f][1].tolist()) for f in fids]
        for fid in fids:
            evs = [e for e in fe.events if e.rid == fid]
            assert [e.token for e in evs[:-1]] == res[fid][1].tolist()
            assert isinstance(evs[-1], (tfe.Finish, jfe.Finish))
    assert got["port"] == got["jax"]
    assert got["port"] == [("served", want[r].tokens.tolist()) for r in rids]


def test_breaker_hysteresis(system):
    """Opens at the high watermark and sheds BEST_EFFORT, stays open in the
    band, closes only at the low watermark."""
    fe = _frontend(system, "port", clock=tfe.VirtualClock(),
                   frontend=tfe.FrontendConfig(max_queue=8, breaker_high=0.75,
                                               breaker_low=0.25))
    req = _requests("port", 1)[0]
    for depth in (4, 5):
        fe.queue_depth = lambda d=depth: d
        fe._update_breaker()
        assert not fe.breaker_open
    fe.queue_depth = lambda: 6
    with pytest.raises(tfe.Overloaded) as ei:
        fe.submit(req, tfe.Priority.BEST_EFFORT)
    assert ei.value.reason == "breaker" and fe.breaker_open
    fe.queue_depth = lambda: 4
    with pytest.raises(tfe.Overloaded):
        fe.submit(req, tfe.Priority.BEST_EFFORT)
    fe.queue_depth = lambda: 2
    fe._update_breaker()
    assert not fe.breaker_open
    fid = fe.submit(req, tfe.Priority.BEST_EFFORT)
    del fe.queue_depth
    assert fe.run()[fid][0] == "served"


def test_feed_order_is_priority_then_edf(system):
    fe = _frontend(system, "port", clock=tfe.VirtualClock(),
                   frontend=tfe.FrontendConfig(max_queue=16, feed_depth=1))
    order = []
    orig = fe.sched.submit

    def spy(req, **kw):
        order.append(req.max_new_tokens)
        return orig(req, **kw)

    fe.sched.submit = spy
    rng = np.random.RandomState(0)
    for tag, dl, prio in ((3, None, "best-effort"), (4, 50.0, "batch"),
                          (5, 90.0, "interactive"), (6, 40.0, "interactive"),
                          (7, None, "interactive")):
        fe.submit(Request(tokens=rng.randint(0, 512, 4), max_new_tokens=tag,
                          deadline_s=dl), tfe.Priority.parse(prio))
    results = fe.run()
    assert order == [6, 5, 7, 4, 3]
    assert all(st == "served" for st, _ in results.values())


def test_overloaded_and_deadline_shed(system):
    """A full queue rejects, typed, with a retry hint; a waiter whose
    deadline lapses is shed without a prefill; the rest are served."""
    clock = tfe.VirtualClock()
    fe = _frontend(system, "port", clock=clock,
                   frontend=tfe.FrontendConfig(max_queue=3))
    rng = np.random.RandomState(0)
    ok = fe.submit(Request(tokens=rng.randint(0, 512, 4), max_new_tokens=4))
    dead = fe.submit(Request(tokens=rng.randint(0, 512, 4), max_new_tokens=4,
                             deadline_s=0.05))
    slow = fe.submit(Request(tokens=rng.randint(0, 512, 4), max_new_tokens=4,
                             deadline_s=60.0))
    with pytest.raises(tfe.Overloaded) as ei:
        fe.submit(Request(tokens=rng.randint(0, 512, 4), max_new_tokens=4))
    assert ei.value.reason == "queue full" and ei.value.queue_depth == 3
    assert ei.value.retry_after_s > 0
    clock.now += 0.1
    results = fe.run()
    assert results[ok][0] == results[slow][0] == "served"
    assert results[dead][0] == "shed" and len(results[dead][1]) < 4


def test_config_validation_and_clock_sharing(system):
    for bad in (dict(max_queue=0), dict(slo_ms=0.0), dict(breaker_low=0.9),
                dict(class_deadline_ms=(None,)), dict(ewma=0.0),
                dict(feed_depth=0), dict(preempt_wait_ms=-1.0)):
        with pytest.raises(ValueError):
            tfe.FrontendConfig(**bad)
    with pytest.raises(ValueError, match="unknown priority"):
        tfe.Priority.parse("urgent")
    fe = _frontend(system, "port", clock=tfe.VirtualClock())
    with pytest.raises(ValueError, match="share the clock"):
        tfe.drive_closed_loop(fe, [], clock=tfe.VirtualClock(), round_s=0.01)


async def _collect(aiter):
    return [ev async for ev in aiter]


def test_async_stream_matches_run(system):
    reqs = _requests("port", 2)

    async def go():
        fe = _frontend(system, "port", clock=tfe.VirtualClock())
        server = asyncio.ensure_future(fe.serve_forever())
        evs = [await _collect(fe.stream(r)) for r in reqs]
        fe.close()
        await server
        return evs

    evs = asyncio.run(go())
    ref = _frontend(system, "port", clock=tfe.VirtualClock())
    fids = [ref.submit(r) for r in reqs]
    want = ref.run()
    for fid, stream in zip(fids, evs):
        assert isinstance(stream[0], tfe.FirstToken)
        assert isinstance(stream[-1], tfe.Finish)
        assert stream[-1].status == "served"
        assert [e.token for e in stream[:-1]] == want[fid][1].tolist()


def test_async_wait_turns_rejection_into_backpressure(system):
    async def go():
        fe = _frontend(system, "port",
                       frontend=tfe.FrontendConfig(max_queue=1))
        r1, r2 = _requests("port", 2)
        server = asyncio.ensure_future(fe.serve_forever())
        first = asyncio.ensure_future(_collect(fe.stream(r1)))
        await asyncio.sleep(0)
        second = await _collect(fe.stream(r2, wait=True))
        fe.close()
        await server
        return await first, second

    evs1, evs2 = asyncio.run(go())
    assert evs1[-1].status == "served" and evs2[-1].status == "served"
