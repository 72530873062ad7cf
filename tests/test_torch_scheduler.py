"""The port's continuous-batching scheduler on the CPU (reduced qwen2-0.5b,
JAX weights bridged by ``backbone_params_from_numpy``).

Against the JAX package's ``ContinuousScheduler`` on the same queues:
greedy tokens per rid on a mixed queue with a staged admission,
per-request EOS and budgets, in both overlap modes; the stream_cb calls
and the ``sched.*`` counters and gauges of those runs; deadline
evictions under one injected fake clock (queued, staging and pooled:
rids, rounds, ``timed_out`` and partial tokens); a stalled pool leaving
through deadline eviction and a scripted crash raising in JAX's round;
suspend then ``submit_suspended``.

Within the port, the invariants of tests/test_serve_scheduler.py and
tests/test_chunked_prefill.py, held against the port's own
one-request-at-a-time path.  Two JAX tests have no counterpart here:
``test_steady_state_decode_zero_recompiles`` and the compile half of
``test_long_prompts_bucket_at_page_granularity`` count jit compilations,
which eager PyTorch has none of (the page-granular buckets are held here
through the widths that reach ``prefill``), and
``test_mesh_engine_routes_equal_lengths_through_scheduler`` needs
``mesh=``, which waits for ROADMAP Queue 1 item 7 (its refusal is held
here).  The prefix-cache branch is held in tests/test_torch_prefix_cache.py."""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import backbone as jbb  # noqa: E402
from repro.serve import faults as jfaults  # noqa: E402
from repro.serve import telemetry as jtel  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.scheduler import ContinuousScheduler as JaxScheduler  # noqa: E402
from repro.serve.scheduler import SchedulerConfig as JaxSchedulerConfig  # noqa: E402
from repro_torch.bridge import backbone_params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import backbone as tbb  # noqa: E402
from repro_torch.serve import faults as tfaults  # noqa: E402
from repro_torch.serve import telemetry as ttel  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.scheduler import (  # noqa: E402
    ContinuousScheduler,
    SchedulerConfig,
    SlotError,
    supports_continuous_batching,
)

MAX_LEN = 64
BASE = dict(buckets=(8, 16, 32), max_slots=4, prefill_group=2, chunk=4)
FAULT = dict(buckets=(8, 16, 32), max_slots=2, prefill_group=1, chunk=2,
             prefill_segment=8)
PORT = (ContinuousScheduler, SchedulerConfig, Request, tfaults, ttel)
JAX = (JaxScheduler, JaxSchedulerConfig, JaxRequest, jfaults, jtel)


@pytest.fixture(scope="module")
def system():
    jcfg = jax_get_config("qwen2-0.5b").reduced()
    cfg = get_config("qwen2-0.5b").reduced()
    jp = jbb.init_params(jcfg, jax.random.PRNGKey(0))
    tp = backbone_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                    cfg, device="cpu")
    return {"port": (cfg, tp), "jax": (jcfg, jp)}


def _make(system, which, *, clock=None, faults=None, telemetry=None, **kw):
    cls, conf = (PORT if which == "port" else JAX)[:2]
    cfg, params = system[which]
    extra = {"device": "cpu"} if which == "port" else {}
    return cls(cfg, params, max_len=MAX_LEN, sched=conf(**kw), clock=clock,
               faults=faults, telemetry=telemetry, **extra)


def _req(which, tokens, n, **kw):
    cls = (PORT if which == "port" else JAX)[2]
    return cls(tokens=tokens, max_new_tokens=n, **kw)


def _reference(system, req) -> list:
    """One-request-at-a-time greedy decode through the port's
    equal-length path."""
    cfg, tp = system["port"]
    eng = ServeEngine(cfg, tp, max_len=MAX_LEN, device="cpu")
    return eng.generate([req])[0].tokens.tolist()


class _Clock:
    """Deterministic wall clock: every read advances by one tick."""

    def __init__(self, tick: float):
        self.t = 0.0
        self.tick = tick

    def __call__(self) -> float:
        self.t += self.tick
        return self.t


# ------------------------------------------------------ against JAX ------

MIXED_LENS = (8, 16, 40, 5, 27, 16, 8, 11)
MIXED_NEW = (4, 7, 5, 3, 9, 2, 6, 4)


@pytest.fixture(scope="module")
def mixed(system):
    """The mixed queue through both packages, both overlap modes, with
    telemetry on and a stream_cb attached: {overlap: {which: record}}.
    Prompts 40 and 27 stage (buckets 64 and 32 > prefill_segment 16);
    two requests carry an EOS that their greedy decode emits."""
    rng = np.random.RandomState(6)
    prompts = [rng.randint(0, 512, L) for L in MIXED_LENS]
    # EOS ids: a token each of requests 1 and 4 emits at step >= 2
    probe = _make(system, "port", **BASE, prefill_segment=16)
    rids = [probe.submit(_req("port", p, n)) for p, n in zip(prompts, MIXED_NEW)]
    outs = probe.run()
    eos = [-1] * len(prompts)
    for i in (1, 4):
        eos[i] = int(outs[rids[i]].tokens[2])
    out = {}
    for overlap in (True, False):
        out[overlap] = {}
        for which in ("port", "jax"):
            tel = (ttel if which == "port" else jtel).Telemetry(enabled=True)
            sched = _make(system, which, telemetry=tel, **BASE,
                          prefill_segment=16, overlap=overlap)
            stream = []
            sched.stream_cb = lambda rid, toks: stream.append(
                (rid, [int(t) for t in toks]))
            rids = [sched.submit(_req(which, p, n, eos_id=e))
                    for p, n, e in zip(prompts, MIXED_NEW, eos)]
            rounds = []
            while sched.has_work():
                rounds.append(sorted(sched.step()))
            res = sched.run()
            counters = {(c.name, c.labels): c.value
                        for c in tel.metrics.instruments()
                        if c.name.startswith("sched.")}
            out[overlap][which] = {
                "tokens": [res[r].tokens.tolist() for r in rids],
                "rounds": rounds, "stream": stream, "counters": counters,
                "prompts": prompts, "eos": eos}
    return out


@pytest.mark.parametrize("overlap", [True, False])
def test_mixed_queue_tokens_match_jax(mixed, overlap):
    port, jx = mixed[overlap]["port"], mixed[overlap]["jax"]
    assert port["tokens"] == jx["tokens"]
    assert port["rounds"] == jx["rounds"]
    for toks, n, e in zip(port["tokens"], MIXED_NEW, port["eos"]):
        assert len(toks) == n or toks[-1] == e
    assert any(e >= 0 and len(t) < n and t[-1] == e
               for t, n, e in zip(port["tokens"], MIXED_NEW, port["eos"]))


@pytest.mark.parametrize("overlap", [True, False])
def test_stream_and_counters_match_jax(mixed, overlap):
    """One pinned run: every stream_cb call in order, and every sched.*
    counter (admitted by path, evicted by reason) and gauge."""
    port, jx = mixed[overlap]["port"], mixed[overlap]["jax"]
    assert port["stream"] and port["stream"] == jx["stream"]
    assert port["counters"] == jx["counters"]
    assert port["counters"][("sched.admitted", (("path", "staged"),))] == 2
    assert port["counters"][("sched.admitted", (("path", "group"),))] == 6


def _drive(sched, which, reqs):
    """Run to the end by step(), noting for each deadline-evicted rid the
    round and the state it was in before that round: queued, staging or
    pooled."""
    rids = [sched.submit(_req(which, t, n, **kw)) for t, n, kw in reqs]
    where, evicted, rnd = {}, [], 0
    while sched.has_work():
        where = {rid: "queued" for rid, _ in sched._queue}
        where.update({st["rid"]: "staging" for st in sched._staging})
        where.update({rid: "pooled" for rid in sched._slot_rid
                      if rid is not None and rid not in where})
        for rid in sched.step():
            if sched._results[rid].timed_out:
                evicted.append((rnd, rid, where[rid]))
        rnd += 1
    res = sched.run()
    return evicted, [(res[r].tokens.tolist(), res[r].timed_out) for r in rids]


def _deadline_queue(seed):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 512, 8), 40, {"deadline_s": 0.075}),
            (rng.randint(0, 512, 8), 4, {}),
            (rng.randint(0, 512, 8), 4, {"deadline_s": 0.001}),
            (rng.randint(0, 512, 32), 4, {"deadline_s": 0.055}),
            (rng.randint(0, 512, 16), 6, {})]


@pytest.mark.parametrize("overlap", [False, True])
def test_deadline_evictions_match_jax(system, overlap):
    """Under the same fake clock: the same rids leave by deadline in the
    same rounds from the same states (queued, staging and pooled each
    occur), with JAX's timed_out flags and partial tokens; the pooled
    evictee's tokens are a prefix of its undisturbed decode."""
    reqs = _deadline_queue(7)
    runs = {which: _drive(_make(system, which, clock=_Clock(0.01),
                                **FAULT, overlap=overlap), which, reqs)
            for which in ("port", "jax")}
    assert runs["port"] == runs["jax"]
    evicted, results = runs["port"]
    assert {w for _, _, w in evicted} == {"queued", "staging", "pooled"}
    toks, timed_out = results[0]
    assert timed_out and 0 < len(toks) < 40
    full = _reference(system, _req("port", reqs[0][0], 40))
    assert toks == full[:len(toks)]
    assert not results[1][1] and not results[4][1]


@pytest.mark.parametrize("overlap", [False, True])
def test_stalled_pool_exits_via_deadline_eviction(system, overlap):
    """A permanently stalled pool: every request leaves by deadline, as in
    JAX, and no slot stays held."""
    rng = np.random.RandomState(9)
    prompts = [rng.randint(0, 512, 8) for _ in range(4)]
    out = {}
    for which, (_, _, _, flt, _) in (("port", PORT), ("jax", JAX)):
        sched = _make(system, which, clock=_Clock(0.01), overlap=overlap,
                      faults=flt.FaultInjector((flt.SlotPoolStall(),)),
                      **FAULT)
        rids = [sched.submit(_req(which, p, 4, deadline_s=0.04))
                for p in prompts]
        res = sched.run()
        assert not sched._slots.any_occupied()
        out[which] = [(res[r].tokens.tolist(), res[r].timed_out) for r in rids]
    assert out["port"] == out["jax"]
    assert all(t for _, t in out["port"])


def test_scripted_crash_raises_in_jaxs_round(system):
    rng = np.random.RandomState(10)
    prompts = [rng.randint(0, 512, L) for L in (8, 16, 8)]
    rounds = {}
    for which, (_, _, _, flt, _) in (("port", PORT), ("jax", JAX)):
        sched = _make(system, which, faults=flt.FaultInjector(
            (flt.EngineCrash(3),)), **FAULT)
        for p in prompts:
            sched.submit(_req(which, p, 6))
        with pytest.raises(flt.EngineCrashError, match="round 3"):
            while True:
                sched.step()
        rounds[which] = sched._round
    assert rounds["port"] == rounds["jax"] == 4


def _suspend_resume(system, which, prompts, victim_round=2):
    sched = _make(system, which, **BASE)
    rids = [sched.submit(_req(which, p, 12)) for p in prompts]
    for _ in range(victim_round):
        sched.step()
    sus = sched.suspend(rids[0])
    assert sus is not None and 0 < len(sus.generated) < 12
    new = sched.submit_suspended(sus)
    res = sched.run()
    return [res[new].tokens.tolist()] + [res[r].tokens.tolist()
                                         for r in rids[1:]]


def test_suspend_resume_matches_jax_and_uninterrupted(system):
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, 512, L) for L in (8, 16, 11)]
    port = _suspend_resume(system, "port", prompts)
    assert port == _suspend_resume(system, "jax", prompts)
    assert port == [_reference(system, _req("port", p, 12)) for p in prompts]


# ------------------------------------------------ within the port --------


def _port_run(system, reqs, **kw):
    sched = _make(system, "port", **{**BASE, **kw})
    rids = [sched.submit(r) for r in reqs]
    outs = sched.run()
    assert sorted(outs) == sorted(rids)
    return [outs[r].tokens.tolist() for r in rids], sched


def test_mixed_queue_matches_per_request_greedy(system):
    rng = np.random.RandomState(0)
    lengths = [8, 16, 32] * 4
    rng.shuffle(lengths)
    reqs = [Request(tokens=rng.randint(0, 512, L), max_new_tokens=4)
            for L in lengths]
    got, _ = _port_run(system, reqs)
    assert got == [_reference(system, r) for r in reqs]


def test_bucket_padding_never_leaks(system):
    """Off-bucket prompts (5 -> 8, 11 -> 16, 27 -> 32) decode to the
    unpadded reference's tokens."""
    rng = np.random.RandomState(1)
    reqs = [Request(tokens=rng.randint(0, 512, L), max_new_tokens=5)
            for L in (5, 11, 27, 5)]
    got, _ = _port_run(system, reqs)
    assert got == [_reference(system, r) for r in reqs]


def test_evict_inject_preserves_other_slots_bitwise(system):
    """A 2-slot pool over staggered budgets forces evict/inject cycles
    mid-decode: tokens stay the reference's, and across every round each
    slot that keeps its occupant keeps its cache rows below its depth bit
    for bit (what a neighbour's evict/inject writes never reaches)."""
    rng = np.random.RandomState(2)
    lens, buds = [8, 16, 8, 32, 16, 8], [2, 9, 5, 3, 7, 4]
    reqs = [Request(tokens=rng.randint(0, 512, L), max_new_tokens=n)
            for L, n in zip(lens, buds)]
    sched = _make(system, "port", **{**BASE, "max_slots": 2,
                                     "prefill_group": 1, "chunk": 2,
                                     "overlap": False})
    rids = [sched.submit(r) for r in reqs]
    prev, checked = None, 0
    while sched.has_work():
        sched.step()
        cur = (list(sched._slot_rid),
               {n: sched._pool["cache"][n].clone() for n in ("k", "v")},
               sched._pool["cache_len"].clone())
        if prev is not None:
            for s, rid in enumerate(cur[0]):
                if rid is not None and prev[0][s] == rid:
                    d = int(prev[2][s])
                    for n in ("k", "v"):
                        assert torch.equal(cur[1][n][:, s, :d],
                                           prev[1][n][:, s, :d])
                    checked += 1
        prev = cur
    res = sched.run()
    assert checked > 0
    assert [res[r].tokens.tolist() for r in rids] == \
        [_reference(system, r) for r in reqs]


def test_inject_into_one_slot_leaves_the_others_bitwise(system):
    """Direct: an evict and an inject of slot 0 change no bit of slots
    1..3's cache, tokens, depth or budget."""
    rng = np.random.RandomState(3)
    sched = _make(system, "port", **BASE)
    for L in (8, 16, 8, 11):
        sched.submit(Request(tokens=rng.randint(0, 512, L), max_new_tokens=30))
    sched.step()
    sched.step()
    before = {k: (v.clone() if torch.is_tensor(v)
                  else {n: t.clone() for n, t in v.items()})
              for k, v in sched._pool.items()}
    sched._complete([0], np.zeros((4, MAX_LEN), np.int64), np.zeros(4, int))
    cfg, tp = system["port"]
    logits, rows, _ = tbb.prefill(cfg, tp, {"tokens": torch.ones((1, 32),
                                                                 dtype=torch.long)},
                                  max_len=32)
    sched._inject(np.array([0]), rows, logits, np.array([32]), np.array([-1]),
                  np.array([5]), np.zeros(1, np.float32))
    for k, v in sched._pool.items():
        for n, t in (v.items() if isinstance(v, dict) else [(k, v)]):
            ref = before[k][n] if isinstance(v, dict) else before[k]
            assert torch.equal(t[:, 1:] if k == "cache" else t[1:],
                               ref[:, 1:] if k == "cache" else ref[1:]), n


def test_no_request_starved_across_buckets(system):
    rng = np.random.RandomState(3)
    sched = _make(system, "port", buckets=(8, 16, 32), max_slots=2,
                  prefill_group=2, chunk=2)
    rids = [sched.submit(Request(tokens=rng.randint(0, 512, 32 if i == 4 else 8),
                                 max_new_tokens=3)) for i in range(10)]
    outs = sched.run()
    assert sorted(outs) == sorted(rids)
    assert all(len(outs[r].tokens) == 3 for r in rids)


def test_greedy_rows_unchanged_beside_sampled(system):
    """Per-slot EOS and temperature: a greedy row keeps its reference
    tokens beside a sampled row, an EOS stops only its own request, and a
    sampled queue repeats itself under one seed."""
    rng = np.random.RandomState(4)
    p8, p16 = rng.randint(0, 512, 8), rng.randint(0, 512, 16)
    ref8 = _reference(system, Request(tokens=p8, max_new_tokens=6))
    eos = ref8[2]
    stop = ref8.index(eos) + 1
    reqs = [Request(tokens=p8, max_new_tokens=6, eos_id=eos),
            Request(tokens=p16, max_new_tokens=6, temperature=1.3),
            Request(tokens=p8, max_new_tokens=6),
            Request(tokens=p16, max_new_tokens=6, temperature=0.8)]
    a, _ = _port_run(system, reqs)
    b, _ = _port_run(system, reqs)
    assert a == b
    assert a[0] == ref8[:stop] and a[2] == ref8
    assert len(a[1]) == 6 and all(0 <= t < 512 for t in a[1])
    greedy16 = _reference(system, Request(tokens=p16, max_new_tokens=6))
    assert a[1] != greedy16 or a[3] != greedy16


def test_overlap_matches_serialized_exactly(system):
    rng = np.random.RandomState(6)
    reqs = [Request(tokens=rng.randint(0, 512, L), max_new_tokens=4)
            for L in (8, 16, 50, 5, 27, 16, 8, 40)]
    a, _ = _port_run(system, reqs, prefill_segment=16, overlap=True)
    b, _ = _port_run(system, reqs, prefill_segment=16, overlap=False)
    assert a == b


def test_stale_snapshot_skips_readmitted_slot(system):
    rng = np.random.RandomState(15)
    pa, pb = rng.randint(0, 512, 8), rng.randint(0, 512, 8)
    sched = _make(system, "port", clock=_Clock(0.005), overlap=True,
                  **{**FAULT, "max_slots": 1})
    ra = sched.submit(Request(tokens=pa, max_new_tokens=40, deadline_s=0.06))
    rb = sched.submit(Request(tokens=pb, max_new_tokens=4))
    outs = sched.run()
    assert sorted(outs) == [ra, rb]
    assert outs[ra].timed_out and 0 < len(outs[ra].tokens) < 40
    ref_a = _reference(system, Request(tokens=pa, max_new_tokens=40))
    assert outs[ra].tokens.tolist() == ref_a[:len(outs[ra].tokens)]
    assert not outs[rb].timed_out
    assert outs[rb].tokens.tolist() == _reference(
        system, Request(tokens=pb, max_new_tokens=4))
    assert not sched._slots.any_occupied() and sched._pending is None


def test_long_prompts_bucket_at_page_granularity(system, monkeypatch):
    """Prompts above every bucket round up to the next page: four long
    lengths reach prefill at one width, and decode to the reference."""
    widths = []
    real = tbb.prefill

    def spy(cfg, params, batch, **kw):
        widths.append((batch["tokens"].shape[1], kw["max_len"]))
        return real(cfg, params, batch, **kw)

    monkeypatch.setattr(tbb, "prefill", spy)
    sched = _make(system, "port", buckets=(8, 16), max_slots=4,
                  prefill_group=2, chunk=4, page_size=16, prefill_segment=0)
    assert [sched._bucket_of(n) for n in (33, 41, 63)] == [48, 48, 64]
    rng = np.random.RandomState(14)
    reqs = [Request(tokens=rng.randint(0, 512, L), max_new_tokens=4)
            for L in (33, 37, 41, 45)]
    rids = [sched.submit(r) for r in reqs]
    outs = sched.run()
    assert widths == [(48, 48), (48, 48)]
    monkeypatch.setattr(tbb, "prefill", real)
    assert [outs[r].tokens.tolist() for r in rids] == \
        [_reference(system, r) for r in reqs]


def test_deadline_churn_preserves_slot_invariants(system):
    rng = np.random.RandomState(12)
    sched = _make(system, "port", clock=_Clock(0.005), overlap=True, **FAULT)
    rids = [sched.submit(Request(tokens=rng.randint(0, 512, 8),
                                 max_new_tokens=30,
                                 deadline_s=0.03 + 0.015 * (i % 4)))
            for i in range(12)]
    outs = sched.run()
    assert sorted(outs) == sorted(rids)
    assert all(outs[r].timed_out for r in rids)
    assert not sched._slots.any_occupied() and not sched._deadlines
    assert not sched._staging and sched._pending is None
    with pytest.raises(SlotError):
        sched._slots.release(0)


def test_idle_injector_and_generous_deadlines_keep_tokens(system):
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, 512, L) for L in (8, 16, 32, 8)]

    def tokens(deadline, faults, overlap):
        sched = _make(system, "port", overlap=overlap, faults=faults, **FAULT)
        rids = [sched.submit(Request(tokens=p, max_new_tokens=4,
                                     deadline_s=deadline)) for p in prompts]
        outs = sched.run()
        assert not any(outs[r].timed_out for r in rids)
        return [outs[r].tokens.tolist() for r in rids]

    for overlap in (False, True):
        assert tokens(None, None, overlap) == tokens(
            1e6, tfaults.FaultInjector(()), overlap)


def test_bounded_stall_only_delays_decode(system):
    rng = np.random.RandomState(10)
    reqs = [Request(tokens=rng.randint(0, 512, L), max_new_tokens=4)
            for L in (8, 16, 8)]
    sched = _make(system, "port", faults=tfaults.FaultInjector(
        (tfaults.SlotPoolStall(0, 3),)), **FAULT)
    rids = [sched.submit(r) for r in reqs]
    outs = sched.run()
    assert [outs[r].tokens.tolist() for r in rids] == \
        [_reference(system, r) for r in reqs]


def test_suspend_resume_matches_uninterrupted_with_overlap_off(system):
    rng = np.random.RandomState(16)
    prompts = [rng.randint(0, 512, L) for L in (27, 8)]
    sched = _make(system, "port", **{**BASE, "overlap": False},
                  prefill_segment=16)
    rids = [sched.submit(Request(tokens=p, max_new_tokens=10)) for p in prompts]
    for _ in range(3):
        sched.step()
    sus = sched.suspend(rids[0])
    assert sus.request.tokens.tolist() == prompts[0].tolist()
    rid = sched.submit_suspended(sus)
    outs = sched.run()
    assert outs[rid].tokens.tolist() == _reference(
        system, Request(tokens=prompts[0], max_new_tokens=10))
    with pytest.raises(ValueError, match="not pooled"):
        sched.suspend(rid)


def test_steps_run_and_live(system):
    """Every chunk runs ``chunk`` steps; with telemetry enabled the live
    count is the steps in which some row ran, at most that.  Without
    telemetry nothing is counted and ``steps_live()`` says so."""
    rng = np.random.RandomState(17)

    def run(n):
        sched = _make(system, "port", telemetry=ttel.Telemetry(enabled=True),
                      **BASE)
        sched.submit(Request(tokens=rng.randint(0, 512, 8), max_new_tokens=n))
        sched.run()
        return sched

    # 1 token from prefill, 4 decode steps in the first chunk of 4
    sched = run(5)
    assert sched.steps_run == 4 and sched.steps_live() == 4
    sched = run(7)
    assert sched.steps_run == 8 and sched.steps_live() == 6
    _, sched = _port_run(system, [Request(tokens=rng.randint(0, 512, 8),
                                          max_new_tokens=7)])
    assert sched.steps_run == 8
    with pytest.raises(RuntimeError, match="telemetry"):
        sched.steps_live()


def test_ruled_out_arch_raises_and_engine_falls_back(system):
    cfg, tp = system["port"]
    swa = dataclasses.replace(cfg, sliding_window=16)
    assert not supports_continuous_batching(swa)
    with pytest.raises(ValueError, match="continuous batching"):
        ContinuousScheduler(swa, tp, max_len=MAX_LEN, device="cpu")
    eng = ServeEngine(swa, tp, max_len=MAX_LEN, device="cpu")
    rng = np.random.RandomState(5)
    reqs = [Request(tokens=rng.randint(0, 512, L), max_new_tokens=2)
            for L in (8, 12, 8)]
    outs = eng.generate(reqs)
    assert eng._sched is None and [len(c.tokens) for c in outs] == [2, 2, 2]
    assert outs[1].tokens.tolist() == eng.generate([reqs[1]])[0].tokens.tolist()
    with pytest.raises(ValueError, match="deadlines"):
        eng.generate([Request(tokens=reqs[0].tokens, deadline_s=1.0)])


@pytest.mark.parametrize("field,value", [
    ("prefix_cache", True), ("prefix_hot_pages", 64), ("kv_tier_mb", 1.0),
    ("kv_tier_bits", 4), ("preempt", True)])
def test_prefix_and_frontend_fields_raise(system, field, value):
    """The name dates from when the port raised for these fields off their
    defaults.  Their consumers (the prefix cache, the streaming frontend)
    are ported now, so the test checks that each field reaches its
    consumer: the prefix cache's budgets and bits, and ``preempt`` for the
    frontend to read; without ``prefix_cache`` no cache is built."""
    sched = _make(system, "port", **{"prefix_cache": True, field: value})
    assert getattr(sched.sched, field) == value
    pc = sched.prefix
    assert (pc.hot_pages, pc.cold_bytes, pc.bits) == (
        sched.sched.prefix_hot_pages, int(sched.sched.kv_tier_mb * (1 << 20)),
        sched.sched.kv_tier_bits)
    if field != "prefix_cache":
        assert _make(system, "port", **{field: value}).prefix is None


def test_unported_options_raise(system):
    """``mesh=``, the one option still to port, raises; ``prefix_cache``,
    which once raised here, now builds a cache; a request past max_len or
    with extras is refused."""
    cfg, tp = system["port"]
    assert _make(system, "port", prefix_cache=True).prefix is not None
    with pytest.raises(NotImplementedError, match="item 7"):
        ContinuousScheduler(cfg, tp, mesh=object(), device="cpu")
    sched = _make(system, "port", **BASE)
    with pytest.raises(ValueError, match="max_len"):
        sched.submit(Request(tokens=np.zeros(60, np.int64), max_new_tokens=8))
    with pytest.raises(ValueError, match="token-only"):
        sched.submit(Request(tokens=np.zeros(4, np.int64), extras={}))
