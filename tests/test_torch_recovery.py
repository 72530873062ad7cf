"""The port's request journal, crash recovery and priority preemption on
the CPU (reduced qwen2-0.5b, JAX weights bridged by
``backbone_params_from_numpy``).

Against the JAX package: the journal of one frontend run (every record,
and the file's bytes line for line); a scripted crash swept over every
scheduling round of tests/test_recovery.py's pinned workload, the merged
results equal to JAX's crash-free run and, at one round, to JAX's own
recovery; a crash at round 0 replaying never-admitted submissions.
Within the port: a torn final line is dropped and the request that lost
only its finish record resolves from its chunks, and preemption suspends
the worst pooled row for an interactive arrival."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import backbone as jbb  # noqa: E402
from repro.serve import faults as jfaults  # noqa: E402
from repro.serve import frontend as jfe  # noqa: E402
from repro.serve import recovery as jrec  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.scheduler import SchedulerConfig as JaxSchedulerConfig  # noqa: E402
from repro_torch.bridge import backbone_params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.serve import faults as tfaults  # noqa: E402
from repro_torch.serve import frontend as tfe  # noqa: E402
from repro_torch.serve import recovery as trec  # noqa: E402
from repro_torch.serve.engine import Request  # noqa: E402
from repro_torch.serve.scheduler import SchedulerConfig  # noqa: E402

SCHED = dict(buckets=(8, 16), max_slots=2, prefill_group=1, chunk=2)
PORT = (tfe, SchedulerConfig, Request, tfaults, trec)
JAX = (jfe, JaxSchedulerConfig, JaxRequest, jfaults, jrec)
PRIOS = ("INTERACTIVE", "BATCH", "BEST_EFFORT", "INTERACTIVE")


@pytest.fixture(scope="module")
def system():
    jcfg = jax_get_config("qwen2-0.5b").reduced()
    cfg = get_config("qwen2-0.5b").reduced()
    jp = jbb.init_params(jcfg, jax.random.PRNGKey(0))
    tp = backbone_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                    cfg, device="cpu")
    return {"port": (cfg, tp), "jax": (jcfg, jp)}


def _mods(which):
    return PORT if which == "port" else JAX


def _frontend(system, which, *, frontend=None, clock=None, faults=None,
              journal=None, **sched_kw):
    fe_mod, conf = _mods(which)[:2]
    cfg, params = system[which]
    extra = {"device": "cpu"} if which == "port" else {}
    return fe_mod.StreamingFrontend(
        cfg, params, frontend=frontend, sched=conf(**{**SCHED, **sched_kw}),
        max_len=48, seed=0, clock=clock, faults=faults, journal=journal,
        **extra)


def _requests(which, n, seed=0, max_new=5):
    cls = _mods(which)[2]
    rng = np.random.RandomState(seed)
    return [cls(tokens=rng.randint(0, 512, int(rng.choice((4, 8, 12)))),
                max_new_tokens=max_new) for _ in range(n)]


def _drive(fe, clock, round_s=0.01):
    while fe.has_work():
        clock.now += round_s
        fe.step()
    out, fe._results = fe._results, {}
    return out


def _tokens(results):
    return {rid: (st, np.asarray(t).tolist()) for rid, (st, t) in results.items()}


def _crash_run(system, which, crash_round):
    """tests/test_recovery.py's sweep workload with a journal attached and
    the engine dying at ``crash_round``; then recovery into a fresh
    frontend.  Returns (merged results, Finish rids before and after the
    crash, the journal's records)."""
    fe_mod, _, _, flt, rec = _mods(which)
    journal = rec.RequestJournal()
    clock = fe_mod.VirtualClock()
    fe = _frontend(system, which, clock=clock, journal=journal,
                   faults=flt.FaultInjector((flt.EngineCrash(crash_round),)))
    for q, p in zip(_requests(which, 4, max_new=4), PRIOS):
        fe.submit(q, fe_mod.Priority[p])
    with pytest.raises(flt.EngineCrashError):
        _drive(fe, clock)
    pre = {ev.rid for ev in fe.events if isinstance(ev, fe_mod.Finish)}
    clock2 = fe_mod.VirtualClock(clock.now)
    fe2 = _frontend(system, which, clock=clock2)
    merged = rec.recover(fe2, journal, drive=lambda: _drive(fe2, clock2))
    post = {ev.rid for ev in fe2.events if isinstance(ev, fe_mod.Finish)}
    return _tokens(merged), pre, post, journal.events


@pytest.fixture(scope="module")
def reference(system):
    """The sweep workload crash-free through both packages:
    {which: (results, rounds)}."""
    out = {}
    for which in ("port", "jax"):
        fe_mod = _mods(which)[0]
        clock = fe_mod.VirtualClock()
        fe = _frontend(system, which, clock=clock)
        for q, p in zip(_requests(which, 4, max_new=4), PRIOS):
            fe.submit(q, fe_mod.Priority[p])
        out[which] = (_tokens(_drive(fe, clock)), fe.sched._round)
    return out


def test_crash_free_reference_matches_jax(reference):
    assert reference["port"] == reference["jax"]
    assert reference["port"][1] >= 4               # the sweep is not trivial


def test_crash_sweep_recovers_every_round(system, reference):
    """A crash at every scheduling round: the merged results cover each
    admitted request once (no Finish delivered twice) with the crash-free
    run's tokens, which are JAX's."""
    want, n_rounds = reference["jax"]
    for r in range(n_rounds):
        merged, pre, post, _ = _crash_run(system, "port", r)
        assert not pre & post, f"round {r}: duplicate Finish delivery"
        assert merged == want, f"round {r}: recovery diverged"


def test_crash_recovery_matches_jax_at_one_round(system):
    """One mid-run crash through both packages: the same journal records
    up to the crash, the same pre- and post-crash Finish sets, the same
    merged results."""
    port, jx = _crash_run(system, "port", 3), _crash_run(system, "jax", 3)
    assert port == jx
    assert port[1] and port[2]                     # finishes on both sides


def test_journal_records_and_file_equal_jax(system, tmp_path):
    """The journal of one pass-through run: every record equal to JAX's,
    and the file's lines (crc32 + canonical JSON) equal byte for byte."""
    records, raw = {}, {}
    for which in ("port", "jax"):
        fe_mod, rec = _mods(which)[0], _mods(which)[4]
        path = tmp_path / f"{which}.jsonl"
        with rec.RequestJournal(str(path)) as j:
            fe = _frontend(system, which, clock=fe_mod.VirtualClock(), journal=j)
            fids = [fe.submit(q) for q in _requests(which, 6)]
            got = fe.run()
        records[which] = j.events
        raw[which] = path.read_bytes()
        assert sorted(got) == fids
    assert records["port"] == records["jax"]
    assert raw["port"] == raw["jax"]
    assert trec.RequestJournal.read(str(tmp_path / "jax.jsonl")) == records["jax"]
    kinds = {r["ev"] for r in records["port"]}
    assert kinds == {"submit", "admit", "chunk", "finish"}


def test_torn_final_line_is_dropped_and_recovered(system, tmp_path):
    """A torn last record fails its crc and is dropped; the request that
    lost only its finish record resolves from its chunks, nothing is
    replayed, and every result is the uninterrupted run's."""
    path = str(tmp_path / "journal.jsonl")
    clock = tfe.VirtualClock()
    with trec.RequestJournal(path) as j:
        fe = _frontend(system, "port", clock=clock, journal=j)
        fids = [fe.submit(q) for q in _requests("port", 3, max_new=4)]
        want = _drive(fe, clock)
    whole = trec.RequestJournal.read(path)
    assert whole == j.events and whole[-1]["ev"] == "finish"
    with open(path, "rb") as f:
        raw = f.read()
    with open(path, "wb") as f:
        f.write(raw[:-4])
    events = trec.RequestJournal.read(path)
    assert events == whole[:-1]
    assert not trec.recovery_plan(events).replay
    merged = trec.recover(_frontend(system, "port", clock=tfe.VirtualClock()),
                          events)
    assert _tokens(merged) == _tokens(want) and set(merged) == set(fids)
    with pytest.raises(ValueError, match="unknown journal event"):
        trec.RequestJournal().append("resume", 0, 0.0)


def test_never_admitted_submissions_replay(system, reference):
    """A crash at round 0: every request was journaled as submitted and
    never admitted; recovery replays each from its prompt alone."""
    j = trec.RequestJournal()
    clock = tfe.VirtualClock()
    fe = _frontend(system, "port", clock=clock, journal=j,
                   faults=tfaults.FaultInjector((tfaults.EngineCrash(0),)))
    for q in _requests("port", 4, max_new=4):
        fe.submit(q)
    with pytest.raises(tfaults.EngineCrashError):
        _drive(fe, clock)
    plan = trec.recovery_plan(j.events)
    assert [it.rid for it in plan.replay] == [0, 1, 2, 3]
    assert all(len(it.generated) == 0 for it in plan.replay)
    clock2 = tfe.VirtualClock()
    fe2 = _frontend(system, "port", clock=clock2)
    merged = trec.recover(fe2, j, drive=lambda: _drive(fe2, clock2))
    want = reference["port"][0]
    assert {r: t for r, (_, t) in _tokens(merged).items()} == \
        {r: t for r, (_, t) in want.items()}


def test_preemption_suspends_the_worst_row(system):
    """A BATCH and a BEST_EFFORT hog hold the 2-slot pool; an INTERACTIVE
    arrival suspends the BEST_EFFORT row (the lowest class), starts its
    stream earlier than without preemption, and every request still serves
    the tokens of a run with no preemption (the victim's resumed stream
    included)."""
    hogs = _requests("port", 2, seed=1, max_new=10)
    inter = _requests("port", 1, seed=2, max_new=4)[0]

    def run(preempt):
        clock = tfe.VirtualClock()
        fe = _frontend(system, "port", clock=clock, preempt=preempt,
                       frontend=tfe.FrontendConfig(max_queue=8, feed_depth=1,
                                                   preempt_wait_ms=0.0))
        fids = [fe.submit(h, p) for h, p in
                zip(hogs, (tfe.Priority.BATCH, tfe.Priority.BEST_EFFORT))]
        while fe.sched._free_slots() and fe.has_work():
            clock.now += 0.01
            fe.step()
        fids.append(fe.submit(inter, tfe.Priority.INTERACTIVE))
        victims = set()
        while fe.has_work():
            clock.now += 0.01
            fe.step()
            victims |= {rid for rid, r in fe._reqs.items()
                        if isinstance(r, tfe.Suspended)}
        out, fe._results = fe._results, {}
        ttft = {ev.rid: ev.t for ev in fe.events
                if isinstance(ev, tfe.FirstToken)}
        return [out[f] for f in fids], ttft[fids[2]], victims, fids

    got_p, t_p, victims, fids = run(True)
    got_n, t_n, none, _ = run(False)
    assert victims == {fids[1]} and not none
    assert _tokens(dict(enumerate(got_p))) == _tokens(dict(enumerate(got_n)))
    assert all(st == "served" for st, _ in got_p)
    assert t_p < t_n
