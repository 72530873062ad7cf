"""The port's shared-prefix page cache and the scheduler's prefix branch on
the CPU (reduced qwen2-0.5b, JAX weights bridged by
``backbone_params_from_numpy``).

Against the JAX package: ``page_keys`` bytes; the cold tier's codebook
(``compress.quantize.linspace_f32``) against ``jnp.linspace`` bitwise; one
pin / release / park / demote / promote sequence on the same page arrays
through both ``PrefixCache``s (stats, tiers, cold bytes, every cold blob
byte for byte, promoted pages bitwise); the shared workload of
tests/test_prefix_cache.py through both schedulers in both overlap modes
(tokens per rid, ``prefix.*`` gauges, ``sched.*`` counters); staged
prompts seeding from shared pages; a deadline eviction releasing its
refs; and the two-wave demote / promote run.

Within the port: sharing on gives sharing off's tokens with less prefill
work, and the staged admissions seed whole segments."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import backbone as jbb  # noqa: E402
from repro.serve import prefix_cache as jpc  # noqa: E402
from repro.serve import telemetry as jtel  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.scheduler import ContinuousScheduler as JaxScheduler  # noqa: E402
from repro.serve.scheduler import SchedulerConfig as JaxSchedulerConfig  # noqa: E402
from repro_torch.bridge import backbone_params_from_numpy  # noqa: E402
from repro_torch.compress.quantize import linspace_f32, quantizer_init  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import backbone as tbb  # noqa: E402
from repro_torch.serve import prefix_cache as tpc  # noqa: E402
from repro_torch.serve import telemetry as ttel  # noqa: E402
from repro_torch.serve.engine import Request  # noqa: E402
from repro_torch.serve.scheduler import ContinuousScheduler, SchedulerConfig  # noqa: E402

BASE = dict(buckets=(8, 16, 32), max_slots=4, prefill_group=2, chunk=4,
            page_size=8)
PORT = (ContinuousScheduler, SchedulerConfig, Request, ttel)
JAX = (JaxScheduler, JaxSchedulerConfig, JaxRequest, jtel)


@pytest.fixture(scope="module")
def system():
    jcfg = jax_get_config("qwen2-0.5b").reduced()
    cfg = get_config("qwen2-0.5b").reduced()
    jp = jbb.init_params(jcfg, jax.random.PRNGKey(0))
    tp = backbone_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                    cfg, device="cpu")
    return {"port": (cfg, tp), "jax": (jcfg, jp)}


def _make(system, which, *, max_len=64, clock=None, telemetry=None, **kw):
    cls, conf = (PORT if which == "port" else JAX)[:2]
    cfg, params = system[which]
    extra = {"device": "cpu"} if which == "port" else {}
    return cls(cfg, params, max_len=max_len, clock=clock, telemetry=telemetry,
               sched=conf(**{**BASE, "prefix_cache": True, **kw}), **extra)


def _req(which, tokens, n, **kw):
    return (PORT if which == "port" else JAX)[2](tokens=tokens,
                                                 max_new_tokens=n, **kw)


def _shared_prompts(seed, sys_len=20, tails=(4, 9, 12, 4, 7, 12, 3, 9)):
    """tests/test_prefix_cache.py's shared workload: one system prompt,
    random tails (the vocab of the reduced model is 512)."""
    rng = np.random.RandomState(seed)
    sys_prompt = rng.randint(0, 512, sys_len)
    return [np.concatenate([sys_prompt, rng.randint(0, 512, L)]) for L in tails]


def _run(sched, which, prompts, n=4):
    rids = [sched.submit(_req(which, p, n)) for p in prompts]
    outs = sched.run()
    return [outs[r].tokens.tolist() for r in rids]


def _metrics(tel, *prefixes):
    return {(c.name, c.labels): c.value for c in tel.metrics.instruments()
            if c.name.startswith(prefixes)}


def _count_prefill(monkeypatch):
    """Count prefilled token positions as tests/test_prefix_cache.py does:
    a group prefill's real lengths, a segment's rows x width."""
    work = {"tok": 0}
    prefill, chunk = tbb.prefill, tbb.prefill_chunk

    def counted_prefill(cfg, params, batch, **kw):
        work["tok"] += int(kw["lengths"].sum())
        return prefill(cfg, params, batch, **kw)

    def counted_chunk(cfg, params, tokens, *a, **kw):
        work["tok"] += tokens.shape[0] * tokens.shape[1]
        return chunk(cfg, params, tokens, *a, **kw)

    monkeypatch.setattr(tbb, "prefill", counted_prefill)
    monkeypatch.setattr(tbb, "prefill_chunk", counted_chunk)
    return work


# ------------------------------------------------------------ page keys --


@pytest.mark.parametrize("T,page", [(32, 8), (8, 8), (9, 8), (17, 8), (3, 8),
                                    (100, 32), (129, 32), (61, 16)])
def test_page_keys_equal_jax(T, page):
    toks = np.random.RandomState(T * page).randint(0, 151936, T)
    assert tpc.page_keys(toks, page) == jpc.page_keys(toks, page)
    assert tpc.page_keys(list(toks), page) == jpc.page_keys(toks, page)


# ------------------------------------------------------------- codebook --


def _ranges(n, seed):
    """Page-like (lo, hi) ranges over several magnitudes; every seventh a
    flat page's (hi = lo + 1.0, as _compress sets it)."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n):
        lo = float(np.float32(rng.normal() * rng.choice([1e-3, 1.0, 10.0, 1e3])))
        hi = float(np.float32(lo + abs(rng.normal())
                              * rng.choice([1e-6, 1e-3, 1.0, 10.0, 1e3])))
        out.append((lo, lo + 1.0) if t % 7 == 0 else (lo, hi))
    return out


@pytest.mark.parametrize("bits", [8, 1, 2, 3, 4, 5, 6, 7])
def test_cold_codebook_equals_jnp_linspace_bitwise(bits):
    """The cold tier's uniform grid rounds as JAX's quantizer_init does, at
    1,200 ranges for 256 centers and 150 at the lower bit counts (whose
    element 1 JAX contracts differently: linspace_f32's docstring)."""
    from repro.compress.quantize import quantizer_init as jax_quantizer_init

    n = 1 << bits
    for lo, hi in _ranges(1200 if bits == 8 else 150, seed=bits):
        want = np.asarray(jax_quantizer_init(n, lo, hi)["centers"])
        got = linspace_f32(n, lo, hi)
        assert got.dtype == np.float32 and got.tobytes() == want.tobytes(), \
            (bits, lo, hi)


def test_offload_codebook_equals_jax():
    """quantizer_init(8) now gives the JAX package's offload centers
    bitwise (torch.linspace was up to 6 ulp off)."""
    from repro.compress.quantize import quantizer_init as jax_quantizer_init

    assert (quantizer_init(8)["centers"].numpy().tobytes()
            == np.asarray(jax_quantizer_init(8)["centers"]).tobytes())


# ------------------------------------------- one sequence, both caches --


def _page_rows(seed, n_pages, page=8):
    """K and V rows in JAX's layout (n_sb, n_attn, W, n_kv, hd); the port's
    rows are the same with n_attn squeezed."""
    rng = np.random.default_rng(seed)
    shape = (2, 1, n_pages * page, 2, 4)
    return tuple((rng.standard_normal(shape) * 3 + s).astype(np.float32)
                 for s in (0.5, -1.0))


def _state(pc):
    return (dict(pc.stats), pc.n_hot, pc.n_cold, pc.cold_used_bytes,
            {k: (e.refs, e.hot is None, e.cold is None)
             for k, e in pc._index.items()})


def _assert_same(jc, tc):
    assert _state(tc) == _state(jc)
    for key, je in jc._index.items():
        te = tc._index[key]
        for n in ("k", "v"):
            if je.cold is not None:
                assert te.cold[n] == je.cold[n]          # payload, lo, hi
            if je.hot is not None:
                assert (te.hot[n].numpy().tobytes()
                        == np.asarray(je.hot[n])[:, 0].tobytes())


@pytest.mark.parametrize("bits", [8, 3])
def test_cache_sequence_matches_jax(bits):
    """Pins sharing pages, releases, a park / unpark, LRU demotion under a
    2-page hot budget, promotions by fetch, cold blobs dropped past a
    3-page cold budget and cold-only pages rehydrated by a pin: after every
    step both caches hold the same pages in the same tiers with the same
    bytes, and every fetch returns JAX's values bitwise."""
    per_page = 2 * (2 * 8 * 2 * 4 * bits // 8)         # K + V blob bytes
    kw = dict(hot_pages=2, cold_bytes=3 * per_page + 1, bits=bits)
    caches = {"jax": jpc.PrefixCache(8, **kw), "port": tpc.PrefixCache(8, **kw)}
    rng = np.random.RandomState(bits)
    head = rng.randint(0, 512, 16)
    prompts = [np.concatenate([head, rng.randint(0, 512, 9)]),    # 3 pages
               np.concatenate([head, rng.randint(0, 512, 9)]),    # shares 2
               rng.randint(0, 512, 17),                           # 2 of its own
               np.concatenate([head, rng.randint(0, 512, 2)])]    # shares 2
    rows = [_page_rows(bits * 10 + i, 3) for i in range(len(prompts))]

    def pin(pc, which, slot, i):
        keys = pc.lookup(prompts[i])[0]
        k, v = rows[i]
        if which == "port":
            k, v = torch.from_numpy(k[:, 0]), torch.from_numpy(v[:, 0])
        pc.pin(slot, keys, k, v)

    def fetch(pc, which, i):
        keys, n = pc.lookup(prompts[i])
        assert n > 0
        out = pc.fetch(keys[:n])
        return {n_: (o.numpy() if which == "port" else np.asarray(o)[:, 0])
                for n_, o in out.items()}

    # pin(3) after pin(2) finds the shared head pages cold only and
    # rehydrates them from its own rows
    steps = [("pin", 0, 0), ("pin", 1, 1), ("release", 0), ("park", 1, "t"),
             ("release", 1), ("unpark", "t"), ("fetch", 0), ("enforce",),
             ("pin", 2, 2), ("pin", 3, 3), ("release", 2), ("release", 3),
             ("fetch", 3), ("fetch", 1)]
    for step in steps:
        got = {}
        for which, pc in caches.items():
            op = step[0]
            if op == "pin":
                pin(pc, which, step[1], step[2])
            elif op == "release":
                pc.release(step[1])
            elif op == "park":
                assert pc.park(step[1], step[2]) == step[2]
            elif op == "unpark":
                pc.unpark(step[1])
            elif op == "enforce":
                pc._enforce_budgets()
            else:
                got[which] = fetch(pc, which, step[1])
        _assert_same(caches["jax"], caches["port"])
        if got:
            for n in ("k", "v"):
                assert got["port"][n].tobytes() == got["jax"][n].tobytes()
    st = caches["port"].stats
    assert st["demotions"] and st["promotions"] and st["cold_drops"]
    assert caches["port"].n_cold and caches["port"].cold_used_bytes


def test_cold_roundtrip_within_half_a_step():
    """A demoted page promotes within half the codebook's step of its own
    values (the lossy tier's bound)."""
    pc = tpc.PrefixCache(8, hot_pages=0, cold_bytes=1 << 20, bits=8)
    keys = tpc.page_keys(np.arange(9), 8)
    k, v = (torch.from_numpy(r[:, 0]) for r in _page_rows(0, 1))
    pc.pin(0, keys, k, v)
    pc.release(0)
    assert pc.n_hot == 0 and pc.n_cold == 1
    got = pc.fetch(keys)
    for orig, rec in ((k, got["k"]), (v, got["v"])):
        step = float(orig.max() - orig.min()) / 255
        assert float((rec - orig).abs().max()) <= step / 2 + 1e-6
    assert pc.stats["promotions"] == 1


# -------------------------------------------- the scheduler, against JAX --


@pytest.fixture(scope="module")
def shared(system):
    """The shared workload through the JAX and port schedulers with the
    prefix cache on (telemetry enabled), and through the port with it
    off, in both overlap modes: {overlap: {which: record}}."""
    prompts = _shared_prompts(seed=0)
    out = {}
    for overlap in (True, False):
        out[overlap] = {}
        for which in ("port", "jax"):
            tel = (PORT if which == "port" else JAX)[3].Telemetry(enabled=True)
            sched = _make(system, which, telemetry=tel, overlap=overlap)
            toks = _run(sched, which, prompts)
            out[overlap][which] = {
                "tokens": toks, "stats": dict(sched.prefix.stats),
                "metrics": _metrics(tel, "sched.", "prefix.")}
        out[overlap]["off"] = _run(
            _make(system, "port", prefix_cache=False, overlap=overlap),
            "port", prompts)
    return out


@pytest.mark.parametrize("overlap", [True, False])
def test_shared_workload_matches_jax(shared, overlap):
    port, jx = shared[overlap]["port"], shared[overlap]["jax"]
    assert port["tokens"] == jx["tokens"]
    assert port["stats"] == jx["stats"]
    assert port["metrics"] == jx["metrics"]
    assert port["stats"]["page_hits"] > 0
    assert port["metrics"][("sched.admitted", (("path", "prefix"),))] > 0


@pytest.mark.parametrize("overlap", [True, False])
def test_sharing_on_gives_sharing_off_tokens(shared, overlap):
    assert shared[overlap]["port"]["tokens"] == shared[overlap]["off"]


def test_sharing_saves_prefill_work(system, monkeypatch):
    prompts = _shared_prompts(seed=4)
    work = _count_prefill(monkeypatch)
    off = _run(_make(system, "port", prefix_cache=False), "port", prompts)
    n_off, work["tok"] = work["tok"], 0
    on = _run(_make(system, "port"), "port", prompts)
    assert on == off and work["tok"] < n_off


def test_staged_prompts_seed_from_shared_pages(system):
    """Long admissions (bucket 48 > segment 16) seed resident pages in
    whole segments and stage past them: the same tokens as sharing off and
    as JAX, with JAX's hits."""
    rng = np.random.RandomState(5)
    head = rng.randint(0, 512, 24)
    prompts = [np.concatenate([head, rng.randint(0, 512, L)])
               for L in (12, 20, 12, 6, 20)]
    kw = dict(buckets=(8, 16, 24, 48), prefill_segment=16, max_len=96)
    runs = {}
    for which in ("port", "jax"):
        sched = _make(system, which, **kw)
        runs[which] = (_run(sched, which, prompts), dict(sched.prefix.stats))
    off = _run(_make(system, "port", prefix_cache=False, **kw), "port", prompts)
    assert runs["port"] == runs["jax"]
    assert runs["port"][0] == off
    assert runs["port"][1]["page_hits"] > 0


class _Clock:
    """Deterministic wall clock: every read advances by one tick."""

    def __init__(self, tick: float):
        self.t = 0.0
        self.tick = tick

    def __call__(self) -> float:
        self.t += self.tick
        return self.t


def test_deadline_eviction_releases_refs(system):
    """A pooled slot deadline-evicted mid-decode drops its page refs, as in
    JAX (the same partial tokens under the same fake clock)."""
    prompts = _shared_prompts(seed=7, tails=(4, 9))
    out = {}
    for which in ("port", "jax"):
        sched = _make(system, which, max_slots=2, prefill_group=1, chunk=2,
                      clock=_Clock(0.01))
        ra = sched.submit(_req(which, prompts[0], 40, deadline_s=0.055))
        sched.submit(_req(which, prompts[1], 4))
        outs = sched.run()
        assert outs[ra].timed_out and 0 < len(outs[ra].tokens) < 40
        assert all(e.refs == 0 for e in sched.prefix._index.values())
        assert not sched.prefix._slot_keys
        out[which] = ({r: c.tokens.tolist() for r, c in outs.items()},
                      dict(sched.prefix.stats))
    assert out["port"] == out["jax"]


def test_two_wave_demote_promote_matches_jax(system):
    """tests/test_prefix_cache.py's end-to-end cold-tier run: under a
    2-page hot budget wave A's pages demote and wave B's hits promote them;
    stats, cold bytes and tokens equal JAX's, and every ref is dropped."""
    out = {}
    for which in ("port", "jax"):
        rng = np.random.RandomState(8)
        sysp = rng.randint(0, 512, 24)
        sched = _make(system, which, max_slots=2, prefill_group=2,
                      prefix_hot_pages=2, kv_tier_mb=8.0)
        waves = []
        for _ in range(2):
            waves.append(_run(sched, which, [
                np.concatenate([sysp, rng.randint(0, 512, 6)])
                for _ in range(3)], n=2))
            waves.append((dict(sched.prefix.stats), sched.prefix.n_hot,
                          sched.prefix.n_cold, sched.prefix.cold_used_bytes))
        assert all(e.refs == 0 for e in sched.prefix._index.values())
        out[which] = waves
    assert out["port"] == out["jax"]
    stats = out["port"][-1][0]
    assert stats["demotions"] > 0 and stats["promotions"] > 0


def test_prefix_cache_refuses_what_it_cannot_pack():
    with pytest.raises(ValueError, match="1-8 bits"):
        tpc.PrefixCache(8, bits=9)
    with pytest.raises(ValueError, match="page_size"):
        tpc.PrefixCache(0)
    pc = tpc.PrefixCache(8)
    k = torch.zeros(2, 16, 2, 4)
    pc.pin(0, tpc.page_keys(np.arange(17), 8), k, k)
    with pytest.raises(ValueError, match="already pinned"):
        pc.pin(0, [], k, k)
