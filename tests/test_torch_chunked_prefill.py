"""The port's chunked prefill on the CPU: ``prefill_chunk`` segment by
segment against JAX's on the same cache, depth and tokens; within the
port, segmented prefill against one-shot prefill; and the scheduler's
staged admissions (long buckets prefilled one segment per round between
decode chunks) against one-shot admission and one-request-at-a-time
decoding, and against the JAX scheduler's tokens.

Tolerances: per-segment logits and written cache rows within 1e-4 of
JAX's (tests/test_torch_backbone.py's bar for the reduced model's
logits); segmented against one-shot prefill within the port within 1e-5,
not bitwise, since the projections run at other shapes (the CPU gives
equal bits, cuBLAS need not); greedy tokens exactly equal.  The JAX
package's bitwise chunked-vs-one-shot claim is not leaned on: it fails in
JAX itself (ROADMAP Queue 3)."""
import dataclasses
from functools import partial

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import backbone as jbb  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.scheduler import ContinuousScheduler as JaxScheduler  # noqa: E402
from repro.serve.scheduler import SchedulerConfig as JaxSchedulerConfig  # noqa: E402
from repro_torch.bridge import backbone_params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import backbone as tbb  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.scheduler import ContinuousScheduler, SchedulerConfig  # noqa: E402

SLICE_TOL = 1e-4
ONESHOT_TOL = 1e-5
LONG = dict(buckets=(8, 16, 32, 64, 128), max_slots=4, prefill_group=2,
            chunk=4)


@pytest.fixture(scope="module")
def system():
    jcfg = jax_get_config("qwen2-0.5b").reduced()
    cfg = get_config("qwen2-0.5b").reduced()
    jp = jbb.init_params(jcfg, jax.random.PRNGKey(0))
    tp = backbone_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                    cfg, device="cpu")
    return jcfg, jp, cfg, tp


@pytest.fixture(scope="module")
def jax_chunk(system):
    return jax.jit(partial(jbb.prefill_chunk, system[0]),
                   static_argnames=("attend_width",))


def _padded(T, W, seg):
    """A T-token prompt zero-padded to whole segments covering W."""
    padded = np.zeros((1, -(-W // seg) * seg), np.int64)
    padded[:, :T] = np.random.RandomState(T * 100 + seg).randint(0, 512, T)
    return padded


def _segments(T, W, seg):
    """(depth, segment tokens, last_index) until the prompt tail lands."""
    padded = _padded(T, W, seg)
    for d in range(0, W, seg):
        yield d, padded[:, d:d + seg], min(max(T - 1 - d, 0), seg - 1)
        if d + seg >= T:
            return


CASES = [(48, 48, 16), (41, 48, 16), (48, 48, 48), (33, 64, 8)]


@pytest.mark.parametrize("T,W,seg", CASES)
def test_prefill_chunk_matches_jax(system, jax_chunk, T, W, seg):
    """Each segment from the same cache (JAX's, bridged before the call):
    the logits at ``last_index`` and the K/V rows it writes."""
    jcfg, jp, cfg, tp = system
    width = _padded(T, W, seg).shape[1]
    jcache = jbb.init_cache(jcfg, 1, width)
    tcache = tbb.init_cache(cfg, 1, width, device="cpu")
    for d, toks, last in _segments(T, W, seg):
        for nm in ("k", "v"):
            tcache[nm].copy_(torch.from_numpy(np.array(jcache[nm])[:, 0]))
        lt, tcache = tbb.prefill_chunk(cfg, tp, torch.from_numpy(toks), tcache,
                                       d, attend_width=W, last_index=last)
        lj, jcache = jax_chunk(jp, jnp.asarray(toks, jnp.int32), jcache,
                               jnp.int32(d), attend_width=W,
                               last_index=jnp.int32(last))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                                   atol=SLICE_TOL, rtol=SLICE_TOL)
        for nm in ("k", "v"):
            np.testing.assert_allclose(
                tcache[nm][:, :, d:d + seg].numpy(),
                np.asarray(jcache[nm])[:, 0, :, d:d + seg],
                atol=SLICE_TOL, rtol=SLICE_TOL)


@pytest.mark.parametrize("T,W,seg", CASES)
def test_chunked_prefill_matches_oneshot(system, T, W, seg):
    """Within the port: N segments give a one-shot bucketed prefill's
    last-token logits and every written cache element, within 1e-5."""
    _, _, cfg, tp = system
    padded = _padded(T, W, seg)
    cache = tbb.init_cache(cfg, 1, padded.shape[1], device="cpu")
    for d, toks, last in _segments(T, W, seg):
        lg, cache = tbb.prefill_chunk(cfg, tp, torch.from_numpy(toks), cache,
                                      d, attend_width=W, last_index=last)
        if d <= T - 1 < d + seg:
            logits = lg
    one, ref, _ = tbb.prefill(cfg, tp,
                              {"tokens": torch.from_numpy(padded[:, :W])},
                              max_len=W, lengths=torch.tensor([T]))
    torch.testing.assert_close(logits, one, atol=ONESHOT_TOL, rtol=ONESHOT_TOL)
    for nm in ("k", "v"):
        torch.testing.assert_close(cache[nm][:, :, :T], ref[nm][:, :, :T],
                                   atol=ONESHOT_TOL, rtol=ONESHOT_TOL)


def test_prefill_chunk_refuses_what_it_cannot_run(system):
    _, _, cfg, tp = system
    cache = tbb.init_cache(cfg, 1, 32, device="cpu")
    toks = torch.zeros((1, 16), dtype=torch.long)
    with pytest.raises(ValueError, match="past the cache"):
        tbb.prefill_chunk(cfg, tp, toks, cache, 24, attend_width=32)
    with pytest.raises(ValueError, match="sliding window"):
        tbb.prefill_chunk(dataclasses.replace(cfg, sliding_window=16), tp,
                          toks, cache, 0, attend_width=32)


def _run(cls, cfg, params, reqs, **kw):
    sched = cls(cfg, params, max_len=192, sched=kw.pop("sched"), **kw)
    rids = [sched.submit(r) for r in reqs]
    outs = sched.run()
    assert sorted(outs) == sorted(rids)
    return [outs[r].tokens.tolist() for r in rids]


def test_scheduler_chunked_admission_matches_reference_and_jax(system):
    """Three staged admissions among short traffic: the per-request
    reference's tokens, and JAX's scheduler's."""
    jcfg, jp, cfg, tp = system
    rng = np.random.RandomState(7)
    lens = [100, 8, 16, 97, 8, 128, 16]
    prompts = [rng.randint(0, cfg.vocab, L) for L in lens]
    reqs = [Request(tokens=p, max_new_tokens=5) for p in prompts]
    got = _run(ContinuousScheduler, cfg, tp, reqs, device="cpu",
               sched=SchedulerConfig(prefill_segment=32, **LONG))
    ref = ServeEngine(cfg, tp, max_len=192, device="cpu")
    assert got == [ref.generate([r])[0].tokens.tolist() for r in reqs]
    jgot = _run(JaxScheduler, jcfg, jp,
                [JaxRequest(tokens=p, max_new_tokens=5) for p in prompts],
                sched=JaxSchedulerConfig(prefill_segment=32, **LONG))
    assert got == jgot


def test_scheduler_chunked_vs_oneshot_admission(system):
    """The same long-prompt queue with chunked prefill on and off."""
    _, _, cfg, tp = system
    rng = np.random.RandomState(8)
    reqs = [Request(tokens=rng.randint(0, cfg.vocab, L), max_new_tokens=4)
            for L in (100, 8, 120, 16)]
    runs = [_run(ContinuousScheduler, cfg, tp, reqs, device="cpu",
                 sched=SchedulerConfig(prefill_segment=seg, **LONG))
            for seg in (32, 0)]
    assert runs[0] == runs[1]


def test_staged_admission_never_stalls_decode(system):
    """While a long prompt stages, a short request keeps decoding and
    completes before the long admission finishes staging."""
    _, _, cfg, tp = system
    sched = ContinuousScheduler(
        cfg, tp, max_len=192, device="cpu",
        sched=SchedulerConfig(buckets=(8, 16, 32, 64, 128), max_slots=2,
                              prefill_group=1, chunk=2, prefill_segment=16))
    long_rid = sched.submit(Request(tokens=np.arange(128) % cfg.vocab,
                                    max_new_tokens=3))
    short_rid = sched.submit(Request(tokens=np.arange(8) % cfg.vocab,
                                     max_new_tokens=3))
    finished = []
    for _ in range(64):
        finished.extend(sched.step())
        if long_rid in finished:
            break
    assert short_rid in finished and long_rid in finished
    assert finished.index(short_rid) < finished.index(long_rid)
