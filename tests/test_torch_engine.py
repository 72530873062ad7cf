"""The port's ServeEngine on the CPU: greedy tokens equal to the JAX
package's ServeEngine on the same bridged weights and prompts (EOS and
per-request budgets included), seeded sampling that repeats itself,
mixed lengths and deadlines routed through the continuous scheduler, and
the requests the engine refuses."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import backbone as jbb  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.bridge import backbone_params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import backbone as tbb  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

MAX_LEN = 64


@pytest.fixture(scope="module")
def engines():
    jcfg = jax_get_config("qwen2-0.5b").reduced()
    cfg = get_config("qwen2-0.5b").reduced()
    jp = jbb.init_params(jcfg, jax.random.PRNGKey(0))
    tp = backbone_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                    cfg, device="cpu")
    return (JaxServeEngine(jcfg, jp, max_len=MAX_LEN),
            ServeEngine(cfg, tp, max_len=MAX_LEN, device="cpu"), cfg)


def _both(engines, specs):
    jeng, teng, _ = engines
    outs = []
    for eng, req in ((jeng, JaxRequest), (teng, Request)):
        outs.append([c.tokens.tolist() for c in eng.generate(
            [req(tokens=p, max_new_tokens=n, eos_id=e) for p, n, e in specs])])
    return outs


def test_greedy_tokens_match_jax(engines):
    """3 prompts x 8 tokens; then one request stops at an EOS it emits
    mid-way and another at a budget of 3."""
    cfg = engines[2]
    prompts = np.random.RandomState(0).randint(0, cfg.vocab, (3, 10))
    jax_toks, port_toks = _both(engines, [(p, 8, -1) for p in prompts])
    assert port_toks == jax_toks
    assert [len(t) for t in port_toks] == [8, 8, 8]
    first = [i for i, t in enumerate(port_toks[0]) if t not in port_toks[0][:i]]
    stop = next(i for i in first if i >= 2)         # a token new at step >= 2
    eos = port_toks[0][stop]
    jax_toks, port_toks = _both(engines, [(prompts[0], 8, eos),
                                          (prompts[1], 3, -1),
                                          (prompts[2], 8, -1)])
    assert port_toks == jax_toks
    assert port_toks[0][-1] == eos and len(port_toks[0]) == stop + 1
    assert len(port_toks[1]) == 3 and len(port_toks[2]) == 8


def test_steps_count_as_in_jax(engines):
    jeng, teng, cfg = engines
    prompt = np.random.RandomState(1).randint(0, cfg.vocab, 6)
    for n in (1, 5):
        j = jeng.generate([JaxRequest(tokens=prompt, max_new_tokens=n)])[0]
        t = teng.generate([Request(tokens=prompt, max_new_tokens=n)])[0]
        assert t.steps == j.steps == n


def test_seeded_sampling_repeats():
    cfg = get_config("qwen2-0.5b").reduced()
    params = tbb.init_params(cfg, seed=1, device="cpu")
    prompts = np.random.RandomState(2).randint(0, cfg.vocab, (3, 7))

    def run():
        eng = ServeEngine(cfg, params, max_len=MAX_LEN, seed=5, device="cpu")
        reqs = [Request(tokens=p, max_new_tokens=6, temperature=t)
                for p, t in zip(prompts, (0.0, 0.8, 1.5))]
        return [c.tokens.tolist() for c in eng.generate(reqs)]

    a, b = run(), run()
    assert a == b
    greedy = ServeEngine(cfg, params, max_len=MAX_LEN, device="cpu").generate(
        [Request(tokens=prompts[0], max_new_tokens=6)])[0]
    assert a[0] == greedy.tokens.tolist()          # temperature 0 is argmax


def test_unported_requests_raise(engines):
    """Mixed prompt lengths and deadlines route through the continuous
    scheduler as in JAX and give JAX's completions; a context past
    max_len raises; under a one-rank (1, 1) gloo mesh equal-length
    prompts route through the scheduler (not the single-device path) and
    give the mesh-less engine's tokens."""
    jeng, teng, cfg = engines
    rng = np.random.RandomState(3)
    mixed = [(rng.randint(0, cfg.vocab, 5), None),
             (rng.randint(0, cfg.vocab, 6), None)]
    timed = [(rng.randint(0, cfg.vocab, 5), 1e6)]
    for specs in (mixed, timed):
        outs = []
        for eng, req in ((jeng, JaxRequest), (teng, Request)):
            outs.append([(c.tokens.tolist(), c.timed_out) for c in eng.generate(
                [req(tokens=p, max_new_tokens=4, deadline_s=d)
                 for p, d in specs])])
        assert outs[1] == outs[0]
        assert all(len(t) == 4 and not late for t, late in outs[1])
    assert teng._sched is not None
    with pytest.raises(ValueError, match="max_len"):
        teng.generate([Request(tokens=rng.randint(0, cfg.vocab, 60),
                               max_new_tokens=8)])
    from repro_torch.launch.mesh import make_serving_mesh, process_group

    equal = [Request(tokens=rng.randint(0, cfg.vocab, 6), max_new_tokens=4)
             for _ in range(2)]
    with process_group("gloo"):
        meshed = ServeEngine(cfg, teng.params, device="cpu", max_len=teng.max_len,
                             mesh=make_serving_mesh(), scheduler=teng._sched_cfg)
        got = [c.tokens.tolist() for c in meshed.generate(equal)]
        assert meshed._sched is not None and meshed._sched.mesh is not None
    assert got == [c.tokens.tolist() for c in teng.generate(equal)]
