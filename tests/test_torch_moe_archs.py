"""Reduced moonshot-v1-16b-a3b (shared expert), mixtral-8x7b (sliding
window) and arctic-480b (dense residual) on the CPU against the JAX
package, on bridged weights and the same seeded inputs: ``prefill``, 16
``decode_step``s and greedy ``ServeEngine.generate``, and
``forward_loss`` with its load-balance term.

Tolerances, each with its reason:
- ``forward_loss`` and its metrics at 1e-5: float32 sums run in another
  order (XLA's one-hot einsums against the port's gathers);
- logits and K at 1e-5 of the largest |value|: the same, through two
  layers;
- greedy tokens and dropped fractions exactly.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import backbone as jbb  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.bridge import backbone_params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import backbone as tbb  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

TOL = 1e-5
ARCHS = ("moonshot-v1-16b-a3b", "mixtral-8x7b", "arctic-480b")
B, T, DECODE, MAX_LEN = 2, 12, 16, 40


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """A reduced MoE arch (2 layers, d 256, 4 experts, top-2; float32) in
    JAX and its params bridged into the port."""
    jcfg = jax_get_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    jp = jbb.init_params(jcfg, jax.random.PRNGKey(0))
    return dict(jcfg=jcfg, cfg=cfg, jp=jp,
                params=backbone_params_from_numpy(_np(jp), cfg, device="cpu"))


def test_moe_arch_prefill_decode_and_generate_match_jax(arch):
    """Prefill and 16 decode steps, logits within 1e-5 of scale, teacher-
    forced on JAX's greedy tokens; then greedy generate, tokens equal."""
    jcfg, cfg = arch["jcfg"], arch["cfg"]
    assert cfg.moe is not None and cfg.dtype == torch.float32
    m = cfg.moe
    assert ("shared" in arch["params"]["blocks"][0]) == bool(m.shared_expert_ff)
    assert ("dense_res" in arch["params"]["blocks"][0]) == bool(m.dense_residual_ff)
    toks = np.random.RandomState(5).randint(0, cfg.vocab, (B, T)).astype(np.int32)
    jl, jc, jT = jbb.prefill(jcfg, arch["jp"], {"tokens": jnp.asarray(toks)},
                             max_len=MAX_LEN)
    tl, tc, tT = tbb.prefill(cfg, arch["params"], {"tokens": torch.as_tensor(toks)},
                             max_len=MAX_LEN)
    assert jT == tT == T

    def close(j, t):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, atol=TOL * np.abs(j).max(), rtol=0)

    close(jl, tl)
    close(jc["k"][0, 0], tc["k"][0])
    jstep = jax.jit(lambda p, tok, c, n: jbb.decode_step(jcfg, p, tok, c, n))
    for i in range(DECODE):
        tok = jnp.argmax(jl, -1)[:, None]
        jl, jc = jstep(arch["jp"], tok, jc, T + i)
        tl, tc = tbb.decode_step(cfg, arch["params"], torch.as_tensor(np.array(tok)),
                                 tc, T + i)
        close(jl, tl)
    reqs = [(p, 6) for p in toks]
    jout = JaxServeEngine(jcfg, arch["jp"], max_len=MAX_LEN).generate(
        [JaxRequest(tokens=p, max_new_tokens=n) for p, n in reqs])
    teng = ServeEngine(cfg, arch["params"], max_len=MAX_LEN, device="cpu")
    tout = teng.generate([Request(tokens=p, max_new_tokens=n) for p, n in reqs])
    assert [c.tokens.tolist() for c in tout] == [c.tokens.tolist() for c in jout]
    assert len(teng.moe_aux["decode"]) == 5
    # E / k = 2 at 4 experts, top-2: the inference capacity drops nothing
    for aux in [teng.moe_aux["prefill"], *teng.moe_aux["decode"]]:
        assert float(aux["dropped_fraction"]) == 0.0


def test_moe_forward_loss_matches_jax(arch):
    """Training capacity (1.25) and the 0.01 load-balance term, on a
    labelled batch."""
    jcfg, cfg = arch["jcfg"], arch["cfg"]
    rng = np.random.RandomState(6)
    batch = {"tokens": rng.randint(0, cfg.vocab, (B, T)).astype(np.int32),
             "labels": rng.randint(0, cfg.vocab, (B, T)).astype(np.int32)}
    jloss, jm = jbb.forward_loss(jcfg, arch["jp"], {k: jnp.asarray(v)
                                                    for k, v in batch.items()})
    tloss, tm = tbb.forward_loss(cfg, arch["params"], batch)
    assert sorted(tm) == sorted(jm)
    np.testing.assert_allclose(float(tloss), float(jloss), atol=TOL, rtol=TOL)
    for k in ("ce", "load_balance_loss", "dropped_fraction"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=TOL, rtol=TOL)
    assert float(tm["load_balance_loss"]) > 0.0
    assert float(tloss) == pytest.approx(float(tm["ce"]) + 0.01 * float(
        tm["load_balance_loss"]), rel=1e-6)
