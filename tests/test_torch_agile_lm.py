"""The port's AgileNN on tokens (``core/agile_lm.py``) on the CPU against
the JAX package at ``tests/test_agile_lm.py``'s config (the reduced
qwen2-0.5b, 32 extractor channels, k = 6, ig_steps 4), the JAX weights
bridged over, tokens from ``SyntheticTokens``.

Tolerances, each with its reason:
- logits, internals and the loss's metrics at 1e-5: fp32 sums in another
  order through two backbone layers and a 512-wide readout;
- every gradient leaf at 1e-5 of its largest |gradient| (``grad_close``),
  first and second derivatives (the IG importance) through the same sums;
- three AdamW steps at 1e-4, with a measured exception: Adam divides each
  gradient by its own running magnitude (eps = 1e-8), so where that
  magnitude is near eps the gradients' fp32 rounding (up to 8.4e-9 on the
  k projection's leaves) moves the update anywhere in +-lr.  Measured: 14
  elements of about 1.2 M, in six leaves, part from JAX's by 1.6e-4 to
  9.3e-4.  So at most 1e-4 of the elements may pass 1e-4, and every
  element stays within 3 x lr, the most three steps of +-lr can part them;
- payload bits and the eval path's quantizer indices exactly.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import AgileSpec as JaxSpec  # noqa: E402
from repro.core import agile_lm as jlm  # noqa: E402
from repro.compress.quantize import hard_indices as jax_hard_indices  # noqa: E402
from repro.data.synthetic import SyntheticTokens as JaxTokens  # noqa: E402
from repro.data.synthetic import TokenDatasetSpec as JaxTokenSpec  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import tree_leaves, value_and_grad  # noqa: E402
from repro_torch.bridge import agile_lm_params_from_numpy  # noqa: E402
from repro_torch.compress.quantize import hard_indices  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import AgileSpec  # noqa: E402
from repro_torch.core import agile_lm as tlm  # noqa: E402
from repro_torch.core.splitter import split_features  # noqa: E402
from repro_torch.data.synthetic import SyntheticTokens, TokenDatasetSpec  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402

TOL = 1e-5
GRAD_TOL = 1e-5
STEP_TOL = 1e-4
LR, ADAM_EPS = 5e-3, 1e-8
KEY = jax.random.PRNGKey(0)
_SPEC = dict(enabled=True, extractor_channels=32, k=6, rho=0.7, lam=0.4, ig_steps=4)
JCFG = dataclasses.replace(jax_get_config("qwen2-0.5b").reduced(), agile=JaxSpec(**_SPEC))
CFG = dataclasses.replace(get_config("qwen2-0.5b").reduced(), agile=AgileSpec(**_SPEC))
STEPS = 3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def close(ref, got, tol=TOL, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=tol,
                               rtol=tol, err_msg=what)


def grad_close(ref, got, tol=GRAD_TOL, what=""):
    ref = np.asarray(ref, np.float64)
    got = got.detach().double().numpy()
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert got.shape == ref.shape, what
    assert err <= tol * scale, f"{what}: max |err| {err:.3e} > {tol} x {scale:.3e}"


def _port_leaves(tree):
    """A JAX tree of the agile_lm layout in the port's leaf order."""
    return tree_leaves(agile_lm_params_from_numpy(_np(tree), CFG, device="cpu"))


@pytest.fixture(scope="module")
def system():
    """JAX's params and a token batch from SyntheticTokens (the last token
    is the label), ``jax.value_and_grad`` of agile_lm_loss compiled once,
    and JAX's three AdamW steps; the same params bridged into the port."""
    data = JaxTokens(JaxTokenSpec(vocab=32, seq_len=12, n_modes=2))
    batches = [data.batch(4, seed=i) for i in range(STEPS)]
    jp = jlm.init_agile_lm_params(JCFG, KEY)

    def loss(p, toks):
        return jlm.agile_lm_loss(JCFG, p, toks[:, :-1], toks[:, -1])

    vg = jax.jit(jax.value_and_grad(loss, has_aux=True))
    (jloss, jmetrics), jgrads = vg(jp, batches[0])

    @jax.jit
    def step(p, o, toks):
        (_, _), g = jax.value_and_grad(loss, has_aux=True)(p, toks)
        return jadamw.adamw_update(p, g, o, lr=LR, eps=ADAM_EPS, weight_decay=0.0)

    p, o = jp, jadamw.adamw_init(jp)
    for toks in batches:
        p, o = step(p, o, toks)
    return dict(jp=jp, params=agile_lm_params_from_numpy(_np(jp), CFG, device="cpu"),
                batches=batches, jloss=jloss, jmetrics=jmetrics, jgrads=jgrads,
                jstepped=p)


def test_token_batches_feed_both_packages_alike():
    spec = dict(vocab=32, seq_len=12, n_modes=2)
    a = JaxTokens(JaxTokenSpec(**spec)).batch(4, seed=1)
    b = SyntheticTokens(TokenDatasetSpec(**spec)).batch(4, seed=1)
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("train", [True, False])
def test_forward_matches_jax(system, train):
    toks = system["batches"][0][:, :-1]
    jlogits, jint = jlm.agile_lm_forward(JCFG, system["jp"], toks, train=train)
    logits, internals = tlm.agile_lm_forward(CFG, system["params"], toks, train=train)
    assert logits.shape == (4, CFG.vocab)
    close(jlogits, logits, what="logits")
    for key in ("features", "local_logits", "remote_logits", "alpha"):
        close(jint[key], internals[key], what=key)
    if not train:       # the offloaded channels' indices, exactly
        _, jr = jlm.split_features(jint["features"], JCFG.agile.k)
        _, tr = split_features(internals["features"], CFG.agile.k)
        assert np.array_equal(np.asarray(jax_hard_indices(system["jp"]["quant"], jr)),
                              hard_indices(system["params"]["quant"], tr).numpy())


def test_loss_metrics_and_every_grad_leaf_match_jax(system):
    toks = system["batches"][0]
    (loss, metrics), grads = value_and_grad(
        lambda p: tlm.agile_lm_loss(CFG, p, toks[:, :-1], toks[:, -1]),
        system["params"])
    close(system["jloss"], loss, what="loss")
    assert sorted(metrics) == sorted(system["jmetrics"])
    for key, val in metrics.items():
        close(system["jmetrics"][key], val, what=key)
    got, ref = tree_leaves(grads), _port_leaves(system["jgrads"])
    assert len(got) == len(ref)
    nonzero = 0
    for i, (r, g) in enumerate(zip(ref, got)):
        assert torch.isfinite(g).all(), f"leaf {i}"
        nonzero += bool(g.abs().max() > 0)
        grad_close(r.numpy(), g, what=f"leaf {i}")
    # every leaf but the quantizer's centers and the local head: the batch's
    # soft assignments put mass on the centers; the local head is live
    assert nonzero >= len(got) - 2, nonzero


def test_three_adamw_steps_match_jax(system):
    def loss(p, toks):
        return tlm.agile_lm_loss(CFG, p, toks[:, :-1], toks[:, -1])

    p = system["params"]
    o = tadamw.adamw_init(p)
    for toks in system["batches"]:
        (_, _), g = value_and_grad(lambda pp: loss(pp, toks), p)
        p, o = tadamw.adamw_update(p, g, o, lr=LR, eps=ADAM_EPS, weight_decay=0.0)
    n_off = n_all = 0
    for i, (r, t) in enumerate(zip(_port_leaves(system["jstepped"]), tree_leaves(p))):
        err = (t - r).abs()
        assert float(err.max()) <= STEPS * LR, i
        n_off += int((err > STEP_TOL * (1 + float(r.abs().max()))).sum())
        n_all += err.numel()
    assert n_off <= 1e-4 * n_all, (n_off, n_all)


def test_offload_payload_bits_match_jax(system):
    toks = system["batches"][1][:, :-1]
    bits = tlm.offload_payload_bits(CFG, system["params"], toks)
    assert bits == jlm.offload_payload_bits(JCFG, system["jp"], toks) == 4 * (32 - 6) * 3


def test_init_is_seeded_and_shaped_like_jax(system):
    p = tlm.init_agile_lm_params(CFG, 3, device="cpu")
    again = tlm.init_agile_lm_params(CFG, 3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p), tree_leaves(again)))
    assert [tuple(t.shape) for t in tree_leaves(p)] == \
        [tuple(t.shape) for t in tree_leaves(system["params"])]
