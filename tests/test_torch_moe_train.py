"""MoE training in the port on the CPU against the JAX package: reduced
moonshot-v1-16b-a3b (shared expert), mixtral-8x7b (sliding window) and
arctic-480b (dense residual), on bridged weights and the same seeded
batch: ``value_and_grad(forward_loss)`` against
``jax.value_and_grad(repro.models.backbone.forward_loss)`` (the loss, its
metrics and every gradient leaf, the router's and the stacked experts'
through the index dispatch and the gates through ``top_k_stable``), at
the training capacity on a batch that drops slots; remat on and off
bitwise (the recompute routes as the first pass); one ``make_train_step``
of two microbatches against JAX's; and reduced moonshot in bfloat16 on
both sides.

Tolerances, each with its reason:
- the loss and its metrics at 1e-5: float32 sums run in another order
  (XLA's one-hot einsums against the port's gathers and expand);
- every gradient leaf at 1e-5 of its largest |value| (the leaf's scale):
  the same sums, differentiated;
- a train step's new params and momentum at 1e-5 of each leaf's scale:
  the gradients' rounding times lr;
- bf16 moonshot at 3e-2 of each leaf's scale, the bf16 bar of
  ``tests/test_torch_bf16.py``: the two frameworks round the bf16
  activations and gradients at different places (measured 1.7-2.0e-2
  over seeds 0-2 on the CPU);
- the dropped fraction within 1e-5 (a mean over 2 x 2 x 24 slots).
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import InputShape as JaxShape  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import backbone as jbb  # noqa: E402
from repro_torch import tree_leaves, tree_map, value_and_grad  # noqa: E402
from repro_torch.bridge import backbone_params_from_numpy, backbone_params_to_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import backbone as tbb  # noqa: E402

TOL, GRAD_TOL, BF16_TOL = 1e-5, 1e-5, 3e-2
ARCHS = ("moonshot-v1-16b-a3b", "mixtral-8x7b", "arctic-480b")
B, T = 2, 24


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _batch(vocab: int, seed: int = 6) -> dict:
    rng = np.random.RandomState(seed)
    return {k: rng.randint(0, vocab, (B, T)).astype(np.int32) for k in ("tokens", "labels")}


def _leaves_close(jtree, ttree, cfg, tol, what):
    """Every leaf of the port's tree (back in JAX's layout) within tol of
    the JAX leaf's largest |value|; returns the port's leaves."""
    ref = jax.tree_util.tree_leaves(_np(jtree))
    got = jax.tree_util.tree_leaves(backbone_params_to_numpy(ttree, cfg))
    assert len(ref) == len(got), what
    for i, (r, g) in enumerate(zip(ref, got)):
        assert r.shape == g.shape, f"{what} leaf {i}"
        scale = max(float(np.abs(r).max()), 1e-30)
        err = float(np.abs(g.astype(np.float64) - r).max())
        assert err <= tol * scale, f"{what} leaf {i}: {err:.3e} > {tol} x {scale:.3e}"
    return got


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """A reduced MoE arch (2 layers, d 256, 4 experts, top-2; float32):
    JAX's params and ``jax.value_and_grad`` of forward_loss on a labelled
    batch, and the params bridged into the port."""
    jcfg = jax_get_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    jp = jbb.init_params(jcfg, jax.random.PRNGKey(0))
    batch = _batch(cfg.vocab)
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jbb.forward_loss(jcfg, p, batch), has_aux=True))(jp)
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, batch=batch, jloss=jloss, jm=jm, jg=jg,
                params=backbone_params_from_numpy(_np(jp), cfg, device="cpu"))


def test_moe_loss_and_every_grad_leaf_match_jax(arch):
    """The loss, ce, load-balance loss and dropped fraction within 1e-5 of
    JAX's on a batch that drops slots at the training capacity; every
    gradient leaf within 1e-5 of its scale, the router's nonzero in every
    layer."""
    cfg = arch["cfg"]
    (loss, m), grads = value_and_grad(lambda p: tbb.forward_loss(cfg, p, arch["batch"]),
                                      arch["params"])
    np.testing.assert_allclose(float(loss), float(arch["jloss"]), atol=TOL, rtol=TOL)
    assert sorted(m) == sorted(arch["jm"])
    for k in ("ce", "load_balance_loss", "dropped_fraction"):
        np.testing.assert_allclose(float(m[k]), float(arch["jm"][k]), atol=TOL, rtol=TOL)
    assert float(m["dropped_fraction"]) > 0.0      # the capacity is binding
    _leaves_close(arch["jg"], grads, cfg, GRAD_TOL, cfg.name)
    for blk in grads["blocks"]:
        assert blk["moe"]["router"]["w"].abs().max() > 0
        assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(blk))


def test_moe_remat_on_and_off_bitwise(arch):
    """Each layer's checkpointed recompute routes its tokens as the first
    pass did: the loss and every gradient bitwise equal with remat on and
    off."""
    cfg = arch["cfg"]
    runs = [value_and_grad(lambda p: tbb.forward_loss(cfg, p, arch["batch"], remat=r),
                           arch["params"]) for r in (True, False)]
    (l_on, m_on), g_on = runs[0]
    (l_off, m_off), g_off = runs[1]
    assert torch.equal(l_on, l_off)
    assert all(torch.equal(m_on[k], m_off[k]) for k in m_on)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g_on), tree_leaves(g_off)))


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b"], indirect=True)
def test_moe_train_step_two_microbatches_matches_jax(arch):
    """One SGD-momentum step over two microbatches (the fp32 accumulator,
    the loss as the sum of loss / n): new params and momentum within 1e-5
    of each leaf's scale of JAX's step."""
    jcfg, cfg = arch["jcfg"], arch["cfg"]
    kw = dict(lr=0.05, momentum=0.9, weight_decay=0.01, n_micro_override=2)
    jstep = jax.jit(jsteps.make_train_step(jcfg, JaxShape("t", T, B, "train"), **kw))
    jmom = jax.tree_util.tree_map(lambda p: 0.1 * jnp.ones_like(p), arch["jp"])
    jp, jopt, jm = jstep(arch["jp"], {"momentum": jmom}, arch["batch"])
    step = tsteps.make_train_step(cfg, InputShape("t", T, B, "train"), **kw)
    opt = {"momentum": tree_map(lambda p: 0.1 * torch.ones_like(p), arch["params"])}
    p, opt, m = step(arch["params"], opt, arch["batch"])
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), atol=TOL, rtol=TOL)
    _leaves_close(jp, p, cfg, TOL, "params")
    _leaves_close(jopt["momentum"], opt["momentum"], cfg, TOL, "momentum")


def test_bf16_moonshot_grads_match_jax():
    """Reduced moonshot-v1-16b-a3b with param_dtype bfloat16 on both sides
    (JAX's bf16 weights bridged as float32 arrays, cast back without
    loss): the loss within 3e-2, every gradient leaf bf16 as JAX's and
    within 3e-2 of its scale; a ``make_train_step`` of one microbatch
    keeps params and momentum in bf16."""
    name = "moonshot-v1-16b-a3b"
    jcfg = dataclasses.replace(jax_get_config(name).reduced(), param_dtype="bfloat16")
    cfg = dataclasses.replace(get_config(name).reduced(), param_dtype="bfloat16")
    jp = jbb.init_params(jcfg, jax.random.PRNGKey(0))
    params = backbone_params_from_numpy(_np(jp), cfg, device="cpu")
    batch = _batch(cfg.vocab)
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jbb.forward_loss(jcfg, p, batch), has_aux=True))(jp)
    (loss, m), grads = value_and_grad(lambda p: tbb.forward_loss(cfg, p, batch), params)
    assert all(g.dtype == jnp.bfloat16 for g in jax.tree_util.tree_leaves(jg))
    assert all(g.dtype == torch.bfloat16 for g in tree_leaves(grads))
    assert loss.dtype == torch.float32 and m["ce"].dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(jloss), rtol=BF16_TOL)
    _leaves_close(jg, grads, cfg, BF16_TOL, "bf16 grads")
    step = tsteps.make_train_step(cfg, InputShape("t", T, B, "train"))
    p, opt, _ = step(params, tsteps.opt_init(params), batch)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(p) + tree_leaves(opt["momentum"]))
