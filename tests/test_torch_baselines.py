"""The port's comparison baselines (``core/baselines.py``: edge-only,
MCUNet-proxy, DeepCOD, SPINN and ``train_baseline``) on the CPU against
the JAX package, the JAX weights bridged over, on ``SyntheticImages``
batches.  The Remote NNs are 32 wide (4 channels per GroupNorm group).

Tolerances, each with its reason:
- logits, codes and losses at 1e-5: convs and GroupNorm sum in another
  order;
- every gradient leaf at 1e-5 of its largest |gradient| (``grad_close``);
- three ``train_baseline`` SGD steps at 1e-5: the rounding above times lr;
- payload bytes, quantizer indices and every ``InferenceCost`` field
  exactly: indices of the same codes, the same LZW, the same cost model.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.agilenn_cifar import AgileNNConfig as JaxConfig  # noqa: E402
from repro.core import agile as jagile  # noqa: E402
from repro.core import baselines as jbase  # noqa: E402
from repro.data.synthetic import ImageDatasetSpec as JaxImageSpec  # noqa: E402
from repro.data.synthetic import SyntheticImages as JaxImages  # noqa: E402
from repro_torch import tree_leaves, value_and_grad  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.agilenn_cifar import AgileNNConfig  # noqa: E402
from repro_torch.core import agile as tagile  # noqa: E402
from repro_torch.core import baselines as tbase  # noqa: E402
from repro_torch.data.synthetic import ImageDatasetSpec, SyntheticImages  # noqa: E402

TOL = 1e-5
GRAD_TOL = 1e-5
_SIZES = dict(image_size=16, remote_width=32, remote_blocks=2)
JCFG, CFG = JaxConfig(**_SIZES), AgileNNConfig(**_SIZES)
KEYS = dict(zip(("deepcod", "spinn", "mcunet"), jax.random.split(jax.random.PRNGKey(11), 3)))
REMOTE_MACS = 1.5e7


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


def jax_mcunet_loss(p, images, labels):
    """benchmarks/common.py's MCUNet loss."""
    logits = jbase.mcunet_apply(p, images)
    acc = jnp.mean((jnp.argmax(logits, -1) == labels).astype(jnp.float32))
    return jagile.cross_entropy(logits, labels), {"accuracy": acc}


def mcunet_loss(p, images, labels):
    labels = torch.as_tensor(labels).long()
    logits = tbase.mcunet_apply(p, images)
    acc = torch.mean((torch.argmax(logits, -1) == labels).float())
    return tagile.cross_entropy(logits, labels), {"accuracy": acc}


LOSSES = {"deepcod": (jbase.deepcod_loss, tbase.deepcod_loss),
          "spinn": (jbase.spinn_loss, tbase.spinn_loss),
          "mcunet": (jax_mcunet_loss, mcunet_loss)}


@pytest.fixture(scope="module")
def system():
    jp = {"deepcod": jbase.deepcod_init(KEYS["deepcod"], JCFG),
          "spinn": jbase.spinn_init(KEYS["spinn"], JCFG),
          "mcunet": jbase.mcunet_init(KEYS["mcunet"], JCFG)}
    data = JaxImages(JaxImageSpec(image_size=16))
    images, labels = data.batch(8, seed=3)
    return dict(jp=jp, tp={k: params_from_numpy(_np(v), device="cpu") for k, v in jp.items()},
                images=images, labels=labels)


def test_forwards_match_jax(system):
    jp, tp, x = system["jp"], system["tp"], system["images"]
    close(jbase.mcunet_apply(jp["mcunet"], x), tbase.mcunet_apply(tp["mcunet"], x),
          what="mcunet")
    for train in (True, False):
        jl, jc = jbase.deepcod_forward(jp["deepcod"], x, train=train)
        tl, tc = tbase.deepcod_forward(tp["deepcod"], x, train=train)
        close(jl, tl, what="deepcod logits")
        close(jc, tc, what="deepcod code")
        for name, a, b in zip(("exit", "remote", "feats"),
                              jbase.spinn_forward(jp["spinn"], x, train=train),
                              tbase.spinn_forward(tp["spinn"], x, train=train)):
            close(a, b, what=f"spinn {name}")


@pytest.mark.parametrize("name", ["deepcod", "spinn", "mcunet"])
def test_losses_and_every_grad_leaf_match_jax(system, name):
    jloss_fn, tloss_fn = LOSSES[name]
    x, y = system["images"], system["labels"]
    (jl, jm), jg = jax.jit(jax.value_and_grad(lambda p: jloss_fn(p, x, y), has_aux=True))(
        system["jp"][name])
    (tl, tm), tg = value_and_grad(lambda p: tloss_fn(p, x, y), system["tp"][name])
    close(jl, tl, what="loss")
    assert sorted(jm) == sorted(tm)
    for key in jm:
        close(jm[key], tm[key], what=key)
    ref = tree_leaves(params_from_numpy(_np(jg), device="cpu"))
    got = tree_leaves(tg)
    assert len(ref) == len(got)
    for i, (r, g) in enumerate(zip(ref, got)):
        assert torch.isfinite(g).all(), f"leaf {i}"
        grad_close(r.numpy(), g, what=f"{name} leaf {i}")


def test_payloads_and_costs_equal_jax(system):
    jp, tp, x = system["jp"], system["tp"], system["images"]
    assert tbase.edge_only_payload(x) == jbase.edge_only_payload(x)
    assert tbase.edge_only_payload(torch.from_numpy(x)) == jbase.edge_only_payload(x)
    assert tbase.deepcod_payload(tp["deepcod"], x) == jbase.deepcod_payload(jp["deepcod"], x)
    pairs = [
        (jbase.edge_only_cost(JCFG, x, remote_macs=REMOTE_MACS),
         tbase.edge_only_cost(CFG, x, remote_macs=REMOTE_MACS)),
        (jbase.mcunet_cost(JCFG), tbase.mcunet_cost(CFG)),
        (jbase.deepcod_cost(JCFG, jp["deepcod"], x, remote_macs=REMOTE_MACS),
         tbase.deepcod_cost(CFG, tp["deepcod"], x, remote_macs=REMOTE_MACS)),
        (jbase.spinn_cost(JCFG, jp["spinn"], x, remote_macs=REMOTE_MACS, exit_threshold=0.15),
         tbase.spinn_cost(CFG, tp["spinn"], x, remote_macs=REMOTE_MACS, exit_threshold=0.15)),
    ]
    for j, t in pairs:
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert tbase.mcunet_macs(CFG) == jbase.mcunet_macs(JCFG)
    assert tbase.deepcod_local_macs(CFG) == jbase.deepcod_local_macs(JCFG)


@pytest.mark.parametrize("name", ["deepcod", "spinn", "mcunet"])
def test_train_baseline_matches_jax(system, name):
    jloss_fn, tloss_fn = LOSSES[name]
    jdata = JaxImages(JaxImageSpec(image_size=16))
    tdata = SyntheticImages(ImageDatasetSpec(image_size=16))
    jp, jm = jbase.train_baseline(jloss_fn, system["jp"][name], jdata, steps=3,
                                  batch_size=8)
    tp, tm = tbase.train_baseline(tloss_fn, system["tp"][name], tdata, steps=3,
                                  batch_size=8)
    assert sorted(jm) == sorted(tm)
    for key in jm:
        assert abs(jm[key] - tm[key]) <= TOL * (1 + abs(jm[key])), key
    for i, (r, t) in enumerate(zip(tree_leaves(params_from_numpy(_np(jp), device="cpu")),
                                   tree_leaves(tp))):
        np.testing.assert_allclose(t.numpy(), r.numpy(), atol=TOL, rtol=TOL,
                                   err_msg=f"{name} leaf {i}")


def test_inits_are_seeded_and_shaped_like_jax(system):
    for name, init in (("deepcod", tbase.deepcod_init), ("spinn", tbase.spinn_init),
                       ("mcunet", tbase.mcunet_init)):
        a, b = init(5, CFG, device="cpu"), init(5, CFG, device="cpu")
        assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
        assert [tuple(t.shape) for t in tree_leaves(a)] == \
            [tuple(t.shape) for t in tree_leaves(system["tp"][name])], name
