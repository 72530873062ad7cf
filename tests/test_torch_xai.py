"""The port's XAI importance, skewness losses, straight-through quantizer,
differentiable channel permute and channel selection (Alg. 1) on the CPU,
against the JAX package on the same seeded numpy inputs and bridged
weights.

Tolerances: values at atol = rtol = 1e-5 fp32 (sums run in another order
in the two frameworks); gradients, first and second order, at 1e-5 of
the largest |gradient| of the tensor (``_grad_close``); selections,
permutations and counts exactly.  Tied inputs (exact zeros, equal
importances, one-hot rows) hold the port's subgradients to JAX's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.compress import quantize as jq  # noqa: E402
from repro.core import channel_selection as jcs  # noqa: E402
from repro.core import skewness as jsk  # noqa: E402
from repro.core import splitter as jsplit  # noqa: E402
from repro.core import xai as jxai  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.compress import quantize as tq  # noqa: E402
from repro_torch.core import channel_selection as tcs  # noqa: E402
from repro_torch.core import skewness as tsk  # noqa: E402
from repro_torch.core import splitter as tsplit  # noqa: E402
from repro_torch.core import xai as txai  # noqa: E402
from repro_torch.kernels.topk_split.ops import (  # noqa: E402
    ChannelPermute,
    channel_permute_op,
    inverse_permutation,
)
from repro_torch.kernels.topk_split.ref import channel_permute_ref  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = 1e-5
C, K = 24, 5
# reference NN at width 32: 4 channels per GroupNorm group (8 groups)
REF_WIDTH, REF_BLOCKS, FEAT = 32, 2, 4


def _np(shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).standard_normal(shape)
            ).astype(np.float32)


def _bridge(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                             device="cpu")


def _close(want, got, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def _grad_close(want, got):
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got.detach().numpy().astype(np.float64) - want).max()
    assert err <= GRAD_TOL * scale, (err, scale)


@pytest.fixture(scope="module")
def reference():
    """(JAX reference NN params, bridged), and features with exact zeros
    (ReLU6 clips the negative half; channel 2 of every sample and channel
    7 of sample 0 are zero everywhere, so their importance is exactly 0),
    labels."""
    jp = jcnn.reference_nn_init(jax.random.PRNGKey(5), C, 10, width=REF_WIDTH,
                                blocks=REF_BLOCKS)
    feats = np.clip(_np((4, FEAT, FEAT, C), 3, 2.0), 0.0, 6.0)
    feats[..., 2] = 0.0
    feats[0, ..., 7] = 0.0
    labels = np.array([1, 7, 3, 3], np.int32)
    return jp, _bridge(jp), feats, labels


# ------------------------------------------------------------ quantizer ----
def test_quantize_ste_value_and_gradients_match_jax():
    centers = np.linspace(-2.0, 2.0, 8).astype(np.float32)
    x = _np((3, 5, 19), 1, 1.5)
    w = _np((3, 5, 19), 2)

    def jloss(c, xx):
        return jnp.sum(jq.quantize_ste({"centers": c}, xx) * w)

    (jv, (jgc, jgx)) = (jq.quantize_ste({"centers": jnp.asarray(centers)},
                                        jnp.asarray(x)),
                        jax.grad(jloss, argnums=(0, 1))(jnp.asarray(centers),
                                                        jnp.asarray(x)))
    tc = torch.tensor(centers, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    tv = tq.quantize_ste({"centers": tc}, tx)
    # forward: the hard nearest-center values
    hard = tq.dequantize({"centers": tc.detach()},
                         tq.hard_indices({"centers": tc.detach()}, tx.detach()))
    _close(hard, tv, atol=1e-6, rtol=0)
    _close(jv, tv, atol=1e-6, rtol=0)
    torch.sum(tv * torch.from_numpy(w)).backward()
    _grad_close(jgc, tc.grad)
    _grad_close(jgx, tx.grad)


# ------------------------------------------------------------------ XAI ----
@pytest.mark.parametrize("method", ["ig", "saliency"])
def test_evaluate_importance_matches_jax(reference, method):
    jp, tp, feats, labels = reference
    want = jxai.evaluate_importance(
        lambda f: jcnn.reference_nn_apply(jp, f), jnp.asarray(feats),
        jnp.asarray(labels), method=method, steps=4)
    got = txai.evaluate_importance(
        lambda f: tcnn.reference_nn_apply(tp, f), torch.from_numpy(feats),
        torch.from_numpy(labels), method=method, steps=4)
    assert got.shape == (4, C) and not got.requires_grad
    _close(want, got)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-6)
    # the zeroed channels get exactly 0 from IG, as in JAX
    if method == "ig":
        zero = np.asarray(want) == 0
        assert zero.any() and (got.numpy()[zero] == 0).all()


@pytest.mark.parametrize("method", ["ig", "saliency"])
def test_attribution_maps_match_jax(reference, method):
    jp, tp, feats, labels = reference
    jf = {"ig": lambda *a: jxai.integrated_gradients(*a, steps=3),
          "saliency": jxai.gradient_saliency}[method]
    tf = {"ig": lambda *a: txai.integrated_gradients(*a, steps=3),
          "saliency": txai.gradient_saliency}[method]
    want = jf(lambda f: jcnn.reference_nn_apply(jp, f), jnp.asarray(feats),
              jnp.asarray(labels))
    got = tf(lambda f: tcnn.reference_nn_apply(tp, f), torch.from_numpy(feats),
             torch.from_numpy(labels))
    _close(want, got)


@pytest.mark.parametrize("method", ["ig", "saliency"])
def test_importance_gradient_matches_jax(reference, method):
    """The importance is differentiable in the features (the second
    derivative agile_loss takes): d sum(w * I(F)) / dF against JAX."""
    jp, tp, feats, labels = reference
    w = _np((4, C), 9)

    def jloss(f):
        return jnp.sum(w * jxai.evaluate_importance(
            lambda g: jcnn.reference_nn_apply(jp, g), f, jnp.asarray(labels),
            method=method, steps=3))

    want = jax.grad(jloss)(jnp.asarray(feats))
    tf = torch.tensor(feats, requires_grad=True)
    imp = txai.evaluate_importance(lambda g: tcnn.reference_nn_apply(tp, g), tf,
                                   torch.from_numpy(labels), method=method,
                                   steps=3)
    (got,) = torch.autograd.grad(torch.sum(torch.from_numpy(w) * imp), tf)
    _grad_close(want, got)


def test_importance_on_detached_features_keeps_no_graph(reference):
    _, tp, feats, labels = reference
    f = torch.from_numpy(feats)
    imp = txai.evaluate_importance(lambda g: tcnn.reference_nn_apply(tp, g), f,
                                   torch.from_numpy(labels), steps=2)
    assert imp.grad_fn is None and not f.requires_grad
    with torch.no_grad():     # also under no_grad: the gradients are taken
        imp2 = txai.evaluate_importance(lambda g: tcnn.reference_nn_apply(tp, g),
                                        f, torch.from_numpy(labels), steps=2)
    assert torch.equal(imp, imp2)
    with pytest.raises(ValueError, match="unknown XAI method"):
        txai.evaluate_importance(lambda g: g, f, torch.from_numpy(labels),
                                 method="shap")


@pytest.mark.parametrize("shape", [(3, 5, 5, 7), (4, 6)])
def test_channel_importance_matches_jax(shape):
    attr = np.abs(_np(shape, 4))
    attr[0] = 0.0                       # an all-zero row: divided by 1e-12
    _close(jxai.channel_importance(jnp.asarray(attr)),
           txai.channel_importance(torch.from_numpy(attr)))


# -------------------------------------------------------------- skewness ---
def _importance_cases():
    rng = np.random.RandomState(0)
    rand = rng.dirichlet(np.ones(C), size=6).astype(np.float32)
    ties = np.full((4, C), 1.0 / C, np.float32)          # every channel tied
    ties[1, :8] = 0.0
    ties[1, 8:] = 1.0 / (C - 8)                          # zeros tied at the top-k
    ties[2] = 0.0
    ties[2, [0, 3, 9, 10]] = 0.25                        # ties across the split
    ties[3] = np.repeat(rng.dirichlet(np.ones(C // 2)), 2).astype(np.float32) / 2
    ideal = np.zeros((3, C), np.float32)
    ideal[:, 0] = 1.0                                    # agile_loss's invalid rows
    return {"random": rand, "ties": ties, "ideal": ideal,
            "mixed": np.concatenate([rand[:2], ideal[:1], ties[1:3]])}


IMPORTANCE = _importance_cases()
LOSSES = {
    "disorder_loss": (lambda m, i: m.disorder_loss(i, K)),
    "skewness_loss": (lambda m, i: m.skewness_loss(i, K, 0.8)),
    "descent_loss": (lambda m, i: m.descent_loss(i)),
    "topk_mass": (lambda m, i: m.topk_mass(i, K)),
    "achieved_skewness": (lambda m, i: m.achieved_skewness(i, K)),
    "natural_skewness": (lambda m, i: m.natural_skewness(i)),
    "natural_skewness_frac": (lambda m, i: m.natural_skewness(i, 0.5)),
}


@pytest.mark.parametrize("case", sorted(IMPORTANCE))
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_skewness_losses_and_gradients_match_jax(name, case):
    imp = IMPORTANCE[case]
    fn = LOSSES[name]
    jv = fn(jsk, jnp.asarray(imp))
    ti = torch.tensor(imp, requires_grad=True)
    tv = fn(tsk, ti)
    _close(jv, tv)
    cot = _np(np.shape(jv), 7) if np.ndim(jv) else np.float32(1.0)
    jg = jax.grad(lambda i: jnp.sum(fn(jsk, i) * cot))(jnp.asarray(imp))
    (tg,) = torch.autograd.grad(torch.sum(tv * torch.as_tensor(cot)), ti)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("case", sorted(IMPORTANCE))
def test_disorder_rate_matches_jax(case):
    imp = IMPORTANCE[case]
    assert (float(tsk.disorder_rate(torch.from_numpy(imp), K))
            == float(jsk.disorder_rate(jnp.asarray(imp), K)))


@pytest.mark.parametrize("ordering", ["disorder", "descent"])
def test_combined_loss_matches_jax(ordering):
    imp = IMPORTANCE["mixed"]
    jt, jm = jsk.combined_loss(jnp.float32(1.25), jnp.asarray(imp), k=K, rho=0.8,
                               lam=0.3, ordering=ordering)
    tt, tm = tsk.combined_loss(torch.tensor(1.25), torch.from_numpy(imp), k=K,
                               rho=0.8, lam=0.3, ordering=ordering)
    _close(jt, tt)
    assert sorted(tm) == sorted(jm)
    for key in jm:
        _close(jm[key], tm[key])


# ------------------------------------------------------ the permute op -----
PERM = tuple(int(p) for p in np.random.RandomState(1).permutation(C))


def test_inverse_permutation():
    inv = inverse_permutation(PERM)
    assert tuple(PERM[i] for i in inv) == tuple(range(C))
    assert tuple(inv[p] for p in PERM) == tuple(range(C))


def _permute(x, perm=PERM):
    return ChannelPermute.apply(x, perm, channel_permute_ref)


def test_permute_function_gradcheck_and_gradgradcheck():
    """The Function around the kernel, with the plain permute as its body,
    in float64: its backward (the body with the inverse permutation) and
    that backward's own backward."""
    x = torch.randn(5, C, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(_permute, (x,))
    assert torch.autograd.gradgradcheck(_permute, (x,))


def test_permute_function_backward_is_the_body_with_the_inverse():
    calls = []

    def body(x, perm):
        calls.append(perm)
        return channel_permute_ref(x, perm)

    x = torch.randn(3, C, requires_grad=True)
    g = torch.randn(3, C, requires_grad=True)
    y = ChannelPermute.apply(x, PERM, body)
    (gx,) = torch.autograd.grad(y, x, g, create_graph=True)
    assert calls == [PERM, inverse_permutation(PERM)]
    assert torch.equal(y, x[:, list(PERM)])
    assert torch.equal(gx, g[:, list(inverse_permutation(PERM))])
    # double backward: the body again, with the inverse of the inverse
    v = torch.randn(3, C)
    (gg,) = torch.autograd.grad(gx, g, v)
    assert calls[-1] == PERM and torch.equal(gg, v[:, list(PERM)])


def test_channel_permute_op_and_mapping_layer_match_jax():
    """On CPU tensors the op is the plain indexing, differentiable; the
    splitter's mapping layer equals JAX's ``apply_channel_permutation``."""
    x = _np((2, 3, 3, C), 5)
    got = tsplit.apply_channel_permutation(torch.from_numpy(x), np.array(PERM))
    want = jsplit.apply_channel_permutation(jnp.asarray(x), jnp.asarray(PERM))
    assert got.numpy().tobytes() == np.asarray(want).tobytes()
    tx = torch.tensor(x, requires_grad=True)
    g = _np(x.shape, 6)
    (gx,) = torch.autograd.grad(channel_permute_op(tx, PERM), tx, torch.from_numpy(g))
    jg = jax.vjp(lambda f: jnp.take(f, jnp.asarray(PERM), axis=-1),
                 jnp.asarray(x))[1](jnp.asarray(g))[0]
    assert gx.numpy().tobytes() == np.asarray(jg).tobytes()


# ----------------------------------------------------- channel selection ---
@pytest.mark.parametrize("case", sorted(IMPORTANCE))
@pytest.mark.parametrize("k", [1, K, 12])
def test_topk_channel_counts_match_jax_on_ties(case, k):
    imp = IMPORTANCE[case]
    want = np.asarray(jcs.topk_channel_counts(jnp.asarray(imp), k))
    got = tcs.topk_channel_counts(torch.from_numpy(imp), k)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_select_initial_channels_and_mapping_match_jax():
    batches = [IMPORTANCE[c] for c in ("random", "ties", "ideal", "mixed")]
    want = jcs.select_initial_channels(lambda b: b, lambda f, b: jnp.asarray(f),
                                       batches, K)
    got = tcs.select_initial_channels(lambda b: b,
                                      lambda f, b: torch.from_numpy(f), batches, K)
    np.testing.assert_array_equal(got, want)
    perm = tcs.build_mapping_permutation(got, C)
    assert isinstance(perm, tuple)
    assert perm == tuple(int(p) for p in jcs.build_mapping_permutation(want, C))
    assert sorted(perm) == list(range(C)) and perm[:K] == tuple(int(c) for c in got)


def test_permute_reference_stem_matches_jax_in_oihw(reference):
    """The stem equals JAX's ``w[:, :, perm, :]`` bridged, exactly; the
    permuted-stem reference NN on mapped features equals the old one on
    raw features up to the order of the stem's sum (1e-5)."""
    jp, tp, feats, _ = reference
    new = tcs.permute_reference_stem(tp, PERM)
    want = _bridge(jcs.permute_reference_stem(jp, np.array(PERM)))
    assert torch.equal(new["stem"]["w"], want["stem"]["w"])
    assert torch.equal(tp["stem"]["w"], _bridge(jp)["stem"]["w"])   # not in place
    raw = torch.from_numpy(feats)
    mapped = channel_permute_op(raw, PERM)
    # the stem's 1x1 conv sums its input channels in the mapped order
    _close(tcnn.reference_nn_apply(tp, raw), tcnn.reference_nn_apply(new, mapped))


def test_fold_permutation_into_conv_matches_jax_in_oihw():
    """The extractor with its last conv folded emits the mapped features;
    the folded conv equals JAX's ``w[..., perm]`` / ``b[perm]`` bridged."""
    jex = jcnn.extractor_init(jax.random.PRNGKey(2), channels=C, n_layers=2)
    jex["convs"][-1]["b"] = jnp.asarray(_np((C,), 8))
    tex = _bridge(jex)
    folded = tcs.fold_permutation_into_conv(tex["convs"][-1], PERM)
    want = _bridge(jcs.fold_permutation_into_conv(jex["convs"][-1], np.array(PERM)))
    assert torch.equal(folded["w"], want["w"]) and torch.equal(folded["b"], want["b"])
    x = torch.from_numpy(_np((2, 16, 16, 3), 9))
    out = tcnn.extractor_apply({"convs": [tex["convs"][0], folded]}, x)
    assert torch.equal(out, channel_permute_op(tcnn.extractor_apply(tex, x), PERM))
