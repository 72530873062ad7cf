"""The port's AgileNN training path on the CPU (the training branch of
``core/agile.py``, the optimizers, the staged pipeline, the loop, the
checkpoints and the image data pipeline) against the JAX package, on
params initialized in JAX and bridged, and seeded numpy inputs.

Widths keep 4 or more channels per GroupNorm group (remote and reference
width 32).  Tolerances, each with its reason:
- values at atol = rtol = 1e-5 fp32: sums run in another order;
- gradients at 1e-5 of the largest |gradient| of the leaf
  (``_grad_close``): first and second derivatives through the same sums;
- optimizer updates at atol = rtol = 1e-6: elementwise, but XLA may fuse
  the multiply-adds;
- a few training steps at atol = 1e-5: the rounding above, fed back;
- a whole pipeline run against JAX's measured report (not the system
  test's thresholds) at 0.03: over the run the two trajectories part
  (fp32 training is chaotic), and the report's rates count discrete
  flips over 512 images; the channel mapping and the port against itself
  exactly;
- selections, mappings and checkpoints exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import io as jio  # noqa: E402
from repro.configs.agilenn_cifar import AgileNNConfig as JaxConfig  # noqa: E402
from repro.configs.base import AgileSpec as JaxSpec  # noqa: E402
from repro.core import agile as jagile  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.data.synthetic import ImageDatasetSpec as JaxDataSpec  # noqa: E402
from repro.data.synthetic import SyntheticImages as JaxImages  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.nn.module import split_keys  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro.train import agile_pipeline as jtrain  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch import tree_leaves, tree_map, value_and_grad  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.checkpoint import io as tio  # noqa: E402
from repro_torch.configs.agilenn_cifar import AgileNNConfig, AgileSpec  # noqa: E402
from repro_torch.core import agile  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.data.synthetic import ImageDatasetSpec, SyntheticImages  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402
from repro_torch.optim import sgd as tsgd  # noqa: E402
from repro_torch.train import agile_pipeline as train  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = 1e-5
OPT_TOL = dict(atol=1e-6, rtol=1e-6)
REPORT_TOL = 0.03

_SIZES = dict(image_size=16, remote_width=32, remote_blocks=2,
              reference_width=32, reference_blocks=2)
JCFG = JaxConfig(**_SIZES, agile=JaxSpec(enabled=True, extractor_channels=24,
                                         k=5, rho=0.8, lam=0.3, ig_steps=3))
CFG = AgileNNConfig(**_SIZES, agile=AgileSpec(enabled=True, extractor_channels=24,
                                              k=5, rho=0.8, lam=0.3, ig_steps=3))
# tests/test_system.py's configuration
_SYS = dict(image_size=16, remote_width=24, remote_blocks=2,
            reference_width=32, reference_blocks=3)
SYS_JCFG = JaxConfig(**_SYS, agile=JaxSpec(enabled=True, extractor_channels=24,
                                           k=5, rho=0.8, lam=0.3, ig_steps=4))
SYS_CFG = AgileNNConfig(**_SYS, agile=AgileSpec(enabled=True, extractor_channels=24,
                                                k=5, rho=0.8, lam=0.3, ig_steps=4))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bridge(tree):
    return params_from_numpy(_np(tree), device="cpu")


def _close(want, got, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def _grad_close(want, got, path=""):
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got.detach().numpy().astype(np.float64) - want).max()
    assert err <= GRAD_TOL * scale, (path, err, scale)


def _trees_close(want, got, **tol):
    """Every leaf of the bridged JAX tree ``want`` against the port's."""
    want, got = tree_leaves(_bridge(want)), tree_leaves(got)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        if isinstance(w, torch.Tensor):
            _close(w.numpy(), g, **tol)
        else:
            assert w == g


@pytest.fixture(scope="module")
def system():
    """JAX params (shuffled mapping), a reference NN, a batch whose
    reference predictions are right on some rows and wrong on others;
    and the port's bridged copies."""
    jp = jagile.init_agile_params(JCFG, jax.random.PRNGKey(0))
    jp["mapping"] = jnp.asarray(np.random.RandomState(3).permutation(24), jnp.int32)
    jr = jcnn.reference_nn_init(jax.random.PRNGKey(1), 24, 10, width=32, blocks=2)
    x = np.random.RandomState(0).standard_normal((6, 16, 16, 3)).astype(np.float32)
    feats = jagile.extract_features(JCFG, jp, jnp.asarray(x))
    pred = np.asarray(jnp.argmax(jcnn.reference_nn_apply(jr, feats), -1))
    y = np.where(np.arange(6) % 2 == 0, pred, (pred + 1) % 10).astype(np.int32)
    return jp, jr, x, y, _bridge(jp), _bridge(jr)


# ---------------------------------------------------- the training branch --
@pytest.mark.parametrize("quantize", [True, False])
def test_agile_forward_train_matches_jax(system, quantize):
    jp, _, x, _, tp, _ = system
    lj, ij = jagile.agile_forward(JCFG, jp, jnp.asarray(x), train=True,
                                  quantize=quantize)
    lt, it = agile.agile_forward(CFG, tp, x, train=True, quantize=quantize)
    _close(lj, lt)
    for key in ("features", "local_logits", "remote_logits", "alpha"):
        _close(ij[key], it[key])


def test_batch_importance_and_cross_entropy_match_jax(system):
    jp, jr, x, y, tp, tr = system
    feats = np.array(jagile.extract_features(JCFG, jp, jnp.asarray(x)))
    ji, jv = jagile.batch_importance(JCFG, jr, jnp.asarray(feats), jnp.asarray(y))
    ti, tv = agile.batch_importance(CFG, tr, torch.from_numpy(feats),
                                    torch.from_numpy(y).long())
    _close(ji, ti)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert 0 < float(tv.mean()) < 1
    logits = np.random.RandomState(4).standard_normal((6, 10)).astype(np.float32)
    _close(jagile.cross_entropy(jnp.asarray(logits), jnp.asarray(y)),
           agile.cross_entropy(torch.from_numpy(logits), torch.from_numpy(y)))


@pytest.mark.parametrize("method,ordering,lam,valid", [
    ("ig", "disorder", None, "some"),
    ("saliency", "descent", 0.6, "some"),
    ("ig", "disorder", None, "none"),
])
def test_agile_loss_value_metrics_and_gradients_match_jax(system, method, ordering,
                                                          lam, valid):
    """Loss, metrics and the gradient of every param leaf, extractor and
    quantizer included, against ``jax.value_and_grad``.  'none': no row's
    reference prediction is right, so every row takes the one-hot ideal
    importance and only the prediction loss is left."""
    jp, jr, x, y, tp, tr = system
    if valid == "none":
        feats = jagile.extract_features(JCFG, jp, jnp.asarray(x))
        pred = np.asarray(jnp.argmax(jcnn.reference_nn_apply(jr, feats), -1))
        y = ((pred + 1) % 10).astype(np.int32)
    jmap = jp["mapping"]
    jtrainable = {k: v for k, v in jp.items() if k != "mapping"}

    @jax.jit
    def jvg(p, images, labels):
        return jax.value_and_grad(
            lambda q: jagile.agile_loss(JCFG, {**q, "mapping": jmap}, jr, images,
                                        labels, xai_method=method,
                                        ordering=ordering, lam=lam),
            has_aux=True)(p)

    (jl, jm), jg = jvg(jtrainable, jnp.asarray(x), jnp.asarray(y))
    tmap = tp["mapping"]
    ttrainable = {k: v for k, v in tp.items() if k != "mapping"}
    ref_live = tree_map(lambda t: t.clone().requires_grad_(), tr)
    (tl, tm), tg = value_and_grad(
        lambda q: agile.agile_loss(CFG, {**q, "mapping": tmap}, ref_live, x, y,
                                   xai_method=method, ordering=ordering, lam=lam),
        ttrainable)
    _close(jl, tl)
    assert sorted(tm) == sorted(jm)
    for key in jm:
        _close(jm[key], tm[key])
        assert not tm[key].requires_grad
    if valid == "none":
        assert float(tm["xai_valid_fraction"]) == 0.0
        assert float(tm["loss_skewness"]) == 0.0 == float(tm["loss_disorder"])
    else:
        assert 0 < float(tm["xai_valid_fraction"]) < 1
    flat_j = jax.tree_util.tree_flatten_with_path(_bridge(jg))[0]
    flat_t = dict(jax.tree_util.tree_flatten_with_path(tg)[0])
    assert len(flat_j) == len(flat_t) == 31
    for path, want in flat_j:
        _grad_close(want.numpy(), flat_t[path], jax.tree_util.keystr(path))
    # the reference NN is detached: no gradient reaches it
    assert all(t.grad is None for t in tree_leaves(ref_live))


def test_agile_loss_backpropagates_through_the_importance(system):
    """With lam = 1 only the prediction loss is left; at lam < 1 the
    extractor's gradient changes through the XAI importance, as in JAX."""
    _, _, x, y, tp, tr = system
    trainable = {k: v for k, v in tp.items() if k != "mapping"}
    grads = {}
    for lam in (1.0, 0.3):
        _, g = value_and_grad(
            lambda q: agile.agile_loss(CFG, {**q, "mapping": tp["mapping"]}, tr, x,
                                       y, lam=lam), trainable)
        grads[lam] = g["extractor"]["convs"][0]["w"]
    assert not torch.allclose(grads[1.0] * 0.3, grads[0.3], atol=1e-6)


# ------------------------------------------- convolutions under autograd --
@pytest.mark.parametrize("stride,groups,H,bias", [
    (1, 1, 5, True), (2, 1, 6, False), (2, 4, 7, False), (1, 4, 6, True),
    (2, 4, 8, True)])
def test_conv_function_gradcheck_and_gradgradcheck(stride, groups, H, bias):
    """The conv that ``nn.linear.conv2d`` runs under autograd: its backward
    (transposed conv, weight gradient, bias sum) and that backward's own
    backward, in float64."""
    from repro_torch.nn.linear import _Conv2d

    gen = torch.Generator().manual_seed(H)
    x = torch.randn(2, 4, H, H, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    w = torch.randn(4, 4 // groups, 3, 3, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    args = (x, w)
    if bias:
        args += (torch.randn(4, dtype=torch.float64, generator=gen,
                             requires_grad=True),)

    def f(x, w, *b):
        return torch.tanh(_Conv2d.apply(x, w, b[0] if b else None, stride, groups))

    assert torch.autograd.gradcheck(f, args)
    assert torch.autograd.gradgradcheck(f, args)


def test_conv_second_derivative_is_one_grouped_call():
    """Through a depthwise conv with a detached weight, the IG pattern (a
    gradient with create_graph, then the gradient of that) launches a few
    convolutions, not one per channel as autograd's own double backward of
    a grouped conv does."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.nn.linear import conv2d

    C = 64
    p = {"w": torch.randn(C, 1, 3, 3)}
    x = torch.randn(2, 8, 8, C, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        f = x * 1.0
        y = torch.tanh(conv2d(p, f, stride=2, groups=C))
        (g,) = torch.autograd.grad(y.sum(), f, create_graph=True)
        (gx,) = torch.autograd.grad((g * g).sum(), x)
    convs = sum(1 for e in prof.events() if e.name == "aten::convolution")
    assert convs <= 4, convs
    # the values are those of the plain conv's derivatives
    f = x.detach().requires_grad_()
    y = torch.tanh(torch.nn.functional.conv2d(
        torch.nn.functional.pad(f.permute(0, 3, 1, 2), (0, 1, 0, 1)), p["w"],
        stride=2, groups=C)).permute(0, 2, 3, 1)
    (g2,) = torch.autograd.grad(y.sum(), f, create_graph=True)
    (gx2,) = torch.autograd.grad((g2 * g2).sum(), f)
    _close(g2.detach().numpy(), g)
    _close(gx2.numpy(), gx)


# ------------------------------------------------------------ optimizers ---
def _opt_tree(seed):
    rng = np.random.RandomState(seed)
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": [{"w": rng.standard_normal((5,)).astype(np.float32)},
                  {"w": np.float32(rng.standard_normal())}]}


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_optimizers_match_jax(opt):
    jinit, jupd = {"sgd": (jsgd.sgd_init, jsgd.sgd_update),
                   "adamw": (jadamw.adamw_init, jadamw.adamw_update)}[opt]
    tinit, tupd = {"sgd": (tsgd.sgd_init, tsgd.sgd_update),
                   "adamw": (tadamw.adamw_init, tadamw.adamw_update)}[opt]
    jp, tp = _to_jax(_opt_tree(0)), _to_torch(_opt_tree(0))
    jo, to = jinit(jp), tinit(tp)
    for step in range(4):
        grads = _opt_tree(10 + step)
        jp, jo = jupd(jp, _to_jax(grads), jo, lr=0.05)
        tp, to = tupd(tp, _to_torch(grads), to, lr=0.05)
    for w, g in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
        _close(w, g, **OPT_TOL)
    for w, g in zip(jax.tree_util.tree_leaves(jo), tree_leaves(to)):
        _close(w, g, **OPT_TOL)


def test_optimizer_leaves_inputs_unchanged():
    tp = _to_torch(_opt_tree(0))
    before = [t.clone() for t in tree_leaves(tp)]
    tsgd.sgd_update(tp, _to_torch(_opt_tree(1)), tsgd.sgd_init(tp), lr=0.1)
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(tp)))


@pytest.mark.parametrize("step", [0, 3, 10, 55, 100, 149, 150, 400])
def test_schedules_match_jax(step):
    _close(jsched.cosine_schedule(step, base_lr=0.3, warmup=10, total=150,
                                  min_lr=0.01),
           tsched.cosine_schedule(step, base_lr=0.3, warmup=10, total=150,
                                  min_lr=0.01), atol=1e-7, rtol=1e-6)
    _close(jsched.step_decay(step, base_lr=0.3),
           tsched.step_decay(step, base_lr=0.3), atol=0, rtol=0)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    grads = _opt_tree(5)
    jc, jn = jsched.clip_by_global_norm(_to_jax(grads), max_norm)
    tc, tn = tsched.clip_by_global_norm(_to_torch(grads), max_norm)
    _close(jn, tn, **OPT_TOL)
    for w, g in zip(jax.tree_util.tree_leaves(jc), tree_leaves(tc)):
        _close(w, g, **OPT_TOL)


# -------------------------------------------------------------- pipeline ---
def _data(cfg_image_size=16, seed=0):
    spec = dict(n_classes=10, image_size=cfg_image_size, noise=0.35, seed=seed)
    return JaxImages(JaxDataSpec(**spec)), SyntheticImages(ImageDatasetSpec(**spec))


def _pipeline_init(jcfg, seed=0):
    """The initial params of JAX's run_full_pipeline(seed), as the port's
    ``init=`` tree and as JAX trees."""
    kk = split_keys(jax.random.PRNGKey(seed), ["pre", "joint"])
    k2 = split_keys(kk["pre"], ["ex", "ref"])
    init = {"ex": jcnn.extractor_init(k2["ex"], channels=24, n_layers=2),
            "ref": jcnn.reference_nn_init(k2["ref"], 24, 10,
                                          width=jcfg.reference_width,
                                          blocks=jcfg.reference_blocks)}
    init["joint"] = jagile.init_agile_params(jcfg, kk["joint"],
                                             extractor_params=init["ex"])
    return kk, init, _bridge(init)


def test_pretrain_reference_matches_jax():
    jd, td = _data()
    kk, _, tinit = _pipeline_init(JCFG)
    jex, jref, jacc = jtrain.pretrain_reference(JCFG, jd, kk["pre"], steps=3,
                                                batch_size=16)
    tex, tref, tacc = train.pretrain_reference(CFG, td, steps=3, batch_size=16,
                                               init=tinit, device="cpu")
    assert tacc == jacc
    _trees_close({"ex": jex, "ref": jref}, {"ex": tex, "ref": tref})


def test_joint_train_matches_jax(system):
    jp, jr, _, _, tp, tr = system
    jd, td = _data()
    jp2, jr2, jh = jtrain.joint_train(JCFG, jp, jr, jd, steps=3, batch_size=8,
                                      record_curve=True)
    tp2, tr2, th = train.joint_train(CFG, tp, tr, td, steps=3, batch_size=8,
                                     record_curve=True)
    assert tp2["mapping"] == tp["mapping"]
    _trees_close(jp2, tp2)
    _trees_close(jr2, tr2)
    assert [sorted(r) for r in th] == [sorted(r) for r in jh]
    for rj, rt in zip(jh, th):
        for key in rj:
            np.testing.assert_allclose(rt[key], rj[key], **TOL)


def test_run_channel_selection_matches_jax(system):
    jp, jr, _, _, tp, tr = system
    jd, td = _data()
    want = jtrain.run_channel_selection(JCFG, jp["extractor"], jr, jd,
                                        n_batches=2, batch_size=16)
    got = train.run_channel_selection(CFG, tp["extractor"], tr, td, n_batches=2,
                                      batch_size=16)
    assert isinstance(got, tuple)
    assert got == tuple(int(p) for p in want)


def test_finalize_for_deployment_matches_jax_and_keeps_predictions(system):
    jp, _, x, _, tp, _ = system
    tf = train.finalize_for_deployment(CFG, tp)
    assert tf["mapping"] == tuple(range(24)) and tp["mapping"] != tf["mapping"]
    _trees_close(jtrain.finalize_for_deployment(JCFG, jp), tf, atol=0, rtol=0)
    before, _ = agile.agile_forward(CFG, tp, x)
    after, _ = agile.agile_forward(CFG, tf, x)
    _close(before.numpy(), after)
    assert torch.equal(before.argmax(-1), after.argmax(-1))


def test_evaluate_matches_jax(system):
    jp, jr, _, _, tp, tr = system
    jd, td = _data()
    want = jtrain.evaluate(JCFG, jp, jr, jd, n_batches=2, batch_size=16)
    got = train.evaluate(CFG, tp, tr, td, n_batches=2, batch_size=16)
    assert sorted(got) == sorted(want)
    for key in want:
        assert abs(got[key] - want[key]) <= 1e-5, (key, got, want)


def test_run_full_pipeline_matches_jax_report_and_reruns_bitwise():
    """tests/test_system.py's configuration, shortened (4 + 3 steps), from
    the JAX run's own initial params: the mapping of Alg. 1 is JAX's, the
    report and the loss curve are JAX's measured ones within REPORT_TOL,
    and a second run of the port is bitwise the first."""
    _, _, tinit = _pipeline_init(SYS_JCFG)
    _, _, jrep, jhist, _ = jtrain.run_full_pipeline(
        SYS_JCFG, pretrain_steps=4, joint_steps=3, batch_size=32)
    runs = [train.run_full_pipeline(SYS_CFG, pretrain_steps=4, joint_steps=3,
                                    batch_size=32, init=tinit, device="cpu")
            for _ in range(2)]
    tp, _, trep, thist, _ = runs[0]
    assert tp["mapping"] == tuple(range(24))          # folded at stage D
    assert sorted(trep) == sorted(jrep)
    for key in jrep:
        assert abs(trep[key] - jrep[key]) <= REPORT_TOL, (key, trep, jrep)
    assert len(thist) == len(jhist) == 3
    for rj, rt in zip(jhist, thist):
        assert abs(rt["loss"] - rj["loss"]) <= 1e-3, (rt, rj)
    again = runs[1]
    assert again[2] == trep and again[3] == thist
    for a, b in zip(tree_leaves(again[0]), tree_leaves(tp)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def test_pipeline_mapping_matches_jax():
    """Stage B on stage A's output: the same mapping as JAX's on the same
    pre-trained weights, then the permuted reference stem."""
    jd, td = _data()
    kk, _, tinit = _pipeline_init(SYS_JCFG)
    jex, jref, _ = jtrain.pretrain_reference(SYS_JCFG, jd, kk["pre"], steps=2,
                                             batch_size=32)
    want = jtrain.run_channel_selection(SYS_JCFG, jex, jref, jd, n_batches=2)
    got = train.run_channel_selection(SYS_CFG, _bridge(jex), _bridge(jref), td,
                                      n_batches=2)
    assert got == tuple(int(p) for p in want)


# ----------------------------------------------------------- checkpoints ---
def test_checkpoint_written_by_jax_restores_in_the_port(system, tmp_path):
    jp, jr, _, _, tp, _ = system
    path = str(tmp_path / "jax.npz")
    jio.save_checkpoint(path, {"params": jp, "ref": jr})
    like = tree_map(torch.zeros_like,
                                  {"params": {k: v for k, v in tp.items()
                                              if k != "mapping"},
                                   "ref": _bridge(jr)})
    like["params"]["mapping"] = tuple(range(24))
    got = tio.restore_checkpoint(path, like)
    assert got["params"]["mapping"] == tp["mapping"]
    for w, g in zip(tree_leaves(_bridge({"params": jp, "ref": jr})),
                    tree_leaves(got)):
        assert torch.equal(w, g) if isinstance(w, torch.Tensor) else w == g


def test_checkpoint_written_by_the_port_restores_in_jax(system, tmp_path):
    jp, jr, _, _, tp, tr = system
    path = str(tmp_path / "port.npz")
    tio.save_checkpoint(path, {"params": tp, "ref": tr})
    like = jax.tree_util.tree_map(jnp.zeros_like, {"params": jp, "ref": jr})
    got = jio.restore_checkpoint(path, like)
    for w, g in zip(jax.tree_util.tree_leaves({"params": jp, "ref": jr}),
                    jax.tree_util.tree_leaves(got)):
        assert np.asarray(w).tobytes() == np.asarray(g).tobytes()
    # and back into the port: the same tree, bitwise
    back = tio.restore_checkpoint(path, {"params": tp, "ref": tr})
    for w, g in zip(tree_leaves({"params": tp, "ref": tr}), tree_leaves(back)):
        assert torch.equal(w, g) if isinstance(w, torch.Tensor) else w == g


def test_checkpoint_refuses_a_wrong_shape(system, tmp_path):
    _, _, _, _, tp, _ = system
    path = str(tmp_path / "ck")
    tio.save_checkpoint(path, {"w": tp["local"]["fc"]["w"]})
    with pytest.raises(ValueError, match="shape"):
        tio.restore_checkpoint(path + ".npz", {"w": torch.zeros(3, 3)})


# ------------------------------------------------------- loop and data -----
def _quadratic_step(p, o, batch):
    g = 2 * p["w"]
    m = 0.9 * o["m"] + g
    return {"w": p["w"] - 0.05 * m}, {"m": m}, {"loss": p["w"] ** 2,
                                                 "vec": torch.zeros(2)}


def _batches():
    while True:
        yield {}


def test_run_training_matches_jax(tmp_path):
    """The loop's history against JAX's on the same quadratic, and the
    periodic checkpoint."""
    @jax.jit
    def jstep(p, o, batch):
        g = 2 * p["w"]
        m = 0.9 * o["m"] + g
        return {"w": p["w"] - 0.05 * m}, {"m": m}, {"loss": p["w"] ** 2}

    loop_cfg = dict(total_steps=120, log_every=40)
    js = jloop.run_training(jloop.TrainState({"w": jnp.asarray(4.0)},
                                             {"m": jnp.zeros(())}),
                            jstep, _batches(), loop=jloop.LoopConfig(**loop_cfg))
    ckpt = str(tmp_path / "loop.npz")
    logged = []
    ts = tloop.run_training(tloop.TrainState({"w": torch.tensor(4.0)},
                                             {"m": torch.zeros(())}),
                            _quadratic_step, _batches(),
                            loop=tloop.LoopConfig(ckpt_every=60, ckpt_path=ckpt,
                                                  **loop_cfg),
                            on_log=logged.append)
    assert ts.step == js.step == 120 and abs(float(ts.params["w"])) < 1e-2
    assert [r["step"] for r in ts.history] == [r["step"] for r in js.history]
    for rt, rj in zip(ts.history, js.history):
        assert "vec" not in rt
        np.testing.assert_allclose(rt["loss"], rj["loss"], rtol=1e-5, atol=1e-12)
    assert logged == ts.history
    restored = tio.restore_checkpoint(ckpt, {"w": torch.zeros(())})
    assert torch.equal(restored["w"], ts.params["w"])


def test_image_batch_fn_and_loader_match_jax():
    jd, td = _data(seed=3)
    jfn, tfn = jpipe.image_batch_fn(jd, 4, seed_base=7), tpipe.image_batch_fn(td, 4, seed_base=7)
    for step in (0, 5):
        jb, tb = jfn(step), tfn(step)
        assert sorted(jb) == sorted(tb) == ["images", "labels"]
        for key in jb:
            assert np.asarray(jb[key]).tobytes() == tb[key].tobytes()
    loader = tpipe.HostDataLoader(tfn, prefetch=2, device="cpu")
    try:
        b0, b1 = next(loader), next(loader)
    finally:
        loader.close()
    assert isinstance(b0["images"], torch.Tensor)
    assert b0["images"].numpy().tobytes() == tfn(0)["images"].tobytes()
    assert b1["labels"].numpy().tobytes() == tfn(1)["labels"].tobytes()
    s = tpipe.host_slice(tfn(2), host_id=1, n_hosts=2)
    assert s["images"].tobytes() == tfn(2)["images"][2:].tobytes()
    assert jpipe.host_slice(jfn(2), host_id=1, n_hosts=2)["labels"].tolist() \
        == s["labels"].tolist()


def test_loader_propagates_errors_and_closes():
    def bad(step):
        raise ValueError("boom")

    loader = tpipe.HostDataLoader(bad)
    try:
        with pytest.raises(ValueError, match="boom"):
            next(loader)
    finally:
        loader.close()
    loader._thread.join(timeout=5)
    assert not loader._thread.is_alive()


def test_configs_match_jax():
    assert dataclasses.asdict(CFG) == dataclasses.asdict(JCFG)
    assert dataclasses.asdict(SYS_CFG) == dataclasses.asdict(SYS_JCFG)
