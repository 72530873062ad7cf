"""The port's VLM backbone (internvl2-1b) on the CPU against the JAX
package, with the JAX weights of the reduced config bridged over and the
same seeded inputs: ``_embed_inputs`` (the projected patches in front of
the tokens, their labels -100), ``forward_loss`` with every gradient
leaf, ``prefill`` / ``decode_step`` with patches, greedy
``ServeEngine.generate`` with patches, a ``make_train_step`` step on
patches; and the requests the engine refuses.

Tolerances, each with its reason:
- embeddings, logits, caches at 1e-5: fp32 sums run in another order;
- gradients at 1e-5 of the largest |gradient| of the leaf;
- a train step's new params at 1e-6 + 1e-5 relative: the gradients'
  rounding times lr;
- labels and greedy tokens exactly.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import InputShape as JaxShape  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import backbone as jbb  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch import tree_leaves, tree_map, value_and_grad  # noqa: E402
from repro_torch.bridge import backbone_params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import backbone as tbb  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

ARCH = "internvl2-1b"
TOL, GRAD_TOL = 1e-5, 1e-5
KEY = jax.random.PRNGKey(0)
B, T, MAX_LEN = 2, 10, 40


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.RandomState(seed).standard_normal(shape)).astype(np.float32)


def close(jax_out, torch_out, tol=TOL):
    np.testing.assert_allclose(torch_out.detach().numpy(), np.asarray(jax_out),
                               atol=tol, rtol=tol)


def grad_close(ref, got, what=""):
    ref = np.asarray(ref, np.float64)
    got = got.detach().double().numpy()
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert got.shape == ref.shape, what
    assert err <= GRAD_TOL * scale, f"{what}: max |err| {err:.3e} > {GRAD_TOL} x {scale:.3e}"


@pytest.fixture(scope="module")
def model():
    """JAX's reduced internvl2-1b (2 layers, d 256, 8 patches of 64), its
    params bridged into the port, and a labelled batch with patches."""
    jcfg = jax_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    assert (cfg.vlm.n_patches, cfg.vlm.vision_dim) == (8, 64)
    jp = jbb.init_params(jcfg, KEY)
    params = backbone_params_from_numpy(_np(jp), cfg, device="cpu")
    assert sorted(params) == sorted(jp) and "vision_proj" in params
    rng = np.random.RandomState(21)
    tokens = rng.randint(0, cfg.vocab, (B, T)).astype(np.int32)
    labels = rng.randint(0, cfg.vocab, (B, T)).astype(np.int32)
    labels[0, 2] = -100
    patches = _normal((B, cfg.vlm.n_patches, cfg.vlm.vision_dim), 22)
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, params=params,
                batch={"tokens": tokens, "labels": labels, "patches": patches})


@pytest.mark.parametrize("keys", [("tokens", "labels", "patches"), ("tokens", "patches"),
                                  ("tokens", "labels")])
def test_embed_inputs_match_jax(model, keys):
    """With and without labels, and a text-only batch."""
    batch = {k: model["batch"][k] for k in keys}
    xj, lj = jbb._embed_inputs(model["jcfg"], model["jp"],
                               {k: jnp.asarray(v) for k, v in batch.items()})
    xt, lt = tbb._embed_inputs(model["cfg"], model["params"], batch)
    close(xj, xt)
    P = model["cfg"].vlm.n_patches if "patches" in keys else 0
    assert xt.shape == (B, P + T, model["cfg"].d_model)
    if "labels" not in keys:
        assert lj is None and lt is None
        return
    assert lt.tolist() == np.asarray(lj).tolist()
    assert (lt[:, :P] == -100).all()


def test_forward_loss_and_every_grad_leaf_match_jax(model):
    cfg, jcfg = model["cfg"], model["jcfg"]
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jbb.forward_loss(jcfg, p, model["batch"]), has_aux=True))(model["jp"])
    (loss, metrics), grads = value_and_grad(
        lambda p: tbb.forward_loss(cfg, p, model["batch"]), model["params"])
    close(jloss, loss)
    assert sorted(metrics) == sorted(jmetrics)
    got = tree_leaves(grads)
    ref = tree_leaves(backbone_params_from_numpy(_np(jgrads), cfg, device="cpu"))
    assert len(got) == len(ref) == len(tree_leaves(model["params"]))
    for i, (r, g) in enumerate(zip(ref, got)):
        assert torch.isfinite(g).all() and g.abs().max() > 0, f"leaf {i}"
        grad_close(r.numpy(), g, what=f"leaf {i}")
    hidden = {k: v for k, v in model["batch"].items() if k != "labels"}
    close(jbb.forward_hidden(jcfg, model["jp"], hidden),
          tbb.forward_hidden(cfg, model["params"], hidden))


def test_prefill_and_decode_match_jax(model):
    cfg, jcfg = model["cfg"], model["jcfg"]
    batch = {k: model["batch"][k] for k in ("tokens", "patches")}
    lj, cj, Tj = jbb.prefill(jcfg, model["jp"], {k: jnp.asarray(v) for k, v in batch.items()},
                             max_len=MAX_LEN)
    lt, ct, Tt = tbb.prefill(cfg, model["params"],
                             {k: torch.from_numpy(v) for k, v in batch.items()},
                             max_len=MAX_LEN)
    assert Tt == int(Tj) == cfg.vlm.n_patches + T
    close(lj, lt)
    for name in ("k", "v"):                 # JAX: (n_sb, 1, B, S, Hkv, D)
        assert ct[name].shape == (cfg.n_layers, B, MAX_LEN, cfg.n_kv_heads, 64)
        close(np.asarray(cj[name])[:, 0], ct[name])
    nxt = np.asarray(jnp.argmax(lj, -1))[:, None].astype(np.int32)
    for step in range(4):
        lj, cj = jbb.decode_step(jcfg, model["jp"], jnp.asarray(nxt), cj, Tt + step)
        lt, ct = tbb.decode_step(cfg, model["params"], torch.from_numpy(nxt).long(), ct,
                                 Tt + step)
        close(lj, lt)
        nxt = np.asarray(jnp.argmax(lj, -1))[:, None].astype(np.int32)


def _requests(cfg, n, req, new=6):
    rng = np.random.RandomState(23)
    return [req(tokens=rng.randint(0, cfg.vocab, 5), max_new_tokens=new,
                extras={"patches": _normal((cfg.vlm.n_patches, cfg.vlm.vision_dim), 30 + i)})
            for i in range(n)]


def test_greedy_generate_with_patches_matches_jax_engine(model):
    cfg = model["cfg"]
    jouts = JaxServeEngine(model["jcfg"], model["jp"], max_len=MAX_LEN).generate(
        _requests(cfg, 3, JaxRequest))
    outs = ServeEngine(cfg, model["params"], max_len=MAX_LEN, device="cpu").generate(
        _requests(cfg, 3, Request))
    assert [c.tokens.tolist() for c in outs] == [c.tokens.tolist() for c in jouts]
    assert [c.steps for c in outs] == [c.steps for c in jouts] == [6, 6, 6]


@pytest.mark.parametrize("case", ["mismatched_extras", "patches_past_max_len",
                                  "deadline_with_extras"])
def test_engine_refusals(model, case):
    """Extras keys must agree across a call; the context counts the
    patches (8 + 5 + 28 > 40); a deadline needs the scheduler, which takes
    no extras."""
    cfg = model["cfg"]
    reqs = _requests(cfg, 2, Request, new=28 if case == "patches_past_max_len" else 6)
    if case == "mismatched_extras":
        reqs[0].extras = {"frames": reqs[0].extras["patches"]}
    elif case == "deadline_with_extras":
        reqs[1].deadline_s = 5.0
    with pytest.raises(ValueError):
        ServeEngine(cfg, model["params"], max_len=MAX_LEN, device="cpu").generate(reqs)


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_with_patches_matches_jax(model, n_micro):
    """``make_train_step`` slices the patches into microbatches as it does
    the tokens."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    kw = dict(lr=0.05, momentum=0.9, weight_decay=0.01, n_micro_override=n_micro)
    jstep = jax.jit(jsteps.make_train_step(jcfg, JaxShape("t", T, B, "train"), **kw))
    jmom = jax.tree_util.tree_map(lambda p: 0.1 * jnp.ones_like(p), model["jp"])
    jp, jopt, jm = jstep(model["jp"], {"momentum": jmom}, model["batch"])
    step = tsteps.make_train_step(cfg, InputShape("t", T, B, "train"), **kw)
    opt = {"momentum": tree_map(lambda p: 0.1 * torch.ones_like(p), model["params"])}
    p, opt, m = step(model["params"], opt, model["batch"])
    close(jm["loss"], m["loss"])
    for name, jt, tt in (("params", jp, p), ("momentum", jopt["momentum"], opt["momentum"])):
        ref = tree_leaves(backbone_params_from_numpy(_np(jt), cfg, device="cpu"))
        for i, (r, g) in enumerate(zip(ref, tree_leaves(tt))):
            np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-6, rtol=1e-5,
                                       err_msg=f"{name} leaf {i}")
