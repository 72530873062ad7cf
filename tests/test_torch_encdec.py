"""The port's enc-dec backbone (whisper-tiny) on the CPU against the JAX
package, with the JAX weights of the reduced config bridged over and the
same seeded inputs: the sinusoidal position table, LayerNorm, the GELU
MLP, cross-attention, ``forward_loss`` with every gradient leaf,
``prefill`` with its self / cross cache and ``decode_step``, greedy
``ServeEngine.generate`` and a ``make_train_step`` step on frames; the
requests and calls the port refuses; and, past JAX's flash block, the
port's non-causal attention against ``reference_attention``.

Tolerances, each with its reason:
- the position table's frequencies bitwise (``exp_f32`` is XLA:CPU's
  float32 exp; ``torch.exp`` differs by one ulp in some, which 1,500
  positions scale to about 1e-4), the table at 1e-6: sin / cos round apart;
- modules, logits, caches at 1e-5: fp32 sums run in another order;
- gradients at 1e-5 of the largest |gradient| of the leaf;
- a train step's new params at 1e-6 + 1e-5 relative: the gradients'
  rounding times lr;
- greedy tokens exactly.
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
from repro.nn import activations as jact  # noqa: E402
from repro.nn import attention as jattn  # noqa: E402
from repro.nn import norm as jnorm  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch import tree_leaves, tree_map, value_and_grad  # noqa: E402
from repro_torch.bridge import backbone_params_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import backbone as tbb  # noqa: E402
from repro_torch.nn import activations as tact  # noqa: E402
from repro_torch.nn import attention as tattn  # noqa: E402
from repro_torch.nn import norm as tnorm  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

ARCH = "whisper-tiny"
TOL, GRAD_TOL, POS_TOL = 1e-5, 1e-5, 1e-6
KEY = jax.random.PRNGKey(0)
B, T, MAX_LEN = 2, 12, 40


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
    """JAX's reduced whisper-tiny (2 + 2 layers, d 256, 16 frames), its
    params bridged into the port, and a labelled batch with frames."""
    jcfg = jax_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    assert cfg.encdec.n_frames == 16 and cfg.encdec.n_encoder_layers == 2
    jp = jbb.init_params(jcfg, KEY)
    rng = np.random.RandomState(11)
    tokens = rng.randint(0, cfg.vocab, (B, T)).astype(np.int32)
    labels = rng.randint(0, cfg.vocab, (B, T)).astype(np.int32)
    labels[1, 4] = -100
    frames = _normal((B, cfg.encdec.n_frames, cfg.d_model), 12)
    return dict(jcfg=jcfg, cfg=cfg, jp=jp,
                params=backbone_params_from_numpy(_np(jp), cfg, device="cpu"),
                batch={"tokens": tokens, "labels": labels, "frames": frames})


# ------------------------------------------------------------- modules ---
@pytest.mark.parametrize("d", [256, 384, 1024])
def test_exp_f32_bitwise_jax(d):
    """The frequencies of a d-wide table, and a sweep of [-80, 80]."""
    for a in (np.arange(0, d, 2, dtype=np.float32) * np.float32(-np.log(10000.0) / d),
              np.linspace(-80, 80, 4001 + d, dtype=np.float32)):
        got = tbb.exp_f32(torch.from_numpy(a)).numpy()
        assert got.tobytes() == np.asarray(jnp.exp(jnp.asarray(a))).tobytes()


@pytest.mark.parametrize("T_pos,d,offset", [(1, 384, 0), (16, 384, 0), (64, 384, 0),
                                            (1500, 384, 0), (1, 384, 1400), (16, 256, 5)])
def test_sinusoidal_positions_match_jax(T_pos, d, offset):
    close(jbb.sinusoidal_positions(T_pos, d, offset=offset),
          tbb.sinusoidal_positions(T_pos, d, offset=offset), POS_TOL)


@pytest.mark.parametrize("module", ["layernorm", "mlp"])
def test_layernorm_and_mlp_match_jax(module):
    x = _normal((2, 7, 96), 1, 3.0)
    if module == "layernorm":
        p = {"scale": jnp.asarray(1 + _normal((96,), 2, 0.1)),
             "bias": jnp.asarray(_normal((96,), 3, 0.1))}
        ref, fn = jnorm.layernorm_apply(p, jnp.asarray(x)), tnorm.layernorm
        assert sorted(tnorm.layernorm_init(96)) == sorted(jnorm.layernorm_init(96))
    else:
        p = jact.mlp_init(KEY, 96, 160)
        p["fc1"]["b"] = jnp.asarray(_normal((160,), 4, 0.1))
        ref, fn = jact.mlp_apply(p, jnp.asarray(x)), tact.mlp
        shapes = tree_map(lambda t: tuple(t.shape), tact.mlp_init(torch.Generator(), 96, 160))
        assert shapes == jax.tree_util.tree_map(lambda a: tuple(a.shape), p)
    close(ref, fn(params_from_numpy(_np(p), device="cpu"), torch.from_numpy(x)))


@pytest.mark.parametrize("part", ["cross_kv", "apply", "decode"])
def test_cross_attention_matches_jax(part):
    H, D, F = 4, 64, 19
    p = jattn.attention_init(KEY, 128, H, H, D)
    pt = params_from_numpy(_np(p), device="cpu")
    enc = _normal((2, F, 128), 5)
    jk, jv = jattn.cross_kv(p, jnp.asarray(enc), n_kv_heads=H, head_dim=D)
    tk, tv = tattn.cross_kv(pt, torch.from_numpy(enc), n_kv_heads=H, head_dim=D)
    if part == "cross_kv":
        close(jk, tk)
        close(jv, tv)
        return
    Tq = 1 if part == "decode" else 9
    x = _normal((2, Tq, 128), 6)
    jfn, tfn = ((jattn.cross_attention_decode, tattn.cross_attention_decode)
                if part == "decode" else
                (jattn.cross_attention_apply, tattn.cross_attention_apply))
    close(jfn(p, jnp.asarray(x), jk, jv, n_heads=H, head_dim=D),
          tfn(pt, torch.from_numpy(x), tk, tv, n_heads=H, head_dim=D))


def test_noncausal_attention_past_jax_flash_block_matches_reference():
    """At S = 1,030 frames (past JAX's 1,024-key block and off it) the
    port's non-causal attention masks the block's pad; JAX's jnp flash
    leaks softmax mass to it, so the oracle is ``reference_attention``."""
    q, k, v = _normal((1, 1030, 2, 64), 7), _normal((1, 1030, 2, 64), 8), _normal((1, 1030, 2, 64), 9)
    ref = jattn.reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    causal=False)
    got = tattn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=False)
    close(ref, got)
    close(ref, tattn.reference_attention(torch.from_numpy(q), torch.from_numpy(k),
                                         torch.from_numpy(v), causal=False))
    leak = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 causal=False)
    assert float(jnp.abs(leak - ref).max()) > 1e-3      # the reference-side fault


# -------------------------------------------------------------- the model ---
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


def test_remat_on_and_off_bitwise(model):
    cfg = model["cfg"]
    runs = [value_and_grad(lambda p: tbb.forward_loss(cfg, p, model["batch"], remat=r),
                           model["params"]) for r in (True, False)]
    assert torch.equal(runs[0][0][0], runs[1][0][0])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(runs[0][1]),
                                                  tree_leaves(runs[1][1])))


def test_prefill_cache_and_decode_match_jax(model):
    cfg, jcfg = model["cfg"], model["jcfg"]
    batch = {k: model["batch"][k] for k in ("tokens", "frames")}
    lj, cj, Tj = jbb.prefill(jcfg, model["jp"], {k: jnp.asarray(v) for k, v in batch.items()},
                             max_len=MAX_LEN)
    lt, ct, Tt = tbb.prefill(cfg, model["params"],
                             {k: torch.from_numpy(v) for k, v in batch.items()},
                             max_len=MAX_LEN)
    assert Tt == int(Tj) == T
    close(lj, lt)
    zero = tbb.init_cache(cfg, B, MAX_LEN, device="cpu")
    assert sorted(ct) == sorted(cj) == sorted(zero) == ["ck", "cv", "k", "v"]
    for name in ct:
        assert ct[name].shape == zero[name].shape == jbb.init_cache(jcfg, B, MAX_LEN)[name].shape
        close(cj[name], ct[name])
    nxt = np.asarray(jnp.argmax(lj, -1))[:, None].astype(np.int32)
    for step in range(4):
        lj, cj = jbb.decode_step(jcfg, model["jp"], jnp.asarray(nxt), cj, T + step)
        lt, ct = tbb.decode_step(cfg, model["params"], torch.from_numpy(nxt).long(), ct,
                                 T + step)
        close(lj, lt)
        nxt = np.asarray(jnp.argmax(lj, -1))[:, None].astype(np.int32)
    for name in ct:
        close(cj[name], ct[name])


def _requests(cfg, n, req):
    rng = np.random.RandomState(13)
    return [req(tokens=rng.randint(0, cfg.vocab, 4), max_new_tokens=6,
                extras={"frames": _normal((cfg.encdec.n_frames, cfg.d_model), 20 + i)})
            for i in range(n)]


def test_greedy_generate_matches_jax_engine(model):
    cfg = model["cfg"]
    jouts = JaxServeEngine(model["jcfg"], model["jp"], max_len=MAX_LEN).generate(
        _requests(cfg, 3, JaxRequest))
    outs = ServeEngine(cfg, model["params"], max_len=MAX_LEN, device="cpu").generate(
        _requests(cfg, 3, Request))
    assert [c.tokens.tolist() for c in outs] == [c.tokens.tolist() for c in jouts]
    assert [c.steps for c in outs] == [c.steps for c in jouts] == [6, 6, 6]


@pytest.mark.parametrize("case", ["mismatched_extras", "per_row_cache_len", "padded_prefill",
                                  "no_frames"])
def test_refusals(model, case):
    cfg, params = model["cfg"], model["params"]
    with pytest.raises(ValueError):
        if case == "mismatched_extras":
            reqs = _requests(cfg, 2, Request)
            reqs[1].extras = None
            ServeEngine(cfg, params, max_len=MAX_LEN, device="cpu").generate(reqs)
        elif case == "per_row_cache_len":
            cache = tbb.init_cache(cfg, B, MAX_LEN, device="cpu")
            tbb.decode_step(cfg, params, torch.zeros((B, 1), dtype=torch.long), cache,
                            torch.tensor([3, 5]))
        elif case == "padded_prefill":
            tbb.prefill(cfg, params, {k: torch.from_numpy(model["batch"][k])
                                      for k in ("tokens", "frames")},
                        lengths=torch.tensor([T, 5]))
        else:
            tbb.forward_loss(cfg, params, {k: model["batch"][k] for k in ("tokens", "labels")})


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_with_frames_matches_jax(model, n_micro):
    """``make_train_step`` slices the frames into microbatches as it does
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
