"""The port's LM training path on the CPU against the JAX package: the
plain versions of the flash-attention and RMSNorm backward (what the
autograd Functions' kernels compute on the card) against ``jax.grad`` of
the jnp functions, ``chunked_cross_entropy``, ``forward_loss`` /
``forward_hidden`` and every gradient leaf of the reduced qwen2-0.5b and
llama3.2-1b with the JAX weights bridged over, one ``make_train_step``
step, and the token data; within the port, remat on and off bitwise, and
the two Functions driven by plain-torch emulations of their kernels' tile
walks against autograd of the plain versions.

Tolerances, each with its reason:
- values at 1e-5: fp32 sums run in another order;
- gradients at 1e-5 of the largest |gradient| of the leaf (``grad_close``):
  the same sums, differentiated;
- the emulated kernels against autograd at 1e-5 of scale: the kernels'
  recompute from the log-sum-exp and their per-tile sums round
  differently from the online softmax's autograd;
- a train step's new params at 1e-6 + 1e-5 of the update's scale: the
  gradients' rounding times lr;
- token batches and ignored-label counts exactly.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import InputShape as JaxShape  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.data.synthetic import SyntheticTokens as JaxTokens  # noqa: E402
from repro.data.synthetic import TokenDatasetSpec as JaxTokenSpec  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import backbone as jbb  # noqa: E402
from repro.nn.attention import flash_attention as jax_flash  # noqa: E402
from repro.nn.norm import rmsnorm_apply as jax_rmsnorm  # noqa: E402
from repro_torch import tree_leaves, tree_map, value_and_grad  # noqa: E402
from repro_torch.bridge import backbone_params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.configs.shapes import SHAPES, TRAIN_4K  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.data.synthetic import SyntheticTokens, TokenDatasetSpec  # noqa: E402
from repro_torch.kernels.attention.ops import FlashAttention  # noqa: E402
from repro_torch.kernels.attention.ref import (  # noqa: E402
    flash_attention_backward_ref,
    flash_attention_ref,
)
from repro_torch.kernels.rmsnorm.kernel import BACKWARD_BLOCKS  # noqa: E402
from repro_torch.kernels.rmsnorm.ops import RMSNorm  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_backward_ref, rmsnorm_ref  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import backbone as tbb  # noqa: E402
from repro_torch.nn.module import param_count  # noqa: E402

TOL = 1e-5
GRAD_TOL = 1e-5
KEY = jax.random.PRNGKey(0)
ARCHS = ["qwen2-0.5b", "llama3.2-1b"]
B, T, CHUNK = 2, 24, 16          # the last CE chunk holds 8 positions


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.RandomState(seed).standard_normal(shape)).astype(np.float32)


def close(jax_out, torch_out, tol=TOL):
    np.testing.assert_allclose(torch_out.detach().numpy(), np.asarray(jax_out),
                               atol=tol, rtol=tol)


def grad_close(ref, got, tol=GRAD_TOL, what=""):
    ref = np.asarray(ref, np.float64)
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert got.shape == ref.shape, what
    assert err <= tol * scale, f"{what}: max |err| {err:.3e} > {tol} x {scale:.3e}"


# ------------------------------------------------------------------ data ---
def test_token_batches_equal_jax():
    spec = dict(vocab=97, seq_len=17, n_modes=3, seed=5)
    jd, td = JaxTokens(JaxTokenSpec(**spec)), SyntheticTokens(TokenDatasetSpec(**spec))
    a, b = jd.batch(4, seed=9), td.batch(4, seed=9)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    jb, tb = jpipe.token_batch_fn(jd, 3, seed_base=2)(4), tpipe.token_batch_fn(td, 3, seed_base=2)(4)
    assert sorted(jb) == sorted(tb) == ["labels", "tokens"]
    for k in jb:
        assert jb[k].dtype == tb[k].dtype and jb[k].tobytes() == tb[k].tobytes()


def test_shapes_and_microbatches_match_jax():
    from repro.configs.shapes import SHAPES as JSHAPES
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JSHAPES.items()}
    for arch in ["qwen2-0.5b", "qwen2-1.5b", "llama3.2-1b"]:
        for shape in JSHAPES.values():
            assert tsteps.n_microbatches(get_config(arch), SHAPES[shape.name]) == \
                jsteps.n_microbatches(jax_get_config(arch), shape)


# ------------------------------------------------- the two plain backwards --
FLASH_CASES = [(48, True, 0), (48, True, 16), (130, True, 0), (130, True, 16),
               (48, False, 0), (130, False, 0)]


@pytest.mark.parametrize("T_,causal,window", FLASH_CASES)
def test_plain_flash_backward_matches_jax_grad(T_, causal, window):
    q, k, v = (_normal((2, T_, h, 64), s) for s, h in ((0, 4), (1, 2), (2, 2)))
    do = _normal((2, T_, 4, 64), 3)

    # several KV blocks under causal masking; one block of S keys otherwise,
    # since the jnp function leaks mass to its padded keys when not causal
    # (ROADMAP Queue 3, reference side)
    blocks = dict(q_block=32, kv_block=32) if causal else {}

    def jloss(q, k, v):
        o = jax_flash(q, k, v, causal=causal, window=window, **blocks)
        return jnp.sum(o * do)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_attention_ref(tq, tk, tv, causal=causal, window=window,
                                 return_lse=True)
    got = flash_attention_backward_ref(tq, tk, tv, o, tdo, lse, causal=causal,
                                       window=window)
    for name, r, g in zip("qkv", ref, got):
        grad_close(r, g, what=f"d{name}")


def test_plain_rmsnorm_backward_matches_jax_grad():
    x, scale, g = _normal((7, 96), 0, 3.0), 1 + _normal((96,), 1, 0.1), _normal((7, 96), 2)
    ref = jax.grad(lambda x, s: jnp.sum(jax_rmsnorm({"scale": s}, x) * g),
                   argnums=(0, 1))(x, scale)
    got = rmsnorm_backward_ref(*map(torch.from_numpy, (x, scale, g)))
    grad_close(ref[0], got[0], what="dx")
    grad_close(ref[1], got[1], what="dscale")


# ------------------------------------------ the Functions, emulated kernels --
def _flash_forward_emulated(q, k, v, *, causal, window):
    return flash_attention_ref(q, k, v, causal=causal, window=window,
                               return_lse=True)


def _flash_backward_emulated(q, k, v, o, do, lse, *, causal, window, BQ=16, BK=32):
    """The backward kernels' tile walk (csrc/flash_attention_backward.cu):
    dvec = rowsum(dO * O); per (KV tile, kv head) the q tiles that see it,
    for each of the G query heads, P recomputed from the log-sum-exp and
    dK / dV summed over the group; per (q tile, q head) the KV tiles it
    sees, dQ summed over them."""
    Bn, Tn, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G, scale = Hq // Hkv, D ** -0.5
    dvec = (do * o).sum(-1).permute(0, 2, 1)                 # (B, Hq, T)
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)

    def tile(q0, kb, b, hq):
        qp = torch.arange(q0, min(q0 + BQ, Tn))[:, None]
        kp = torch.arange(kb, min(kb + BK, S))[None, :]
        live = (kp <= qp) if causal else torch.ones_like(qp * kp, dtype=torch.bool)
        if window > 0:
            live = live & (kp > qp - window)
        Q, dO = q[b, qp[:, 0], hq], do[b, qp[:, 0], hq]
        K, V = k[b, kp[0], hq // G], v[b, kp[0], hq // G]
        p = torch.where(live, torch.exp(Q @ K.T * scale - lse[b, hq, qp[:, 0]][:, None]), 0.0)
        ds = p * (dO @ V.T - dvec[b, hq, qp[:, 0]][:, None])
        return Q, dO, K, p, ds

    for b in range(Bn):
        for hk in range(Hkv):
            for kb in range(0, S, BK):
                n_k = min(BK, S - kb)
                q_lo = kb if causal else 0
                q_hi = min(Tn, kb + n_k - 1 + window) if window > 0 else Tn
                acc_k, acc_v = torch.zeros(n_k, D), torch.zeros(n_k, D)
                for hq in range(hk * G, hk * G + G):
                    for q0 in range(q_lo // BQ * BQ, q_hi, BQ):
                        Q, dO, _, p, ds = tile(q0, kb, b, hq)
                        acc_v += p.T @ dO
                        acc_k += ds.T @ Q
                dk[b, kb:kb + n_k, hk], dv[b, kb:kb + n_k, hk] = acc_k * scale, acc_v
        for hq in range(Hq):
            for q0 in range(0, Tn, BQ):
                n_q = min(BQ, Tn - q0)
                k_end = min(S, q0 + n_q) if causal else S
                k_begin = max(0, q0 - window + 1) if window > 0 else 0
                acc = torch.zeros(n_q, D)
                for kb in range(k_begin // BK * BK, k_end, BK):
                    _, _, K, _, ds = tile(q0, kb, b, hq)
                    acc += ds @ K
                dq[b, q0:q0 + n_q, hq] = acc * scale
    return dq, dk, dv


def _rmsnorm_backward_emulated(x, scale, g, *, eps, blocks=3):
    """The backward kernel's walk (csrc/rmsnorm_backward.cu): rows dealt
    to ``blocks`` blocks grid-stride, each block's dscale row summed row by
    row, then the block rows summed in block order."""
    N, d = x.shape
    grid = min(N, blocks)
    partial = torch.zeros(grid, d)
    dx = torch.empty_like(x)
    for row in range(N):
        xr, gr = x[row], g[row]
        r = torch.rsqrt(torch.sum(xr * xr) / d + eps)
        c = r * r * r * (torch.sum(xr * scale * gr) / d)
        dx[row] = r * (scale * gr) - xr * c
        partial[row % grid] += gr * (xr * r)
    dscale = torch.zeros(d)
    for b in range(grid):
        dscale = dscale + partial[b]
    return dx, dscale


@pytest.mark.parametrize("T_,S_,causal,window", [(40, 40, True, 0), (37, 37, True, 9),
                                                 (21, 45, False, 0), (45, 21, False, 7)])
def test_flash_function_with_emulated_kernels_matches_autograd(T_, S_, causal, window):
    q = torch.from_numpy(_normal((2, T_, 6, 64), 0)).requires_grad_()
    k = torch.from_numpy(_normal((2, S_, 2, 64), 1)).requires_grad_()
    v = torch.from_numpy(_normal((2, S_, 2, 64), 2)).requires_grad_()
    w = torch.from_numpy(_normal((2, T_, 6, 64), 3))
    out = FlashAttention.apply(q, k, v, causal, window, _flash_forward_emulated,
                               _flash_backward_emulated)
    got = torch.autograd.grad((out * w).sum(), (q, k, v))
    ref_out = flash_attention_ref(q, k, v, causal=causal, window=window)
    ref = torch.autograd.grad((ref_out * w).sum(), (q, k, v))
    assert torch.equal(out, ref_out)
    for name, r, g in zip("qkv", ref, got):
        grad_close(r, g, what=f"d{name}")


def test_rmsnorm_function_with_emulated_kernel_matches_autograd():
    x = torch.from_numpy(_normal((11, 96), 0, 3.0)).requires_grad_()
    s = torch.from_numpy(1 + _normal((96,), 1, 0.1)).requires_grad_()
    w = torch.from_numpy(_normal((11, 96), 2))
    y = RMSNorm.apply(x, s, 1e-6, rmsnorm_ref, _rmsnorm_backward_emulated)
    got = torch.autograd.grad((y * w).sum(), (x, s))
    ref = torch.autograd.grad((rmsnorm_ref(x, s) * w).sum(), (x, s))
    assert BACKWARD_BLOCKS >= 1
    for name, r, g in zip(("dx", "dscale"), ref, got):
        grad_close(r, g, what=name)


# ----------------------------------------------------- the training path --
@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """JAX's reduced config, params, a labelled batch (ignored labels in
    it) and ``jax.value_and_grad`` of forward_loss, compiled once; the same
    params bridged into the port."""
    jcfg = jax_get_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    jp = jbb.init_params(jcfg, KEY)
    rng = np.random.RandomState(7)
    tokens = rng.randint(0, jcfg.vocab, (B, T)).astype(np.int32)
    labels = rng.randint(0, jcfg.vocab, (B, T)).astype(np.int32)
    labels[0, 3] = labels[1, 20] = -100
    batch = {"tokens": tokens, "labels": labels}
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jbb.forward_loss(jcfg, p, batch, loss_chunk=CHUNK),
        has_aux=True))(jp)
    jhidden = jbb.forward_hidden(jcfg, jp, {"tokens": tokens})
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, params=backbone_params_from_numpy(
        _np(jp), cfg, device="cpu"), batch=batch, jloss=jloss,
        jmetrics=jmetrics, jgrads=jgrads, jhidden=jhidden)


def _port_leaves_like_jax(cfg, jtree):
    """The JAX gradient tree in the port's layout (layers unstacked)."""
    return tree_leaves(backbone_params_from_numpy(_np(jtree), cfg, device="cpu"))


def test_forward_loss_and_every_grad_leaf_match_jax(arch):
    cfg = arch["cfg"]
    (loss, metrics), grads = value_and_grad(
        lambda p: tbb.forward_loss(cfg, p, arch["batch"], loss_chunk=CHUNK),
        arch["params"])
    close(arch["jloss"], loss)
    assert sorted(metrics) == sorted(arch["jmetrics"])
    for key in metrics:
        close(arch["jmetrics"][key], metrics[key])
    got, ref = tree_leaves(grads), _port_leaves_like_jax(cfg, arch["jgrads"])
    assert len(got) == len(ref) == len(tree_leaves(arch["params"]))
    for i, (r, g) in enumerate(zip(ref, got)):
        assert torch.isfinite(g).all() and g.abs().max() > 0, f"leaf {i}"
        grad_close(r.numpy(), g, what=f"leaf {i}")


def test_forward_hidden_matches_jax(arch):
    close(arch["jhidden"], tbb.forward_hidden(arch["cfg"], arch["params"],
                                              {"tokens": arch["batch"]["tokens"]}))


def test_remat_on_and_off_bitwise(arch):
    cfg, params = arch["cfg"], arch["params"]
    runs = [value_and_grad(lambda p: tbb.forward_loss(
        cfg, p, arch["batch"], loss_chunk=CHUNK, remat=r), params) for r in (True, False)]
    (l_on, _), g_on = runs[0]
    (l_off, _), g_off = runs[1]
    assert torch.equal(l_on, l_off)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g_on), tree_leaves(g_off)))


@pytest.mark.parametrize("chunk", [5, 16, 24, 64])
def test_chunked_cross_entropy_matches_jax(chunk):
    x, w = _normal((B, T, 32), 0), _normal((32, 50), 1, 0.3)
    labels = np.random.RandomState(2).randint(0, 50, (B, T)).astype(np.int32)
    labels[:, ::5] = -100
    jval, jg = jax.value_and_grad(lambda x, w: jbb.chunked_cross_entropy(
        x, w, labels, chunk=chunk), argnums=(0, 1))(x, w)
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    val = tbb.chunked_cross_entropy(tx, tw, torch.from_numpy(labels), chunk=chunk)
    close(jval, val)
    for r, g in zip(jg, torch.autograd.grad(val, (tx, tw))):
        grad_close(r, g)
    every = np.full((B, T), -100, np.int32)
    assert tbb.chunked_cross_entropy(tx, tw, torch.from_numpy(every)).item() == 0.0


@pytest.mark.parametrize("arch", ["qwen2-0.5b"], indirect=True)   # arch-independent
@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_matches_jax(arch, n_micro):
    jcfg, cfg = arch["jcfg"], arch["cfg"]
    jshape, shape = JaxShape("t", T, B, "train"), InputShape("t", T, B, "train")
    kw = dict(lr=0.05, momentum=0.9, weight_decay=0.01, n_micro_override=n_micro)
    # JAX's own forward_loss chunks at 512: one ragged chunk at this T
    jstep = jax.jit(jsteps.make_train_step(jcfg, jshape, **kw))
    jmom = jax.tree_util.tree_map(lambda p: 0.1 * jnp.ones_like(p), arch["jp"])
    jp, jopt, jm = jstep(arch["jp"], {"momentum": jmom}, arch["batch"])
    step = tsteps.make_train_step(cfg, shape, **kw)
    opt = {"momentum": tree_map(lambda p: 0.1 * torch.ones_like(p), arch["params"])}
    p, opt, m = step(arch["params"], opt, arch["batch"])
    close(jm["loss"], m["loss"])
    for name, jt, tt in (("params", jp, p), ("momentum", jopt["momentum"], opt["momentum"])):
        ref = _port_leaves_like_jax(cfg, jt)
        for i, (r, g) in enumerate(zip(ref, tree_leaves(tt))):
            np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-6, rtol=1e-5,
                                       err_msg=f"{name} leaf {i}")


def test_train_step_bf16_grads_and_opt_init():
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(), n_layers=1)
    params = tbb.init_params(cfg, 0, device="cpu")
    opt = tsteps.opt_init(params)
    assert all(float(m.abs().max()) == 0 for m in tree_leaves(opt["momentum"]))
    toks = np.random.RandomState(0).randint(0, cfg.vocab, (2, 9))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    shape = InputShape("t", 8, 2, "train")
    p1, o1, _ = tsteps.make_train_step(cfg, shape, bf16_grads=True)(params, opt, batch)
    p2, o2, _ = tsteps.make_train_step(cfg, shape)(params, opt, batch)
    # the momentum is the gradient: bfloat16-rounded on the first step
    for a, b in zip(tree_leaves(o1["momentum"]), tree_leaves(o2["momentum"])):
        assert torch.equal(a, b.to(torch.bfloat16).float())
    assert param_count(params) == sum(t.numel() for t in tree_leaves(params))
    assert tsteps.n_microbatches(cfg, TRAIN_4K) == 1


def test_backbone_refuses_extras_and_other_families():
    cfg = get_config("qwen2-0.5b").reduced()
    params = tbb.init_params(cfg, 0, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        tbb.forward_loss(cfg, params, {"tokens": np.zeros((1, 4), np.int32),
                                       "labels": np.zeros((1, 4), np.int32),
                                       "patches": np.zeros((1, 2, 8), np.float32)})
    from repro_torch.configs.base import MoESpec
    moe = dataclasses.replace(cfg, moe=MoESpec(n_experts=4, top_k=2, expert_d_ff=64))
    with pytest.raises(NotImplementedError, match="dense archs only"):
        tbb.forward_hidden(moe, params, {"tokens": np.zeros((1, 4), np.int32)})
