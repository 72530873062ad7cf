"""The port's dense LLM backbone on the CPU against the JAX package: RoPE,
SwiGLU and the attention layers at 1e-5, ``prefill`` and ``decode_step``
of the reduced qwen2-0.5b and llama3.2-1b at 1e-4 (two layers of fp32
sums in another order feed a 512-wide readout), all on the same seeded
inputs with the JAX weights bridged over; and, within the port,
teacher-forced decoding against prefill."""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import backbone as jbb  # noqa: E402
from repro.nn import activations as jact  # noqa: E402
from repro.nn import attention as jattn  # noqa: E402
from repro.nn import linear as jlin  # noqa: E402
from repro.nn.rope import apply_rope as jax_apply_rope  # noqa: E402
from repro_torch.bridge import backbone_params_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import HybridSpec  # noqa: E402
from repro_torch.models import backbone as tbb  # noqa: E402
from repro_torch.nn import activations as tact  # noqa: E402
from repro_torch.nn import attention as tattn  # noqa: E402
from repro_torch.nn import linear as tlin  # noqa: E402
from repro_torch.nn.rope import apply_rope  # noqa: E402

MODULE_TOL = 1e-5
SLICE_TOL = 1e-4
KEY = jax.random.PRNGKey(0)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def close(jax_out, torch_out, tol):
    np.testing.assert_allclose(torch_out.numpy(), np.asarray(jax_out),
                               atol=tol, rtol=tol)


def _normal(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def test_rope_matches_jax():
    x = _normal((2, 9, 3, 64), 0)
    pos = np.random.RandomState(1).randint(0, 600, (2, 9))
    close(jax_apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6),
          apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
          MODULE_TOL)


def test_embedding_and_tied_readout_match_jax():
    p = jlin.embedding_init(KEY, 512, 96)
    pt = params_from_numpy(to_np(p), device="cpu")
    ids = np.random.RandomState(3).randint(0, 512, (2, 7))
    x = _normal((2, 7, 96), 4)
    close(jlin.embedding_apply(p, jnp.asarray(ids)),
          tlin.embedding(pt, torch.from_numpy(ids)), 0.0)
    close(jlin.embedding_attend(p, jnp.asarray(x)),
          tlin.embedding_attend(pt, torch.from_numpy(x)), MODULE_TOL)


def test_swiglu_matches_jax():
    p = jact.swiglu_ffn_init(KEY, 96, 160)
    x = _normal((2, 5, 96), 2)
    close(jact.swiglu_ffn_apply(p, jnp.asarray(x)),
          tact.swiglu_ffn(params_from_numpy(to_np(p), device="cpu"),
                          torch.from_numpy(x)), MODULE_TOL)


ATTN = dict(n_heads=4, n_kv_heads=2, head_dim=64)


def _attn_params(bias=True):
    p = jattn.attention_init(KEY, 128, 4, 2, 64, qkv_bias=bias)
    return p, params_from_numpy(to_np(p), device="cpu")


@pytest.mark.parametrize("window", [0, 5])
def test_attention_apply_matches_jax(window):
    pj, pt = _attn_params()
    x = _normal((2, 11, 128), 3)
    valid = np.array([11, 6], np.int32)
    yj, kj, vj = jattn.attention_apply(
        pj, jnp.asarray(x), window=window, rope_theta=1e6, return_kv=True,
        kv_valid_len=jnp.asarray(valid), **ATTN)
    yt, kt, vt = tattn.attention_apply(
        pt, torch.from_numpy(x), window=window, rope_theta=1e6,
        return_kv=True, kv_valid_len=torch.from_numpy(valid), **ATTN)
    for a, b in ((yj, yt), (kj, kt), (vj, vt)):
        close(a, b, MODULE_TOL)


@pytest.mark.parametrize("cache_len", [3, 9, 21, "rows"])
def test_attention_decode_apply_matches_jax(cache_len):
    """Scalar depths below and past the ring's 8 slots (the write wraps to
    cache_len % 8), and per-row depths."""
    pj, pt = _attn_params()
    B, S = 3, 8
    x = _normal((B, 1, 128), 4)
    kc, vc = _normal((B, S, 2, 64), 5), _normal((B, S, 2, 64), 6)
    cl = np.array([2, 7, 12], np.int32) if cache_len == "rows" else cache_len
    oj, kj, vj = jattn.attention_decode_apply(
        pj, jnp.asarray(x), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(cl),
        rope_theta=1e6, **ATTN)
    kt_in, vt_in = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    ot, kt, vt = tattn.attention_decode_apply(
        pt, torch.from_numpy(x), kt_in, vt_in,
        torch.from_numpy(cl) if cache_len == "rows" else cl,
        rope_theta=1e6, **ATTN)
    assert kt is kt_in and vt is vt_in            # written in place
    close(oj, ot, MODULE_TOL)
    close(kj, kt, MODULE_TOL)
    close(vj, vt, MODULE_TOL)


def _models(arch):
    jcfg = jax_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jp = jbb.init_params(jcfg, KEY)
    tp = backbone_params_from_numpy(to_np(jp), cfg, device="cpu")
    return jcfg, cfg, jp, tp


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "llama3.2-1b"])
def test_prefill_and_decode_match_jax(arch):
    jcfg, cfg, jp, tp = _models(arch)
    assert cfg.n_layers == 2 and cfg.d_model == 256 and cfg.vocab == 512
    B, T, max_len = 2, 13, 40
    toks = np.random.RandomState(7).randint(0, cfg.vocab, (B, T))
    lj, cj, Tj = jbb.prefill(jcfg, jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                             max_len=max_len)
    lt, ct, Tt = tbb.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)},
                             max_len=max_len)
    assert Tt == int(Tj) == T
    close(lj, lt, SLICE_TOL)
    for name in ("k", "v"):                 # JAX: (n_sb, 1, B, S, Hkv, D)
        assert ct[name].shape == (2, B, max_len, 2, 64)
        close(np.asarray(cj[name])[:, 0], ct[name], SLICE_TOL)
    nxt = np.array(jnp.argmax(lj, -1))[:, None]
    for step in range(2):
        lj, cj = jbb.decode_step(jcfg, jp, jnp.asarray(nxt, jnp.int32), cj,
                                 T + step)
        lt, ct = tbb.decode_step(cfg, tp, torch.from_numpy(nxt), ct, T + step)
        close(lj, lt, SLICE_TOL)
        nxt = np.array(jnp.argmax(lj, -1))[:, None]


def test_padded_prefill_matches_jax():
    jcfg, cfg, jp, tp = _models("qwen2-0.5b")
    toks = np.random.RandomState(8).randint(0, cfg.vocab, (3, 12))
    lengths = np.array([12, 5, 9], np.int32)
    lj, _, _ = jbb.prefill(jcfg, jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                           max_len=32, lengths=jnp.asarray(lengths))
    lt, _, _ = tbb.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)},
                           max_len=32, lengths=torch.from_numpy(lengths))
    close(lj, lt, SLICE_TOL)


def test_teacher_forced_decode_equals_prefill():
    """Decoding a prompt's tail token by token gives the logits of a
    prefill of the whole prompt, within the port."""
    cfg = get_config("qwen2-0.5b").reduced()
    params = tbb.init_params(cfg, seed=3, device="cpu")
    toks = torch.from_numpy(np.random.RandomState(9).randint(0, cfg.vocab, (2, 14)))
    _, cache, T = tbb.prefill(cfg, params, {"tokens": toks[:, :10]}, max_len=32)
    for t in range(10, 14):
        logits, cache = tbb.decode_step(cfg, params, toks[:, t:t + 1], cache, t)
        full, _, _ = tbb.prefill(cfg, params, {"tokens": toks[:, :t + 1]},
                                 max_len=32)
        torch.testing.assert_close(logits, full, atol=MODULE_TOL, rtol=MODULE_TOL)


def test_unported_archs_raise():
    """Once refused, the hybrid branch now runs: reduced qwen2 with a
    2-layer Mamba hybrid superblock (attention, then a Mamba block, dense
    FFNs) inits to the tree of JAX's init, and its prefill logits and
    every cache entry on those weights match JAX's within SLICE_TOL (K/V
    in the port's (L, B, S, H, D) shape)."""
    from repro.configs.base import HybridSpec as JaxHybridSpec
    from repro_torch.bridge import backbone_params_to_numpy

    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                              hybrid=HybridSpec(period=2))
    jcfg = dataclasses.replace(jax_get_config("qwen2-0.5b").reduced(),
                               hybrid=JaxHybridSpec(period=2))
    params = tbb.init_params(cfg, device="cpu")
    assert [s["kind"] for s in tbb.sublayer_specs(cfg)] == ["attn", "mamba"]
    tree = backbone_params_to_numpy(params, cfg)
    shapes = jax.eval_shape(lambda: jbb.init_params(jcfg, KEY))
    assert ([(jax.tree_util.keystr(k), v.shape) for k, v in
             jax.tree_util.tree_leaves_with_path(tree)]
            == [(jax.tree_util.keystr(k), v.shape) for k, v in
                jax.tree_util.tree_leaves_with_path(shapes)])
    toks = np.random.RandomState(3).randint(0, cfg.vocab, (2, 9)).astype(np.int32)
    jl, jc, _ = jbb.prefill(jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                            {"tokens": jnp.asarray(toks)}, max_len=16)
    tl, tc, _ = tbb.prefill(cfg, params, {"tokens": torch.from_numpy(toks)}, max_len=16)
    close(jl, tl, SLICE_TOL)
    assert sorted(tc) == sorted(jc) == ["k", "mamba_conv", "mamba_ssm", "v"]
    for k in jc:
        close(np.asarray(jc[k]).reshape(tc[k].shape), tc[k], SLICE_TOL)
