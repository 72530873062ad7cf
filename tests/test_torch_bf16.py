"""bf16 in the port on the CPU: the plain bf16 flash attention, RMSNorm and
decode attention (what the kernels' bf16 halves are held against on the
card) against the JAX package's Pallas kernels in interpret mode (flash,
RMSNorm) and its dense decode oracle (the Pallas decode kernel does not
run under this JAX); the bf16 flash kernel's arithmetic (P rounded to
bf16 per 64-key tile) emulated against the same Pallas flash kernel;
parameters drawn in a config's dtype; the backward
kernels refusing bf16; and a reduced moonshot-v1-16b-a3b in bfloat16 on
both sides.

Tolerances, each with its reason:
- kernels at the JAX package's own bf16 bars (``tests/test_kernels.py``,
  ``tests/test_decode_attention.py``): 3e-2 for flash and decode, 2e-2
  for RMSNorm; each output rounds to bf16 (3.9e-3 relative) and the two
  sides widen, sum and round in their own orders;
- bf16 moonshot logits at 3e-2 of the largest |logit|.  Measured on the
  CPU over seeds 0-2 (prefill and 8 decode steps each): the port's bf16
  logits sit 0.77-1.34e-2 of scale from JAX's bf16 logits, and each
  side's sit 0.77-1.12e-2 from the same weights run in float32 (JAX
  1.12e-2 at most, the port 1.02e-2): the two frameworks round bf16
  intermediates (the SwiGLU products, the residual adds, the bf16 GEMM
  outputs) at different places, a few bf16 ulps through 2 layers.
- init: bitwise (the same float32 draws, cast).
"""
import dataclasses
import math

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.attention.ops import flash_attention_op as jax_flash_op  # noqa: E402
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_decode_ref  # noqa: E402
from repro.kernels.rmsnorm.ops import rmsnorm_op as jax_rmsnorm_op  # noqa: E402
from repro.models import backbone as jbb  # noqa: E402
from repro_torch import tree_leaves  # noqa: E402
from repro_torch.bridge import backbone_params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.attention.kernel import flash_attention_backward_cuda  # noqa: E402
from repro_torch.kernels.attention.ops import flash_attention_op  # noqa: E402
from repro_torch.kernels.decode_attention.ops import decode_attention_op  # noqa: E402
from repro_torch.kernels.rmsnorm.kernel import rmsnorm_backward_cuda  # noqa: E402
from repro_torch.kernels.rmsnorm.ops import rmsnorm_op  # noqa: E402
from repro_torch.models import backbone as tbb  # noqa: E402

BF16 = torch.bfloat16
ATTN_TOL, NORM_TOL, LOGIT_TOL = 3e-2, 2e-2, 3e-2


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.RandomState(seed).standard_normal(shape)).astype(np.float32)


def _both(a):
    """The same bf16 values on both sides (each rounds to nearest even)."""
    return jnp.asarray(a).astype(jnp.bfloat16), torch.as_tensor(a).to(BF16)


def _close(got, ref, tol):
    assert got.dtype == BF16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=tol, rtol=tol)


# the JAX package's bf16 shape, one off its blocks, and moonshot's heads
# (G = 1, D = 128) at a small length
@pytest.mark.parametrize("B,T,Hq,Hkv,D,window", [(1, 128, 4, 2, 64, 0), (2, 100, 4, 1, 64, 32),
                                                 (1, 64, 4, 4, 128, 0)])
def test_plain_bf16_flash_matches_jax_pallas(B, T, Hq, Hkv, D, window):
    qj, qt = _both(_normal((B, T, Hq, D), 1))
    kj, kt = _both(_normal((B, T, Hkv, D), 2))
    vj, vt = _both(_normal((B, T, Hkv, D), 3))
    ref = jax_flash_op(qj, kj, vj, causal=True, window=window, interpret=True)
    assert ref.dtype == jnp.bfloat16
    _close(flash_attention_op(qt, kt, vt, causal=True, window=window), ref, ATTN_TOL)


def _flash_p_bf16(q, k, v, *, causal=True, window=0, tile=64):
    """The bf16 flash kernel's numerics (csrc/flash_attention_bf16.cu) in
    plain torch: scores of the widened bf16 inputs in float32 (each product
    exact), an online softmax in the log2 domain over 64-key tiles, P
    rounded to bf16 before P.V and the row sum l taken over the unrounded
    P, the output divided by max(l, 1e-20) and rounded to bf16."""
    B, T, Hq, D = q.shape
    S, G = k.shape[1], Hq // k.shape[2]
    qf = q.float()
    kf, vf = (t.float().repeat_interleave(G, 2) for t in (k, v))
    sl2 = math.log2(math.e) / math.sqrt(D)
    qp = torch.arange(T)[:, None]
    m = torch.full((B, Hq, T), -math.inf)
    l = torch.zeros(B, Hq, T)
    acc = torch.zeros(B, Hq, T, D)
    for kb in range(0, S, tile):
        kp = torch.arange(kb, min(kb + tile, S))[None, :]
        live = torch.ones(T, kp.shape[1], dtype=torch.bool)
        if causal:
            live &= kp <= qp
        if window > 0:
            live &= kp > qp - window
        s = torch.einsum("bthd,bshd->bhts", qf, kf[:, kb:kb + tile])
        s = torch.where(live, s, -math.inf)
        m_new = torch.maximum(m, s.amax(-1) * sl2)
        nm = torch.where(torch.isinf(m_new), 0.0, -m_new)
        corr = torch.exp2(m + nm)
        p = torch.exp2(s * sl2 + nm[..., None])
        l = corr * l + p.sum(-1)
        pv = torch.einsum("bhts,bshd->bhtd", p.to(BF16).float(), vf[:, kb:kb + tile])
        acc = acc * corr[..., None] + pv
        m = m_new
    return (acc / l.clamp(min=1e-20)[..., None]).transpose(1, 2).to(BF16)


@pytest.mark.parametrize("B,T,Hq,Hkv,D,window", [(1, 128, 4, 2, 64, 0), (2, 100, 4, 1, 64, 32),
                                                 (1, 64, 4, 4, 128, 0)])
def test_bf16_flash_p_rounding_matches_jax_pallas(B, T, Hq, Hkv, D, window):
    """The bf16 kernel rounds P to bf16 before P.V, where the TPU kernel
    keeps it in fp32: on the inputs of the test above, that arithmetic
    (``_flash_p_bf16``) stays within the JAX package's bf16 bar of its
    Pallas kernel in interpret mode.  Only the card runs the kernel."""
    qj, qt = _both(_normal((B, T, Hq, D), 1))
    kj, kt = _both(_normal((B, T, Hkv, D), 2))
    vj, vt = _both(_normal((B, T, Hkv, D), 3))
    ref = jax_flash_op(qj, kj, vj, causal=True, window=window, interpret=True)
    _close(_flash_p_bf16(qt, kt, vt, causal=True, window=window), ref, ATTN_TOL)


@pytest.mark.parametrize("shape", [(3, 5, 256), (2, 128), (1, 9, 384), (4, 2048)])
def test_plain_bf16_rmsnorm_matches_jax_pallas(shape):
    xj, xt = _both(_normal(shape, 4))
    sj, st = _both(1.0 + 0.1 * _normal(shape[-1:], 5))
    ref = jax_rmsnorm_op(xj, sj, interpret=True)
    assert ref.dtype == jnp.bfloat16
    _close(rmsnorm_op(xt, st), ref, NORM_TOL)


@pytest.mark.parametrize("B,S,Hq,Hkv,D,attend", [(2, 256, 4, 2, 64, [100, 256]),
                                                 (2, 64, 4, 4, 128, [64, 1]),
                                                 (3, 96, 8, 2, 64, 37)])
def test_plain_bf16_decode_matches_jax_ref(B, S, Hq, Hkv, D, attend):
    qj, qt = _both(_normal((B, 1, Hq, D), 6))
    kj, kt = _both(_normal((B, S, Hkv, D), 7))
    vj, vt = _both(_normal((B, S, Hkv, D), 8))
    ref = jax_decode_ref(qj, kj, vj, jnp.asarray(attend, jnp.int32))
    assert ref.dtype == jnp.bfloat16
    got = decode_attention_op(qt, kt, vt, torch.as_tensor(attend) if isinstance(
        attend, list) else attend)
    _close(got, ref, ATTN_TOL)


def test_backward_kernels_refuse_bf16():
    """The backward kernels take float32 only: a bf16 call names the
    ROADMAP item that ports their bf16 halves (before any device check)."""
    x = torch.zeros(4, 96, dtype=BF16)
    with pytest.raises(NotImplementedError, match=r"item 6\(d\)"):
        rmsnorm_backward_cuda(x, torch.ones(96, dtype=BF16), x)
    q, kv = torch.zeros(1, 4, 2, 64, dtype=BF16), torch.zeros(1, 4, 2, 64, dtype=BF16)
    with pytest.raises(NotImplementedError, match=r"item 6\(d\)"):
        flash_attention_backward_cuda(q, kv, kv, q, q, torch.zeros(1, 2, 4))


def test_init_draws_in_float32_then_casts():
    """A bf16 config's params are the float32 config's draws, rounded to
    bf16 leaf by leaf; every leaf in the config's dtype."""
    cfg32 = get_config("moonshot-v1-16b-a3b").reduced()
    cfg16 = dataclasses.replace(cfg32, param_dtype="bfloat16")
    p32 = tbb.init_params(cfg32, 3, device="cpu")
    p16 = tbb.init_params(cfg16, 3, device="cpu")
    a, b = tree_leaves(p32), tree_leaves(p16)
    assert len(a) == len(b) and all(t.dtype == BF16 for t in b)
    assert all(torch.equal(x.to(BF16), y) for x, y in zip(a, b))
    assert all(t.dtype == torch.float32 for t in a)


def test_bf16_moonshot_matches_jax():
    """Reduced moonshot-v1-16b-a3b with param_dtype bfloat16 on both sides
    (JAX's bf16 weights bridged as float32 arrays, cast back without
    loss): bf16 caches, float32 logits within LOGIT_TOL of scale at
    prefill and 4 decode steps, the same greedy tokens."""
    name = "moonshot-v1-16b-a3b"
    jcfg = dataclasses.replace(jax_get_config(name).reduced(), param_dtype="bfloat16")
    cfg = dataclasses.replace(get_config(name).reduced(), param_dtype="bfloat16")
    jp = jbb.init_params(jcfg, jax.random.PRNGKey(0))
    params = backbone_params_from_numpy(
        jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp), cfg, device="cpu")
    assert all(t.dtype == BF16 for t in tree_leaves(params))
    toks = np.random.RandomState(0).randint(0, cfg.vocab, (2, 12)).astype(np.int32)
    jl, jc, _ = jbb.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, max_len=40)
    tl, tc, _ = tbb.prefill(cfg, params, {"tokens": torch.as_tensor(toks)}, max_len=40)
    assert tc["k"].dtype == BF16 and tl.dtype == torch.float32

    def close(j, t):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, atol=LOGIT_TOL * np.abs(j).max(), rtol=0)
        assert (t.numpy().argmax(-1) == j.argmax(-1)).all()

    close(jl, tl)
    step = jax.jit(lambda p, tok, c, n: jbb.decode_step(jcfg, p, tok, c, n))
    for i in range(4):
        tok = jnp.argmax(jl, -1)[:, None]
        jl, jc = step(jp, tok, jc, 12 + i)
        tl, tc = tbb.decode_step(cfg, params, torch.as_tensor(np.array(tok)), tc, 12 + i)
        close(jl, tl)
