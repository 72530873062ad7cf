"""bf16 in the port on the CPU: the plain bf16 flash attention, RMSNorm and
decode attention (what the kernels' bf16 halves are held against on the
card) against the JAX package's Pallas kernels in interpret mode (flash,
RMSNorm) and its dense decode oracle (the Pallas decode kernel does not
run under this JAX); the bf16 flash kernel's arithmetic (P rounded to
bf16 per 64-key tile) emulated against the same Pallas flash kernel;
the ``FlashAttention`` and ``RMSNorm`` autograd Functions driven by plain
emulations of the bf16 forward and backward kernels against JAX's
autodiff of its jnp ``flash_attention`` / ``rmsnorm_apply`` in bf16; the
backward wrappers' input checks; parameters drawn in a config's dtype;
and a reduced moonshot-v1-16b-a3b in bfloat16 on both sides.

Tolerances, each with its reason:
- kernels at the JAX package's own bf16 bars (``tests/test_kernels.py``,
  ``tests/test_decode_attention.py``): 3e-2 for flash and decode, 2e-2
  for RMSNorm; each output rounds to bf16 (3.9e-3 relative) and the two
  sides widen, sum and round in their own orders;
- gradients through the emulated kernels at the same bars, of the
  largest |gradient| of each: the flash backward rounds P and dS to bf16
  before its products (as SDPA's bf16 backward does), where JAX's
  autodiff keeps them in float32;
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
from repro.nn.attention import flash_attention as jax_flash  # noqa: E402
from repro.nn.norm import rmsnorm_apply as jax_rmsnorm  # noqa: E402
from repro_torch import tree_leaves  # noqa: E402
from repro_torch.bridge import backbone_params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.attention.kernel import flash_attention_backward_cuda  # noqa: E402
from repro_torch.kernels.attention.ops import FlashAttention, flash_attention_op  # noqa: E402
from repro_torch.kernels.attention.ref import (  # noqa: E402
    flash_attention_backward_bf16_emulated,
    flash_attention_backward_ref,
)
from repro_torch.kernels.decode_attention.ops import decode_attention_op  # noqa: E402
from repro_torch.kernels.rmsnorm.kernel import rmsnorm_backward_cuda  # noqa: E402
from repro_torch.kernels.rmsnorm.ops import RMSNorm, rmsnorm_op  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_backward_ref, rmsnorm_ref  # noqa: E402
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


def _flash_bf16_emulated(q, k, v, *, causal=True, window=0, q_offset=0,
                         kv_valid_len=None, tile=64):
    """The bf16 flash kernel's numerics (csrc/flash_attention_bf16.cu) in
    plain torch: scores of the widened bf16 inputs in float32 (each product
    exact), an online softmax in the log2 domain over 64-key tiles, P
    rounded to bf16 before P.V and the row sum l taken over the unrounded
    P, the output divided by max(l, 1e-20) and rounded to bf16; also each
    row's log-sum-exp as the kernel writes it, (B, Hq, T) float32, -inf on
    a row with no live key."""
    B, T, Hq, D = q.shape
    S, G = k.shape[1], Hq // k.shape[2]
    qf = q.float()
    kf, vf = (t.float().repeat_interleave(G, 2) for t in (k, v))
    sl2 = math.log2(math.e) / math.sqrt(D)
    qp = torch.arange(T)[:, None] + q_offset
    valid = torch.full((B,), S) if kv_valid_len is None else kv_valid_len.long()
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
        live = live[None, None] & (kp < valid[:, None, None, None])
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
    out = (acc / l.clamp(min=1e-20)[..., None]).transpose(1, 2).to(BF16)
    lse = torch.where(torch.isinf(m), -math.inf, m * math.log(2.0) + torch.log(l))
    return out, lse


def _flash_p_bf16(q, k, v, *, causal=True, window=0):
    """The output of ``_flash_bf16_emulated``."""
    return _flash_bf16_emulated(q, k, v, causal=causal, window=window)[0]


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


# (B, T, S, Hq, Hkv, D, causal, window, q_offset, kv_valid_len): D 64 / 128,
# G 1 / 7, a window, q_offset with T != S, kv_valid_len with a row at 0,
# not causal
FLASH_GRAD_CASES = [
    (1, 64, 64, 4, 4, 128, True, 0, 0, None),
    (2, 100, 100, 7, 1, 64, True, 32, 0, None),
    (2, 48, 80, 4, 2, 64, True, 0, 32, None),
    (3, 48, 48, 4, 2, 128, True, 0, 0, (48, 0, 29)),
    (2, 30, 60, 7, 1, 64, False, 9, 20, (60, 33)),
]


def _grad_close(got, ref, tol, what):
    """got (torch, bf16) within tol of the largest |ref| (JAX, bf16)."""
    assert got.dtype == BF16, what
    ref = np.asarray(ref.astype(jnp.float32), np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got.double().numpy() - ref).max())
    assert err <= tol * scale, f"{what}: max |err| {err:.3e} > {tol} x {scale:.3e}"


@pytest.mark.parametrize("B,T,S,Hq,Hkv,D,causal,window,q_offset,valid", FLASH_GRAD_CASES)
def test_bf16_flash_function_with_emulated_kernels_matches_jax_autodiff(
        B, T, S, Hq, Hkv, D, causal, window, q_offset, valid):
    """``FlashAttention`` on bf16 inputs with the bf16 kernels' arithmetic
    emulated (``_flash_bf16_emulated`` forward with its log-sum-exp,
    ``flash_attention_backward_bf16_emulated`` backward): the gradients of
    sum(out * w) within ATTN_TOL of JAX's autodiff of its jnp
    ``flash_attention`` in bf16, each bf16 as JAX's; a row with no live
    key gets dq = 0.  The emulated backward also within ATTN_TOL of the
    plain version's (autograd of the fp32-inside forward)."""
    (qj, qt), (kj, kt), (vj, vt) = (_both(_normal(sh, i)) for i, sh in enumerate(
        ((B, T, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)), 20))
    w = _normal((B, T, Hq, D), 23)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    jvalid = None if valid is None else jnp.asarray(valid, jnp.int32)
    tvalid = None if valid is None else torch.tensor(valid)

    def jloss(q, k, v):
        out = jax_flash(q, k, v, kv_valid_len=jvalid, **kw)
        return jnp.sum(out.astype(jnp.float32) * w)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(qj, kj, vj)
    q, k, v = (t.clone().requires_grad_() for t in (qt, kt, vt))
    out = FlashAttention.apply(q, k, v, causal, window, q_offset, tvalid,
                               _flash_bf16_emulated, flash_attention_backward_bf16_emulated)
    assert out.dtype == BF16
    got = torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(), (q, k, v))
    for name, g, r in zip("qkv", got, jgrads):
        assert r.dtype == jnp.bfloat16
        _grad_close(g, r, ATTN_TOL, f"d{name}")
    o, lse = _flash_bf16_emulated(qt, kt, vt, kv_valid_len=tvalid, **kw)
    do = (torch.from_numpy(w)).to(BF16)
    plain = flash_attention_backward_ref(qt, kt, vt, o, do, lse, kv_valid_len=tvalid, **kw)
    emul = flash_attention_backward_bf16_emulated(qt, kt, vt, o, do, lse,
                                                  kv_valid_len=tvalid, **kw)
    for name, e, p in zip("qkv", emul, plain):
        scale = p.float().abs().max().item()
        assert (e.float() - p.float()).abs().max().item() <= ATTN_TOL * scale, name
    if valid is not None and 0 in valid:
        assert not got[0][valid.index(0)].any()


def test_bf16_rmsnorm_function_with_emulated_kernel_matches_jax_autodiff():
    """``RMSNorm`` on bf16 rows with the bf16 kernels' arithmetic (the
    float32 forward and backward on the widened inputs, each output
    rounded to bf16 once): dx and dscale within NORM_TOL of JAX's autodiff
    of ``rmsnorm_apply`` in bf16, both bf16."""
    (xj, xt), (sj, st) = _both(_normal((37, 384), 30, 2.0)), _both(1 + 0.1 * _normal((384,), 31))
    w = _normal((37, 384), 32)
    jgrads = jax.grad(lambda x, s: jnp.sum(jax_rmsnorm({"scale": s}, x).astype(jnp.float32)
                                           * w), argnums=(0, 1))(xj, sj)

    def backward(x, scale, g, *, eps):
        return tuple(t.to(BF16) for t in rmsnorm_backward_ref(x.float(), scale.float(),
                                                                g.float(), eps=eps))

    x, s = xt.clone().requires_grad_(), st.clone().requires_grad_()
    y = RMSNorm.apply(x, s, 1e-6, rmsnorm_ref, backward)
    got = torch.autograd.grad((y.float() * torch.from_numpy(w)).sum(), (x, s))
    for name, g, r in zip(("dx", "dscale"), got, jgrads):
        _grad_close(g, r, NORM_TOL, name)


def test_bf16_backward_wrappers_check_inputs():
    """The backward wrappers take float32 or bf16, one dtype throughout,
    the forward's shapes and 16-byte aligned views: fp16, mixed dtypes,
    wrong shapes and a misaligned view raise ValueError before any device
    work (there is no fallback to the plain version)."""
    x, s = torch.zeros(4, 96, dtype=BF16), torch.ones(96, dtype=BF16)
    bad_rms = [(x.half(), s.half(), x.half()), (x, s.float(), x), (x, s, x.float()),
               (x, s[:95], x), (x, s, x[:3])]
    for args in bad_rms:
        with pytest.raises(ValueError):
            rmsnorm_backward_cuda(*args)
    q = torch.zeros(1, 4, 2, 64, dtype=BF16)
    lse = torch.zeros(1, 2, 4)
    off = torch.zeros(q.numel() + 1, dtype=BF16)[1:].view(q.shape)   # 2 bytes off
    bad_flash = [((q.half(),) * 5 + (lse,), "float32 or torch.bfloat16, got torch.float16"),
                 ((q, q.float(), q, q, q, lse), "bfloat16"),
                 ((q, q, q, q, q.float(), lse), "bfloat16"),
                 ((q, q, q, q, q, lse.to(BF16)), "float32"),
                 ((q, q, q[:, :3], q, q, lse), "q must be"),
                 ((q, q, q, q[:, :3], q, lse), "shape"),
                 ((q, q, q, q, q, lse[..., :3]), "lse must be"),
                 ((q, off, q, q, q, lse), "16-byte aligned"),
                 ((q, q, q, q, off, lse), "16-byte aligned")]
    for args, match in bad_flash:
        with pytest.raises(ValueError, match=match):
            flash_attention_backward_cuda(*args)


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
