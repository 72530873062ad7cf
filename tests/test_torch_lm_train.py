"""The port's LM training path on the CPU against the JAX package: the
plain versions of the flash-attention and RMSNorm backward (what the
autograd Functions' kernels compute on the card) against ``jax.grad`` of
the jnp functions, ``chunked_cross_entropy``, ``forward_loss`` /
``forward_hidden`` and every gradient leaf of the reduced qwen2-0.5b and
llama3.2-1b with the JAX weights bridged over, one ``make_train_step``
step, and the token data; within the port, remat on and off bitwise, and
the two Functions driven by plain-torch emulations of their kernels' tile
walks against autograd of the plain versions, the flash backward's walk
(q_offset, kv_valid_len, windows) also against float64.

Tolerances, each with its reason:
- values at 1e-5: fp32 sums run in another order;
- gradients at 1e-5 of the largest |gradient| of the leaf (``grad_close``):
  the same sums, differentiated;
- the emulated kernels against autograd at 1e-5 of scale: the kernels'
  recompute from the log-sum-exp and their per-tile sums round
  differently from the online softmax's autograd;
- the emulated flash backward tile walk (3xTF32 products) against dense
  float64 autograd at 1e-4 of scale, the card's bar (chip_smoke.py
  LM_GRAD_TOL), and bitwise across two runs;
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
# (T, causal, window) with S = T, B = 2; then the kernels' wider contract,
# named by id: S, q_offset, per-row kv_valid_len (a 0 among them), B.  Each
# stays causal or keeps S within one key block, since the jnp function
# leaks mass to its padded keys when not causal (ROADMAP Queue 3,
# reference side).
FLASH_CASES = [pytest.param(T_, causal, window, {}, id=f"{T_}-{causal}-{window}")
               for T_, causal, window in [(48, True, 0), (48, True, 16),
                                          (130, True, 0), (130, True, 16),
                                          (48, False, 0), (130, False, 0)]]
FLASH_CONTRACT_CASES = [
    pytest.param(48, True, 0, dict(S=80), id="T<S"),
    pytest.param(48, True, 0, dict(S=65, q_offset=17), id="q_offset17"),
    pytest.param(100, True, 0, dict(S=130, q_offset=17), id="q_offset17-T<S"),
    pytest.param(48, True, 0, dict(B=3, valid=(48, 0, 29)), id="kv_valid_len"),
    pytest.param(40, True, 0, dict(B=3, S=90, q_offset=50, valid=(90, 0, 61)),
                 id="kv_valid_len-q_offset50"),
    pytest.param(48, True, 16, dict(S=80, q_offset=32), id="window16-q_offset32"),
    pytest.param(21, False, 0, dict(B=3, S=45, valid=(45, 0, 13)),
                 id="not_causal-kv_valid_len"),
    pytest.param(30, False, 9, dict(S=60, q_offset=20), id="not_causal-window9-q_offset20"),
]


def _flash_inputs(T_, extra, Hq=4, Hkv=2, seed=0):
    """q, k, v, do as numpy, and the contract's keywords (kv_valid_len
    as numpy int32 or None)."""
    B_, S_ = extra.get("B", 2), extra.get("S", T_)
    q, k, v = (_normal(shape, seed + s) for s, shape in
               ((0, (B_, T_, Hq, 64)), (1, (B_, S_, Hkv, 64)), (2, (B_, S_, Hkv, 64))))
    do = _normal((B_, T_, Hq, 64), seed + 3)
    valid = extra.get("valid")
    kw = dict(q_offset=extra.get("q_offset", 0),
              kv_valid_len=None if valid is None else np.asarray(valid, np.int32))
    return q, k, v, do, kw


def _torch_kw(kw):
    valid = kw["kv_valid_len"]
    return dict(q_offset=kw["q_offset"],
                kv_valid_len=None if valid is None else torch.from_numpy(valid))


@pytest.mark.parametrize("T_,causal,window,extra", FLASH_CASES + FLASH_CONTRACT_CASES)
def test_plain_flash_backward_matches_jax_grad(T_, causal, window, extra):
    q, k, v, do, kw = _flash_inputs(T_, extra)

    # several KV blocks under causal masking; one block of S keys otherwise,
    # since the jnp function leaks mass to its padded keys when not causal
    # (ROADMAP Queue 3, reference side)
    blocks = dict(q_block=32, kv_block=32) if causal else {}
    jkw = dict(q_offset=kw["q_offset"], kv_valid_len=None if kw["kv_valid_len"] is None
               else jnp.asarray(kw["kv_valid_len"]))

    def jloss(q, k, v):
        o = jax_flash(q, k, v, causal=causal, window=window, **blocks, **jkw)
        return jnp.sum(o * do)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_attention_ref(tq, tk, tv, causal=causal, window=window,
                                 return_lse=True, **_torch_kw(kw))
    got = flash_attention_backward_ref(tq, tk, tv, o, tdo, lse, causal=causal,
                                       window=window, **_torch_kw(kw))
    for name, r, g in zip("qkv", ref, got):
        grad_close(r, g, what=f"d{name}")
    if kw["kv_valid_len"] is not None:            # a row with no live key
        b0 = list(kw["kv_valid_len"]).index(0)
        assert torch.equal(got[0][b0], torch.zeros_like(got[0][b0]))
        assert bool(torch.isneginf(lse[b0]).all())


def test_plain_rmsnorm_backward_matches_jax_grad():
    x, scale, g = _normal((7, 96), 0, 3.0), 1 + _normal((96,), 1, 0.1), _normal((7, 96), 2)
    ref = jax.grad(lambda x, s: jnp.sum(jax_rmsnorm({"scale": s}, x) * g),
                   argnums=(0, 1))(x, scale)
    got = rmsnorm_backward_ref(*map(torch.from_numpy, (x, scale, g)))
    grad_close(ref[0], got[0], what="dx")
    grad_close(ref[1], got[1], what="dscale")


# ------------------------------------------ the Functions, emulated kernels --
def _flash_forward_emulated(q, k, v, *, causal, window, q_offset=0, kv_valid_len=None):
    return flash_attention_ref(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, kv_valid_len=kv_valid_len,
                               return_lse=True)


def _tf32(x):
    """cvt.rna.tf32.f32: round to nearest, ties away from zero, to 10
    mantissa bits, the 13 bits below cleared (as tests/test_torch_llm_kernels.py)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_toward_zero(x):
    """What the tensor core keeps of fp32 bits handed over as a .tf32
    operand: the top 10 mantissa bits, the 13 below dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mma(a, b, acc):
    """acc + a @ b in m16n8k8 steps, 3xTF32 as the backward splits
    (csrc/flash_common.cuh split_tf32_fast): hi as cvt.rna, lo = x - hi
    rounded toward zero; per 8-wide k-step, in fp32, lo*hi and hi*lo and
    then hi*hi (the order of tests/test_torch_llm_kernels.py)."""
    for k0 in range(0, a.shape[-1], 8):
        ak, bk = a[..., k0:k0 + 8], b[..., k0:k0 + 8, :]
        ah, bh = _tf32(ak), _tf32(bk)
        acc = acc + _tf32_toward_zero(ak - ah) @ bh
        acc = acc + ah @ _tf32_toward_zero(bk - bh)
        acc = acc + ah @ bh
    return acc


LOG2E = torch.tensor(1.4426950408889634)


def _p(s, scale, lse):
    """P as the kernels compute it in fp32: exp2(s scale log2 e - lse log2 e)."""
    return torch.exp2(s * (torch.tensor(scale) * LOG2E) - lse * LOG2E)


FLASH_BWD_TILE = 64     # keys of a dK/dV block, query rows of a dQ block


def _flash_bwd_tiles(D):
    """(q rows of a dK/dV q tile, keys of a dQ KV tile), per D."""
    return (64, 64) if D == 64 else (32, 32)


def _flash_backward_emulated(q, k, v, o, do, lse, *, causal, window, q_offset=0,
                             kv_valid_len=None):
    """The backward kernels' tile walk (csrc/flash_attention_backward.cu):
    dvec = rowsum(dO * O); per (64-key tile, kv head) the q tiles from
    max(0, kb - q_offset) (causal) to k_hi - 1 + window - q_offset (window)
    for each of the G query heads, S^T = K Q^T and dP^T = V dO^T, P^T
    recomputed from the log-sum-exp by exp2 (+inf past T or for a row with
    no live key), and dK / dV summed over the group; per (64-row q tile, q head)
    the KV tiles from the window's first live tile to the causal diagonal
    or kv_valid_len, dQ summed over them.  Every product in 3xTF32
    (``_mma``), each tile's from 0 and then added to the running sum in
    fp32; the mask applied only on a tile that touches a mask edge,
    with the kernels' test for it; rows and keys past T and S zero."""
    Bn, Tn, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G, scale, BT = Hq // Hkv, D ** -0.5, FLASH_BWD_TILE
    BQ, BK = _flash_bwd_tiles(D)
    inf = float("inf")
    dvec = (do * o).sum(-1).permute(0, 2, 1)                 # (B, Hq, T)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)

    def rows(x, b, h, r0, n):            # n rows from r0, zero past the end
        out = torch.zeros(n, D)
        got = x[b, r0:r0 + n, h]
        out[:got.shape[0]] = got
        return out

    def row_stats(b, hq, q0, n):         # lse (+inf where P must be 0), dvec
        lo, dd = torch.full((n,), inf), torch.zeros(n)
        m = min(n, Tn - q0)
        lo[:m], dd[:m] = lse[b, hq, q0:q0 + m], dvec[b, hq, q0:q0 + m]
        return torch.where(lo == -inf, inf, lo), dd

    def edge(kb, n_k, qp_lo, qp_hi, valid):
        return (kb + n_k > valid or (causal and kb + n_k - 1 > qp_lo)
                or (window > 0 and kb <= qp_hi - window))

    def live(qp, kp, valid):             # qp (n, 1), kp (1, m) positions
        m = kp < valid
        if causal:
            m = m & (kp <= qp)
        if window > 0:
            m = m & (kp > qp - window)
        return m

    for b in range(Bn):
        valid = S if kv_valid_len is None else max(0, min(S, int(kv_valid_len[b])))
        for hk in range(Hkv):
            for kb in range(0, S, BT):
                k_hi = min(kb + BT, valid)
                i_lo = i_hi = 0
                if k_hi > kb:
                    i_lo = max(0, kb - q_offset) if causal else 0
                    i_hi = min(Tn, k_hi - 1 + window - q_offset) if window > 0 else Tn
                K, V = rows(k, b, hk, kb, BT), rows(v, b, hk, kb, BT)
                kp = torch.arange(kb, kb + BT)[:, None]
                acc_k, acc_v = torch.zeros(BT, D), torch.zeros(BT, D)
                for hq in range(hk * G, hk * G + G) if i_hi > i_lo else ():
                    for q0 in range(i_lo // BQ * BQ, i_hi, BQ):
                        Q, dO = rows(q, b, hq, q0, BQ), rows(do, b, hq, q0, BQ)
                        lo, dd = row_stats(b, hq, q0, BQ)
                        st = _mma(K, Q.T, torch.zeros(BT, BQ))
                        dpt = _mma(V, dO.T, torch.zeros(BT, BQ))
                        p = _p(st, scale, lo[None, :])
                        qp_lo = q_offset + q0
                        if edge(kb, BT, qp_lo, qp_lo + BQ - 1, valid):
                            qp = torch.arange(qp_lo, qp_lo + BQ)[None, :]
                            p = torch.where(live(qp, kp, valid), p, 0.0)
                        ds = p * (dpt - dd[None, :])
                        acc_v = acc_v + _mma(p, dO, torch.zeros(BT, D))
                        acc_k = acc_k + _mma(ds, Q, torch.zeros(BT, D))
                n_k = min(BT, S - kb)
                dk[b, kb:kb + n_k, hk] = (acc_k * scale)[:n_k]
                dv[b, kb:kb + n_k, hk] = acc_v[:n_k]
        for hq in range(Hq):
            for q0 in range(0, Tn, BT):
                n_q = min(BT, Tn - q0)
                qp_lo, qp_hi = q_offset + q0, q_offset + q0 + n_q - 1
                k_end = min(valid, max(0, qp_hi + 1)) if causal else valid
                k_begin = max(0, qp_lo - window + 1) if window > 0 else 0
                Q, dO = rows(q, b, hq, q0, BT), rows(do, b, hq, q0, BT)
                lo, dd = row_stats(b, hq, q0, BT)
                qp = torch.arange(qp_lo, qp_lo + BT)[:, None]
                acc = torch.zeros(BT, D)
                for kb in range(k_begin // BK * BK, k_end, BK):
                    K, V = rows(k, b, hq // G, kb, BK), rows(v, b, hq // G, kb, BK)
                    s_ = _mma(Q, K.T, torch.zeros(BT, BK))
                    dp = _mma(dO, V.T, torch.zeros(BT, BK))
                    p = _p(s_, scale, lo[:, None])
                    if edge(kb, BK, qp_lo, qp_hi, valid):
                        p = torch.where(live(qp, torch.arange(kb, kb + BK)[None, :], valid),
                                        p, 0.0)
                    acc = acc + _mma(p * (dp - dd[:, None]), K, torch.zeros(BT, D))
                dq[b, q0:q0 + n_q, hq] = (acc * scale)[:n_q]
    return dq, dk, dv


def _rmsnorm_backward_emulated(x, scale, g, *, eps, blocks=3, rows_a_block=2,
                               sum_groups=4):
    """The backward kernel's walk (csrc/rmsnorm_backward.cu): rows dealt
    grid-stride to the ``blocks`` x ``rows_a_block`` row groups, each
    group's g * (x * r) summed row by row, a block's groups added in order
    into its partial row; then each column of the partial rows summed by
    ``sum_groups`` row groups (rows grp, grp + sum_groups, ...) and their
    sums folded in a fixed tree."""
    N, d = x.shape
    grid = min(-(-N // rows_a_block), blocks)
    groups = grid * rows_a_block
    acc = torch.zeros(groups, d)
    dx = torch.empty_like(x)
    for row in range(N):
        xr, gr = x[row], g[row]
        r = torch.rsqrt(torch.sum(xr * xr) / d + eps)
        c = r * r * r * (torch.sum(xr * scale * gr) / d)
        dx[row] = r * (scale * gr) - xr * c
        acc[row % groups] += gr * (xr * r)
    partial = acc.reshape(grid, rows_a_block, d)[:, 0].clone()
    for s in range(1, rows_a_block):
        partial = partial + acc.reshape(grid, rows_a_block, d)[:, s]
    sums = torch.zeros(sum_groups, d)
    for b in range(grid):
        sums[b % sum_groups] += partial[b]
    half = sum_groups // 2
    while half:
        sums[:half] = sums[:half] + sums[half:2 * half]
        half //= 2
    return dx, sums[0]


# (T, S, causal, window) with B = 2; then the kernels' wider contract,
# named by id: q_offset, per-row kv_valid_len (a 0 among them), B
FUNCTION_CASES = [pytest.param(T_, S_, causal, window, {}, id=f"{T_}-{S_}-{causal}-{window}")
                  for T_, S_, causal, window in [(40, 40, True, 0), (37, 37, True, 9),
                                                 (21, 45, False, 0), (45, 21, False, 7)]]
FUNCTION_CONTRACT_CASES = [
    pytest.param(48, 65, True, 0, dict(q_offset=17), id="q_offset17"),
    pytest.param(70, 130, True, 0, dict(q_offset=17), id="q_offset17-T<S"),
    pytest.param(48, 48, True, 0, dict(B=3, valid=(48, 0, 29)), id="kv_valid_len"),
    pytest.param(40, 90, True, 0, dict(B=3, q_offset=50, valid=(90, 0, 61)),
                 id="kv_valid_len-q_offset50"),
    pytest.param(48, 80, True, 16, dict(q_offset=32), id="window16-q_offset32"),
    pytest.param(30, 60, False, 9, dict(q_offset=20, valid=(60, 33)),
                 id="not_causal-window9-q_offset20"),
]


@pytest.mark.parametrize("T_,S_,causal,window,extra", FUNCTION_CASES + FUNCTION_CONTRACT_CASES)
def test_flash_function_with_emulated_kernels_matches_autograd(T_, S_, causal, window,
                                                               extra):
    qn, kn, vn, _, kw = _flash_inputs(T_, dict(extra, S=S_), Hq=6)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (qn, kn, vn))
    w = torch.from_numpy(_normal(qn.shape, 3))
    kw = _torch_kw(kw)
    out = FlashAttention.apply(q, k, v, causal, window, kw["q_offset"],
                               kw["kv_valid_len"], _flash_forward_emulated,
                               _flash_backward_emulated)
    got = torch.autograd.grad((out * w).sum(), (q, k, v))
    ref_out = flash_attention_ref(q, k, v, causal=causal, window=window, **kw)
    ref = torch.autograd.grad((ref_out * w).sum(), (q, k, v))
    assert torch.equal(out, ref_out)
    for name, r, g in zip("qkv", ref, got):
        grad_close(r, g, what=f"d{name}")


def _exact_flash_grads(q, k, v, do, *, causal, window, q_offset, kv_valid_len):
    """Dense attention in float64 under the kernels' mask, a row with no
    live key giving 0: (dq, dk, dv) of sum(out * do) by autograd."""
    T_, S_, G = q.shape[1], k.shape[1], q.shape[2] // k.shape[2]
    q64, k64, v64 = (t.double().requires_grad_() for t in (q, k, v))
    qp = torch.arange(T_)[:, None] + q_offset
    kp = torch.arange(S_)[None, :]
    live = torch.ones(q.shape[0], 1, T_, S_, dtype=torch.bool)
    if causal:
        live = live & (kp <= qp)
    if window > 0:
        live = live & (kp > qp - window)
    if kv_valid_len is not None:
        live = live & (kp < kv_valid_len.long()[:, None, None, None])
    s = torch.einsum("bthd,bshd->bhts", q64, k64.repeat_interleave(G, 2)) * q.shape[-1] ** -0.5
    s = s.masked_fill(~live, -float("inf"))
    m = s.amax(-1, keepdim=True).detach()
    e = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0)) * live
    p = e / e.sum(-1, keepdim=True).clamp(min=1e-300)
    out = torch.einsum("bhts,bshd->bthd", p, v64.repeat_interleave(G, 2))
    return torch.autograd.grad(out, (q64, k64, v64), do.double())


@pytest.mark.parametrize("T_,S_,causal,window,extra", FUNCTION_CASES + FUNCTION_CONTRACT_CASES)
def test_flash_backward_emulated_tile_walk_matches_float64(T_, S_, causal, window, extra):
    """The kernels' 3xTF32 tile walk within the card's bar (1e-4 of each
    gradient's scale, LM_GRAD_TOL of chip_smoke.py) of float64 autograd of
    dense attention, and bitwise equal across two runs."""
    qn, kn, vn, don, kw = _flash_inputs(T_, dict(extra, S=S_), Hq=6)
    q, k, v, do = map(torch.from_numpy, (qn, kn, vn, don))
    kw = _torch_kw(kw)
    o, lse = flash_attention_ref(q, k, v, causal=causal, window=window,
                                 return_lse=True, **kw)
    runs = [_flash_backward_emulated(q, k, v, o, do, lse, causal=causal,
                                     window=window, **kw) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    ref = _exact_flash_grads(q, k, v, do, causal=causal, window=window, **kw)
    for name, r, g in zip("qkv", ref, runs[0]):
        assert torch.isfinite(g).all()
        grad_close(r.numpy(), g, tol=1e-4, what=f"d{name}")


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
    # patches belong to a VLM config: a dense one refuses them
    with pytest.raises(ValueError, match="does not take"):
        tbb.forward_loss(cfg, params, {"tokens": np.zeros((1, 4), np.int32),
                                       "labels": np.zeros((1, 4), np.int32),
                                       "patches": np.zeros((1, 2, 8), np.float32)})
    # a hybrid, once refused, now runs: forward_hidden of attention + a
    # Mamba block within TOL of JAX's on the same weights
    from repro.configs.base import HybridSpec as JaxHybridSpec
    from repro_torch.bridge import backbone_params_to_numpy
    from repro_torch.configs.base import HybridSpec
    hybrid = dataclasses.replace(cfg, hybrid=HybridSpec(period=2))
    jhybrid = dataclasses.replace(jax_get_config("qwen2-0.5b").reduced(),
                                  hybrid=JaxHybridSpec(period=2))
    hp = tbb.init_params(hybrid, 0, device="cpu")
    toks = np.random.RandomState(2).randint(0, cfg.vocab, (1, 6)).astype(np.int32)
    want = jbb.forward_hidden(jhybrid, jax.tree_util.tree_map(
        jnp.asarray, backbone_params_to_numpy(hp, hybrid)), {"tokens": jnp.asarray(toks)})
    got = tbb.forward_hidden(hybrid, hp, {"tokens": toks})
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL, rtol=TOL)
