"""The port's LLM kernels on the CPU: the plain PyTorch versions of
RMSNorm, flash attention and paged decode attention (what ``ops.py`` runs
for CPU tensors) held against the JAX package's oracles, its jnp paths
and, where it runs here, its Pallas kernel in interpret mode; the flash
kernel's 3xTF32 arithmetic and the decode kernel's split-K arithmetic,
emulated, against the same oracles."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.attention.ops import flash_attention_op as jax_flash_op  # noqa: E402
from repro.kernels.decode_attention.ops import paged_decode_attention_jnp  # noqa: E402
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_decode_ref  # noqa: E402
from repro.kernels.rmsnorm.ops import rmsnorm_op as jax_rmsnorm_op  # noqa: E402
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_rmsnorm_ref  # noqa: E402
from repro.nn.attention import flash_attention as jax_flash  # noqa: E402
from repro.nn.attention import reference_attention as jax_reference  # noqa: E402
from repro_torch.kernels.attention.ops import flash_attention_op  # noqa: E402
from repro_torch.kernels.attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.decode_attention.kernel import (  # noqa: E402
    SPLIT_BLOCKS_PER_SM,
    SPLIT_TILE,
    split_slots,
)
from repro_torch.kernels.decode_attention.ops import decode_attention_op  # noqa: E402
from repro_torch.kernels.rmsnorm.ops import rmsnorm_op  # noqa: E402
from repro_torch.nn.attention import reference_attention  # noqa: E402

# the JAX package's own bars for these oracles (tests/test_kernels.py,
# tests/test_attention.py, tests/test_decode_attention.py)
RMS_TOL = 1e-5
ATTN_TOL = 2e-5


def close(jax_out, torch_out, tol):
    np.testing.assert_allclose(torch_out.numpy(), np.asarray(jax_out),
                               atol=tol, rtol=tol)


def _normal(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(1, 128), (7, 896), (3, 5, 256), (33, 64)])
def test_rmsnorm_matches_jax(shape):
    x = _normal(shape, 0) * 3
    scale = 1 + 0.1 * _normal(shape[-1:], 1)
    got = rmsnorm_op(torch.from_numpy(x), torch.from_numpy(scale))
    assert got.shape == x.shape and got.dtype == torch.float32
    close(jax_rmsnorm_ref(jnp.asarray(x), jnp.asarray(scale)), got, RMS_TOL)
    close(jax_rmsnorm_op(jnp.asarray(x), jnp.asarray(scale), interpret=True),
          got, RMS_TOL)


def _qkv(B, T, S, Hq, Hkv, D, seed=0):
    return (_normal((B, T, Hq, D), seed), _normal((B, S, Hkv, D), seed + 1),
            _normal((B, S, Hkv, D), seed + 2))


@pytest.mark.parametrize("B,T,Hq,Hkv,D,window,q_offset", [
    (2, 17, 4, 2, 64, 0, 0),
    (1, 40, 7, 1, 64, 9, 0),
    (2, 24, 4, 4, 128, 0, 0),
    (1, 19, 6, 2, 64, 0, 13),
    (1, 21, 4, 2, 64, 5, 8),
])
def test_flash_matches_jax(B, T, Hq, Hkv, D, window, q_offset):
    S = T + q_offset
    q, k, v = _qkv(B, T, S, Hq, Hkv, D)
    got = flash_attention_op(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=True, window=window,
                             q_offset=q_offset)
    qj, kj, vj = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    close(jax_reference(qj, kj, vj, causal=True, window=window,
                        q_offset=q_offset), got, ATTN_TOL)
    close(jax_flash(qj, kj, vj, causal=True, window=window, q_offset=q_offset,
                    q_block=8, kv_block=8), got, ATTN_TOL)
    torch.testing.assert_close(
        got, reference_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=True,
                                 window=window, q_offset=q_offset),
        atol=ATTN_TOL, rtol=ATTN_TOL)
    if window == 0 and q_offset == 0:
        # the Pallas kernel has neither q_offset nor a window on this path
        close(jax_flash_op(qj, kj, vj, causal=True, q_block=8, kv_block=8,
                           interpret=True), got, ATTN_TOL)


def test_flash_ragged_kv_valid_len_matches_jax():
    B, T, Hq, Hkv, D = 3, 20, 4, 2, 64
    q, k, v = _qkv(B, T, T, Hq, Hkv, D, seed=3)
    valid = np.array([20, 7, 1], np.int32)
    got = flash_attention_op(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v),
                             kv_valid_len=torch.from_numpy(valid))
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     q_block=8, kv_block=8, kv_valid_len=jnp.asarray(valid))
    close(want, got, ATTN_TOL)
    # row 2 sees key 0 alone: every query row outputs v[0]
    torch.testing.assert_close(got[2], torch.from_numpy(v[2, :1]).repeat_interleave(
        2, dim=1).expand(T, Hq, D), atol=ATTN_TOL, rtol=ATTN_TOL)


def test_flash_non_causal_masks_keys_past_s():
    """Non-causal, S past one key block and not a multiple of it: the plain
    version holds to reference_attention (the jnp flash_attention lets its
    zero-padded keys take softmax mass here)."""
    B, T, S, Hq, Hkv, D = 1, 6, 21, 4, 2, 64
    q, k, v = _qkv(B, T, S, Hq, Hkv, D, seed=5)
    got = flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=False, kv_block=8)
    close(jax_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=False), got, ATTN_TOL)


@pytest.mark.parametrize("B,S,Hq,Hkv,D", [(3, 64, 4, 4, 64), (2, 96, 7, 1, 64),
                                          (3, 128, 8, 2, 128)])
def test_decode_attention_matches_jax(B, S, Hq, Hkv, D):
    q = _normal((B, 1, Hq, D), 0)
    k, v = _normal((B, S, Hkv, D), 1), _normal((B, S, Hkv, D), 2)
    qt, kt, vt = torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)
    qj, kj, vj = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    rows = np.array([1, S // 2, S][:B], np.int32)
    for attend in (S // 3, rows):
        got = decode_attention_op(qt, kt, vt, torch.as_tensor(attend))
        close(jax_decode_ref(qj, kj, vj, jnp.asarray(attend)), got, ATTN_TOL)
        close(paged_decode_attention_jnp(qj, kj, vj, jnp.asarray(attend),
                                         page_size=32), got, ATTN_TOL)
    # a Python int is a scalar attend_len too
    torch.testing.assert_close(decode_attention_op(qt, kt, vt, S // 3),
                               decode_attention_op(qt, kt, vt,
                                                   torch.tensor(S // 3)))


def test_decode_attention_attend_zero_row_gives_zero():
    """A row with attend_len = 0 has no live key and gets 0: the TPU kernel
    divides acc = 0 by max(l, 1e-20), and the port's kernel and plain
    version do the same (flash_attention_ref's convention too).  The JAX
    dense oracle's all-masked softmax averages the whole cache there, so
    that row is the one place the plain version leaves it; every row with
    attend_len >= 1 still matches it."""
    B, S, Hq, Hkv, D = 4, 64, 8, 2, 64
    q = _normal((B, 1, Hq, D), 7)
    k, v = _normal((B, S, Hkv, D), 8), _normal((B, S, Hkv, D), 9)
    attend = np.array([0, 1, 37, S], np.int32)
    qt, kt, vt = torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)
    got = decode_attention_op(qt, kt, vt, torch.from_numpy(attend))
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    want = np.asarray(jax_decode_ref(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(attend)))
    assert np.abs(want[0]).max() > 0.01          # the oracle's cache average
    close(want[1:], got[1:], ATTN_TOL)
    assert torch.equal(decode_attention_op(qt, kt, vt, 0), torch.zeros_like(got))


# ---- the arithmetic of csrc/flash_attention.cu, emulated on the CPU --------
def _tf32(x):
    """cvt.rna.tf32.f32: round to nearest, ties away from zero, to 10
    mantissa bits, the 13 bits below cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mma(a, b, acc, split: bool):
    """acc + a @ b in the kernel's m16n8k8 steps: per 8-wide k-step, in
    fp32, lo*hi and hi*lo (the 3xTF32 split) and then hi*hi."""
    for k0 in range(0, a.shape[-1], 8):
        ak, bk = a[..., k0:k0 + 8], b[..., k0:k0 + 8, :]
        ah, bh = _tf32(ak), _tf32(bk)
        if split:
            acc = acc + _tf32(ak - ah) @ bh
            acc = acc + ah @ _tf32(bk - bh)
        acc = acc + ah @ bh
    return acc


def _flash_tf32(q, k, v, *, window, q_offset, split):
    """Causal attention as the kernel computes it: KV tiles of 64 keys (32
    at D = 128), Q.K^T and P.V through _mma, and the plain version's
    online softmax (running max, expf, correction) in fp32."""
    B, T, Hq, D = q.shape
    S, G = k.shape[1], Hq // k.shape[2]
    tile, inf = 64 if D == 64 else 32, float("inf")
    qh = q.permute(0, 2, 1, 3)
    kh = k.repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
    vh = v.repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
    m, l = torch.full((B, Hq, T), -inf), torch.zeros(B, Hq, T)
    acc = torch.zeros(B, Hq, T, D)
    q_pos = torch.arange(T)[:, None] + q_offset
    for kb in range(0, S, tile):
        kt, vt = kh[:, :, kb:kb + tile], vh[:, :, kb:kb + tile]
        k_pos = torch.arange(kb, kb + kt.shape[2])[None, :]
        s = _mma(qh, kt.transpose(-1, -2), torch.zeros(B, Hq, T, kt.shape[2]),
                 split) * (1.0 / math.sqrt(D))
        live = k_pos <= q_pos
        if window > 0:
            live = live & (k_pos > q_pos - window)
        s = torch.where(live, s, -inf)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(m_new == -inf, 0.0, m_new)
        corr = torch.where(m == -inf, 0.0, torch.exp(m - m_safe))
        p = torch.where(s == -inf, 0.0, torch.exp(s - m_safe[..., None]))
        l = corr * l + p.sum(-1)
        acc = _mma(p, vt, acc * corr[..., None], split)
        m = m_new
    return (acc / torch.clamp(l, min=1e-20)[..., None]).permute(0, 2, 1, 3)


def _exact_attention(q, k, v, *, window, q_offset):
    """Causal attention in float64: the yardstick of fp32's own error."""
    T, S, G = q.shape[1], k.shape[1], q.shape[2] // k.shape[2]
    q, k, v = (torch.from_numpy(x).double() for x in (q, k, v))
    s = torch.einsum("bthd,bshd->bhts", q, k.repeat_interleave(G, dim=2))
    q_pos, k_pos = torch.arange(T)[:, None] + q_offset, torch.arange(S)[None, :]
    live = k_pos <= q_pos
    if window > 0:
        live = live & (k_pos > q_pos - window)
    p = torch.softmax((s / math.sqrt(q.shape[-1])).masked_fill(~live, -math.inf),
                      dim=-1)
    return torch.einsum("bhts,bshd->bthd", p, v.repeat_interleave(G, dim=2))


# the existing flash cases, and two that span several KV tiles
TF32_CASES = [(2, 17, 4, 2, 64, 0, 0), (1, 40, 7, 1, 64, 9, 0),
              (2, 24, 4, 4, 128, 0, 0), (1, 19, 6, 2, 64, 0, 13),
              (1, 21, 4, 2, 64, 5, 8), (1, 150, 4, 2, 64, 0, 0),
              (1, 100, 4, 2, 128, 0, 0)]
# 3xTF32 products keep about 2^-21 of each product against fp32's 2^-24
SPLIT_COST = 8


@pytest.mark.parametrize("split", [True, False], ids=["3xtf32", "1xtf32"])
@pytest.mark.parametrize("x", [1, 8])
@pytest.mark.parametrize("B,T,Hq,Hkv,D,window,q_offset", TF32_CASES)
def test_flash_kernel_arithmetic_precision(B, T, Hq, Hkv, D, window, q_offset,
                                           x, split):
    """The precision choice of csrc/flash_attention.cu, before the card.

    Unit inputs: the 3xTF32 emulation is within 2e-5 abs + rel of the JAX
    package's reference_attention, one TF32 product is ten times past it.
    Inputs x8: scores reach hundreds and fp32 itself is off by more than
    2e-5 (the JAX reference is, against float64), so each is held against
    float64: 3xTF32 within SPLIT_COST times the JAX fp32 reference's own
    error, one TF32 product a hundred times past that."""
    q, k, v = (a * x for a in _qkv(B, T, T + q_offset, Hq, Hkv, D))
    got = _flash_tf32(torch.from_numpy(q), torch.from_numpy(k),
                      torch.from_numpy(v), window=window, q_offset=q_offset,
                      split=split).numpy()
    ref = np.asarray(jax_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   causal=True, window=window, q_offset=q_offset))
    if x == 1:
        over = (np.abs(got - ref) / (ATTN_TOL + ATTN_TOL * np.abs(ref))).max()
        assert over <= 1 if split else over > 10, over
    else:
        exact = _exact_attention(q, k, v, window=window, q_offset=q_offset).numpy()
        err, ref_err = np.abs(got - exact).max(), np.abs(ref - exact).max()
        assert ref_err > ATTN_TOL
        assert (err <= SPLIT_COST * ref_err if split
                else err > 100 * ref_err), (err, ref_err)


# ---- the split-K arithmetic of csrc/decode_attention.cu, emulated ---------
H100_SMS = 132        # the SMs of an H100 SXM, what the wrapper sizes by


def _decode_split_k(q, k, v, attend, *, sms):
    """Decode attention as the kernel computes it.  Each row's slots are
    cut into splits of ``split_slots`` slots (the wrapper's rule; the grid
    covers attend when it is an int, S when it is per row).  A split at or
    past its row's attend leaves nothing; a live one walks its slots in
    tiles of SPLIT_TILE with an online softmax (running m, l, acc in fp32)
    and leaves a partial (m, l, acc).  The scratch starts as NaN, as
    torch.empty may leave it.  The combine rescales each live partial by
    exp(m_i - m) and divides by max(sum l_i e^(m_i - m), 1e-20)."""
    B, _, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G, inf, scale = Hq // Hkv, float("inf"), 1.0 / math.sqrt(D)
    per_row = isinstance(attend, np.ndarray)
    rows = np.clip(np.broadcast_to(attend, (B,)), 0, S)
    depth = S if per_row else int(rows[0])
    split = split_slots(B, depth, Hkv, sms)
    n_splits = -(-depth // split)
    qg = q.reshape(B, Hkv, G, D)
    part_acc = torch.full((B, n_splits, Hkv, G, D), float("nan"))
    part_m = torch.full((B, n_splits, Hkv, G), float("nan"))
    part_l = torch.full((B, n_splits, Hkv, G), float("nan"))
    for b in range(B):
        for i in range(n_splits):
            s0, s1 = i * split, min(int(rows[b]), (i + 1) * split)
            if s0 >= s1:
                continue                    # a dead split reads nothing
            m, l = torch.full((Hkv, G), -inf), torch.zeros(Hkv, G)
            acc = torch.zeros(Hkv, G, D)
            for t0 in range(s0, s1, SPLIT_TILE):
                kt = k[b, t0:min(s1, t0 + SPLIT_TILE)]
                vt = v[b, t0:min(s1, t0 + SPLIT_TILE)]
                sc = torch.einsum("hgd,nhd->hgn", qg[b], kt) * scale
                m_new = torch.maximum(m, sc.amax(-1))
                corr = torch.exp(m - m_new)         # 0 on the first tile
                p = torch.exp(sc - m_new[..., None])
                l = corr * l + p.sum(-1)
                acc = acc * corr[..., None] + torch.einsum("hgn,nhd->hgd", p, vt)
                m = m_new
            part_acc[b, i], part_m[b, i], part_l[b, i] = acc, m, l
    out = torch.zeros(B, Hkv, G, D)
    for b in range(B):
        live = -(-int(rows[b]) // split)
        if live == 0:
            num, den = torch.zeros(Hkv, G, D), torch.zeros(Hkv, G)
        else:
            w = torch.exp(part_m[b, :live] - part_m[b, :live].amax(0))
            den = (w * part_l[b, :live]).sum(0)
            num = (w[..., None] * part_acc[b, :live]).sum(0)
        out[b] = num / torch.clamp(den, min=1e-20)[..., None]
    return out.reshape(B, 1, Hq, D)


# (B, S, Hq, Hkv, D, attend): a 32-slot boundary and one off it, attend 1
# and S, G in {1, 4, 7, 8}, D in {64, 128}, S off the page, per-row depths
# in different splits with a 0 among them
DECODE_SPLIT_CASES = [
    (2, 256, 8, 2, 64, 64), (2, 256, 8, 2, 64, 63), (2, 256, 8, 2, 64, 65),
    (2, 128, 4, 4, 64, 1), (2, 128, 7, 1, 128, 128),
    (3, 1000, 8, 1, 64, [1000, 31, 517]),
    (4, 96, 8, 1, 128, [0, 96, 32, 33]),
    (3, 200, 14, 2, 64, [64, 65, 200]),
]


@pytest.mark.parametrize("sms", [H100_SMS, 1], ids=["h100", "one_sm"])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,attend", DECODE_SPLIT_CASES)
def test_decode_split_k_arithmetic(B, S, Hq, Hkv, D, attend, sms):
    """The split-K partials and their combine, before the card: within
    2e-5 abs + rel of JAX's dense decode_attention_ref and its paged jnp
    path on every row with a live slot, exactly 0 on a row with none, no
    NaN.  On an H100 these shapes take 32-slot splits; on one SM the
    splits hold several tiles, so the online softmax inside a split runs
    too.  NaN written into the cache past each row's depth, and the NaN
    scratch of dead splits, change nothing: the emulation reads neither,
    as the kernel must not."""
    attend = np.asarray(attend, np.int32) if isinstance(attend, list) else attend
    q = _normal((B, 1, Hq, D), 10)
    k, v = _normal((B, S, Hkv, D), 11), _normal((B, S, Hkv, D), 12)
    qt, kt, vt = torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)
    got = _decode_split_k(qt, kt, vt, attend, sms=sms)
    assert torch.isfinite(got).all()
    rows = np.broadcast_to(attend, (B,))
    want = np.asarray(jax_decode_ref(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(attend)))
    paged = np.asarray(paged_decode_attention_jnp(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(attend),
        page_size=8))
    live = rows > 0
    close(want[live], got[live], ATTN_TOL)
    close(paged[live], got[live], ATTN_TOL)
    assert torch.equal(got[~live], torch.zeros_like(got[~live]))
    dead = np.arange(S)[None, :] >= rows[:, None]
    kp, vp = k.copy(), v.copy()
    kp[dead], vp[dead] = np.nan, np.nan
    assert torch.equal(_decode_split_k(qt, torch.from_numpy(kp),
                                       torch.from_numpy(vp), attend, sms=sms),
                       got)


def test_decode_split_rule_fills_the_card():
    """The wrapper's splits at the serving path's decode shape (qwen2-0.5b,
    B = 8, Hkv = 2, attend 528 of S = 1024): 32-slot splits, 17 per
    (row, kv head), 272 blocks against B * Hkv = 16.  Every split is a
    whole number of tiles, and the grid stays within about four blocks
    per SM however wide the batch or the cache."""
    assert split_slots(8, 528, 2, H100_SMS) == 32
    assert 8 * 2 * -(-528 // 32) == 272
    assert split_slots(8, 1024, 2, H100_SMS) == 32      # a (B,) attend_len
    assert split_slots(32, 1024, 2, H100_SMS) == 128
    assert split_slots(1, 1, 1, H100_SMS) == SPLIT_TILE
    for B, depth, Hkv in ((1, 1024, 2), (32, 1024, 2), (64, 32768, 8),
                          (3, 1000, 1)):
        split = split_slots(B, depth, Hkv, H100_SMS)
        assert split % SPLIT_TILE == 0
        blocks = B * Hkv * -(-depth // split)
        assert blocks <= SPLIT_BLOCKS_PER_SM * H100_SMS + B * Hkv
