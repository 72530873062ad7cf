"""The port's LLM kernels on the CPU: the plain PyTorch versions of
RMSNorm, flash attention and paged decode attention (what ``ops.py`` runs
for CPU tensors) held against the JAX package's oracles, its jnp paths
and, where it runs here, its Pallas kernel in interpret mode."""
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
