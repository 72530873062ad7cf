"""Attention: GQA / MHA self-attention (causal, sliding window), flash
prefill and paged single-token decode, and encoder-decoder
cross-attention.

Layout conventions, as in ``repro.nn.attention``:
  queries      (B, T, Hq, D)
  keys/values  (B, S, Hkv, D)     Hq % Hkv == 0 (GQA groups)

``flash_attention`` is the prefill and training path and
``decode_attention`` the single-token serving path; on CUDA tensors they are the hand-written
kernels of ``kernels/attention`` and ``kernels/decode_attention``, on CPU
tensors their plain versions.  Cross-attention (whisper) runs the same
two: ``flash_attention(causal=False)`` over the encoder's F frames for a
whole decoder sequence, ``decode_attention`` at attend_len = F for one
token.
"""
from __future__ import annotations

import math

import torch

from repro_torch import sharded

from repro_torch.kernels.attention.ops import flash_attention_op
from repro_torch.kernels.decode_attention.ops import decode_attention_op
from repro_torch.nn.linear import dense, dense_init
from repro_torch.nn.rope import apply_rope

NEG_INF = -1e30


# ------------------------------------------------------------ projections --
def attention_init(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv_heads: int, head_dim: int | None = None, *,
                   qkv_bias: bool = False, **place) -> dict:
    """``place``: the ``dtype`` / ``device`` keywords of ``dense_init``."""
    head_dim = head_dim or d_model // n_heads
    return {
        "wq": dense_init(gen, d_model, n_heads * head_dim, use_bias=qkv_bias,
                         **place),
        "wk": dense_init(gen, d_model, n_kv_heads * head_dim,
                         use_bias=qkv_bias, **place),
        "wv": dense_init(gen, d_model, n_kv_heads * head_dim,
                         use_bias=qkv_bias, **place),
        "wo": dense_init(gen, n_heads * head_dim, d_model, use_bias=False,
                         **place),
    }


def project_qkv(params, x, *, n_heads: int, n_kv_heads: int, head_dim: int):
    q = _heads(dense(params["wq"], x), n_heads, head_dim)
    k = _heads(dense(params["wk"], x), n_kv_heads, head_dim)
    v = _heads(dense(params["wv"], x), n_kv_heads, head_dim)
    return q, k, v


def merge_heads(t):
    """(B, T, H, D) -> (B, T, H * D).  For a DTensor the gradient's heads
    are gathered, as ``_heads`` gathers them, where its split does not
    divide them."""
    if sharded.is_dtensor(t) and torch.is_grad_enabled() and t.requires_grad:
        return _MergeHeads.apply(t)
    return t.reshape(t.shape[:-2] + (t.shape[-2] * t.shape[-1],))


class _MergeHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        ctx.shape = t.shape
        return t.reshape(t.shape[:-2] + (t.shape[-2] * t.shape[-1],))

    @staticmethod
    def backward(ctx, g):
        g = sharded.whole_groups(g, g.dim() - 1, ctx.shape[-2])
        return g.reshape(ctx.shape)


def _heads(t, n_heads: int, head_dim: int):
    """(B, T, H * D) -> (B, T, H, D).  A DTensor whose last axis is split
    where the split does not divide the heads (qwen2-0.5b's 14 heads of a
    16-way model axis) is gathered along it first, explicitly."""
    if sharded.is_dtensor(t):
        t = sharded.whole_groups(t, t.dim() - 1, n_heads)
    return t.reshape(t.shape[:-1] + (n_heads, head_dim))


# ------------------------------------------------------------------ cores --
def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, kv_valid_len=None):
    """Blocked attention; never materializes (T, S) on the card.

    q: (B, T, Hq, D), k/v: (B, S, Hkv, D).  q_offset: absolute position of
    q[0] relative to k[0].  kv_valid_len: optional (B,) count of valid keys
    per row; keys at or beyond it, and at or beyond S, never receive
    probability mass.  Returns (B, T, Hq, D) in q.dtype.  Where a gradient
    is taken on CUDA the kernel runs in
    ``kernels.attention.ops.FlashAttention``, whose backward is the
    backward kernel."""
    return flash_attention_op(q, k, v, causal=causal, window=window,
                              q_offset=q_offset, kv_valid_len=kv_valid_len)


def decode_attention(q, k_cache, v_cache, attend_len):
    """Single-step attention against a cache.

    q: (B, 1, Hq, D); k/v_cache: (B, S, Hkv, D); attend_len: an int or a
    () / (B,) tensor of valid cache slots per row.  Ring buffers pass
    attend_len == S once full; slot order does not matter because keys
    carry absolute RoPE phases.  Returns (B, 1, Hq, D)."""
    return decode_attention_op(q, k_cache, v_cache, attend_len)


# ----------------------------------------------------------- full layer ----
def attention_apply(params, x, *, n_heads: int, n_kv_heads: int,
                    head_dim: int, causal: bool = True, window: int = 0,
                    rope_theta: float = 10000.0, positions=None,
                    return_kv: bool = False, kv_valid_len=None):
    """Self-attention over x: (B, T, d_model).

    With return_kv, also returns the (roped) K/V tensors (B, T, Hkv, D) so
    prefill can fill a decode cache.  kv_valid_len (B,) masks right-padding
    keys out of every row (bucketed prefill)."""
    T = x.shape[1]
    q, k, v = project_qkv(params, x, n_heads=n_heads, n_kv_heads=n_kv_heads,
                          head_dim=head_dim)
    if positions is None:
        positions = torch.arange(T, device=x.device)[None, :]
    if rope_theta > 0:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    out = flash_attention(q, k, v, causal=causal, window=window,
                          kv_valid_len=kv_valid_len)
    y = dense(params["wo"], merge_heads(out))
    if return_kv:
        return y, k, v
    return y


def attention_decode_apply(params, x, k_cache, v_cache, cache_len, *,
                           n_heads: int, n_kv_heads: int, head_dim: int,
                           rope_theta: float = 10000.0):
    """One-token decode.  x: (B, 1, d_model); cache_len: an int (every row
    at one depth) or a (B,) tensor of tokens seen so far per row.

    The cache is a ring buffer of S slots: the new token's K/V are written
    at cache_len % S, IN PLACE into k_cache / v_cache, and attention covers
    min(cache_len + 1, S) slots.  Returns (out (B, 1, d_model), k_cache,
    v_cache), the caches being the tensors passed in."""
    B = x.shape[0]
    S = k_cache.shape[1]
    q, k, v = project_qkv(params, x, n_heads=n_heads, n_kv_heads=n_kv_heads,
                          head_dim=head_dim)
    per_row = isinstance(cache_len, torch.Tensor) and cache_len.dim() > 0
    if per_row:
        pos_b = cache_len.to(device=x.device, dtype=torch.long)[:, None]
    else:
        pos_b = torch.full((B, 1), int(cache_len), dtype=torch.long,
                           device=x.device)
    if rope_theta > 0:
        q = apply_rope(q, pos_b, rope_theta)
        k = apply_rope(k, pos_b, rope_theta)
    if per_row:
        slot = pos_b[:, 0] % S
        attend_len = torch.clamp(pos_b[:, 0] + 1, max=S)
    else:
        slot = int(cache_len) % S
        attend_len = min(int(cache_len) + 1, S)
    _put_slot(k_cache, slot, k[:, 0])
    _put_slot(v_cache, slot, v[:, 0])
    out = decode_attention(q, k_cache, v_cache, attend_len)
    out = dense(params["wo"], merge_heads(out))
    return out, k_cache, v_cache


def _put_slot(cache, slot, new) -> None:
    """cache[b, slot_b] = new[b] for every row b, IN PLACE; ``slot`` an int
    (every row's) or a (B,) tensor.  A DTensor cache is written on the
    blocks its ranks hold (DTensor has no sharding strategy for a write by
    index along a split axis, and a write into a gathered copy would be
    lost): each rank takes its rows and heads of ``new`` and writes the
    slots that fall in its block of the sequence, so a cache split along
    its slots is written by the one rank that holds the slot."""
    if sharded.is_dtensor(cache):
        from torch.distributed.tensor import Replicate, Shard

        mesh = cache.device_mesh
        place = [Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > 1
                 else p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in cache.placements]
        if not sharded.is_dtensor(new):
            new = sharded.wrap(new, mesh, [Replicate()] * mesh.ndim, new.shape)
        new = sharded.local_block(new, place)
        local = cache.to_local()
        size = local.shape[1]
        start = sharded.Group(mesh, sharded.split_dims(cache, 1)).index * size
        if isinstance(slot, int):
            if start <= slot < start + size:
                local[:, slot - start] = new.to(local.dtype)
            return
        at = sharded.local_rows(slot, cache) - start
        rows = torch.arange(local.shape[0], device=local.device)
        # the rows whose slot another rank holds write their own value back
        inside = ((at >= 0) & (at < size))[:, None, None]
        at = torch.clamp(at, 0, size - 1)
        local[rows, at] = torch.where(inside, new.to(local.dtype), local[rows, at])
        return
    if isinstance(slot, int):
        cache[:, slot] = new.to(cache.dtype)
        return
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, slot] = new.to(cache.dtype)


def cross_kv(params, enc_out, *, n_kv_heads: int, head_dim: int):
    """Cross-attention K/V of the encoder output (B, F, d): each
    (B, F, n_kv_heads, head_dim)."""
    k = _heads(dense(params["wk"], enc_out), n_kv_heads, head_dim)
    v = _heads(dense(params["wv"], enc_out), n_kv_heads, head_dim)
    return k, v


def cross_attention_apply(params, x, k, v, *, n_heads: int, head_dim: int):
    """Decoder queries x (B, T, d) against the encoder's K/V (B, F, H, D),
    no mask: flash attention with T != S, not causal."""
    q = _heads(dense(params["wq"], x), n_heads, head_dim)
    out = flash_attention(q, k, v, causal=False)
    return dense(params["wo"], merge_heads(out))


def cross_attention_decode(params, x, k, v, *, n_heads: int, head_dim: int):
    """One-token cross-attention: x (B, 1, d) against all F cached encoder
    K/V slots (decode attention at attend_len = F)."""
    q = _heads(dense(params["wq"], x), n_heads, head_dim)
    out = decode_attention(q, k, v, k.shape[1])
    return dense(params["wo"], merge_heads(out))


# ----------------------------------------------------------- references ----
def reference_attention(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0):
    """O(T*S)-memory oracle used by tests."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, T, Hkv, G, D)
    s = torch.einsum("bthgd,bshd->bhgts", qg.float(), k.float()) * scale
    q_pos = torch.arange(T, device=q.device) + q_offset
    k_pos = torch.arange(S, device=q.device)
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.where(mask, torch.softmax(s, dim=-1), 0.0)
    out = torch.einsum("bhgts,bshd->bthgd", p, v.float())
    return out.reshape(B, T, Hq, D).to(q.dtype)
