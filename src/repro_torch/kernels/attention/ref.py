"""Plain PyTorch version of flash attention: the math of the jnp
``repro.nn.attention.flash_attention`` (an online softmax over key blocks
of ``kv_block``), with one change: keys at or past S are masked whatever
the masking mode.  The jnp function pads keys to a whole block and masks
the pad only under causal masking, so with ``causal=False`` and S past one
block and not a multiple of it, its padded zero keys take softmax mass."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import round_up

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0, kv_valid_len=None,
                        kv_block: int = 1024):
    """q: (B, T, Hq, D); k/v: (B, S, Hkv, D); kv_valid_len: optional (B,)
    count of live keys per row.  Returns (B, T, Hq, D) in q.dtype; a query
    row with no live key gets 0."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    kb = min(kv_block, S)
    Sp = round_up(S, kb)
    kp = F.pad(k.float(), (0, 0, 0, 0, 0, Sp - S))
    vp = F.pad(v.float(), (0, 0, 0, 0, 0, Sp - S))
    qg = q.float().reshape(B, T, Hkv, G, D)
    q_pos = torch.arange(T, device=dev) + q_offset
    m = torch.full((B, Hkv, G, T), NEG_INF, device=dev)
    l = torch.zeros((B, Hkv, G, T), device=dev)
    acc = torch.zeros((B, T, Hkv, G, D), device=dev)
    for s0 in range(0, Sp, kb):
        k_pos = torch.arange(s0, s0 + kb, device=dev)
        s = torch.einsum("bthgd,bshd->bhgts", qg, kp[:, s0:s0 + kb]) * scale
        mask = (k_pos < S)[None, :].expand(T, kb)
        if causal:
            mask = mask & (q_pos[:, None] >= k_pos[None, :])
        if window > 0:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
        if kv_valid_len is not None:
            mask = mask[None] & (k_pos[None, None, :]
                                 < kv_valid_len.to(dev)[:, None, None])
            mask = mask[:, None, None]                    # (B, 1, 1, T, kb)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
        p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
        corr = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - m_safe))
        l = corr * l + p.sum(dim=-1)
        pv = torch.einsum("bhgts,bshd->bthgd", p, vp[:, s0:s0 + kb])
        acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-20).permute(0, 3, 1, 2)[..., None]
    return out.reshape(B, T, Hq, D).to(q.dtype)
