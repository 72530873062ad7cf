"""Plain PyTorch version of flash attention: the math of the jnp
``repro.nn.attention.flash_attention`` (an online softmax over key blocks
of ``kv_block``), with one change: keys at or past S are masked whatever
the masking mode.  The jnp function pads keys to a whole block and masks
the pad only under causal masking, so with ``causal=False`` and S past one
block and not a multiple of it, its padded zero keys take softmax mass.

Its gradient, ``flash_attention_backward_ref``, is autograd of that
function (fp32 inside, gradients in the inputs' dtype, as the JAX model's
autodiff); ``flash_attention_backward_bf16_emulated`` repeats the bf16
backward kernel's rounding, for the tests."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import round_up

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0, kv_valid_len=None,
                        kv_block: int = 1024, return_lse: bool = False):
    """q: (B, T, Hq, D); k/v: (B, S, Hkv, D); kv_valid_len: optional (B,)
    count of live keys per row.  Returns (B, T, Hq, D) in q.dtype; a query
    row with no live key gets 0.  With ``return_lse`` also each row's
    log-sum-exp of its scaled live scores, (B, Hq, T) float32, -inf for a
    row with no live key (what the kernel writes for its backward)."""
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
    out = out.reshape(B, T, Hq, D).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(m <= NEG_INF / 2, float("-inf"), m + torch.log(l))
    return out, lse.reshape(B, Hq, T)


def flash_attention_backward_ref(q, k, v, o, do, lse, *, causal: bool = True,
                                 window: int = 0, q_offset: int = 0,
                                 kv_valid_len=None):
    """(dq, dk, dv): autograd of ``flash_attention_ref(q, k, v, causal=,
    window=, q_offset=, kv_valid_len=)`` against do, in the kernel's
    signature (o and lse, which the kernel reads, are not needed here)."""
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        out = flash_attention_ref(qq, kk, vv, causal=causal, window=window,
                                  q_offset=q_offset, kv_valid_len=kv_valid_len)
        return torch.autograd.grad(out, (qq, kk, vv), do)


def flash_attention_backward_bf16_emulated(q, k, v, o, do, lse, *,
                                           causal: bool = True, window: int = 0,
                                           q_offset: int = 0, kv_valid_len=None):
    """The bf16 backward kernel's rounding (csrc/flash_attention_backward_bf16.cu)
    in plain torch, on bf16 q, k, v, o, do and the forward's float32 lse:
    S = Q.K^T and dP = dO.V^T of the widened inputs in float32, P =
    exp(S scale - lse) (0 on masked keys and on rows whose lse is -inf),
    dvec = rowsum(dO * O), dS = P (dP - dvec), then P and dS rounded to
    bf16 before dV = P^T dO, dK = scale dS^T Q and dQ = scale dS K, each
    summed in float32 and rounded to bf16 once.  Dense over (T, S); the
    kernel sums by tiles, in another order."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    qf, dof, of = (t.float().transpose(1, 2) for t in (q, do, o))   # (B, Hq, T, D)
    kf, vf = (t.float().repeat_interleave(G, 2).transpose(1, 2) for t in (k, v))
    qp = torch.arange(T, device=dev)[:, None] + q_offset
    kp = torch.arange(S, device=dev)[None, :]
    live = torch.ones(T, S, dtype=torch.bool, device=dev)
    if causal:
        live = live & (kp <= qp)
    if window > 0:
        live = live & (kp > qp - window)
    live = live[None, None]
    if kv_valid_len is not None:
        live = live & (kp < kv_valid_len.to(dev)[:, None, None, None])
    lse = torch.where(torch.isinf(lse), float("inf"), lse.float())[..., None]
    s = qf @ kf.transpose(-1, -2)
    p = torch.where(live, torch.exp(s * scale - lse), 0.0)
    dp = dof @ vf.transpose(-1, -2)
    ds = p * (dp - (dof * of).sum(-1, keepdim=True))
    pb, dsb = p.to(torch.bfloat16).float(), ds.to(torch.bfloat16).float()
    dq = scale * (dsb @ kf)
    dk = scale * (dsb.transpose(-1, -2) @ qf)
    dv = pb.transpose(-1, -2) @ dof

    def kv_sum(t):    # (B, Hq, S, D) -> (B, S, Hkv, D), the GQA sum
        return t.reshape(B, Hkv, G, S, D).sum(2).transpose(1, 2)

    return (dq.transpose(1, 2).to(q.dtype), kv_sum(dk).to(k.dtype),
            kv_sum(dv).to(v.dtype))
