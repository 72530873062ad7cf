"""Plain PyTorch version of decode attention: the dense oracle of
``repro.kernels.decode_attention.ref`` (one fp32 einsum of the query
against the whole cache width, a masked softmax, a second einsum), with
one change: a row with attend_len = 0 gets 0.  The dense oracle's softmax
over scores that are all masked averages the whole cache there; the TPU
kernel (its ``_finish`` clamps l and keeps acc at 0), the port's kernel
and the port's ``flash_attention_ref`` all give 0 to a query with no live
key."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_attention_ref(q, k_cache, v_cache, attend_len):
    """q: (B, 1, Hq, D); k/v_cache: (B, S, Hkv, D); attend_len: an int or a
    () / (B,) tensor, the count of valid cache slots per row.  Returns
    (B, 1, Hq, D) in q.dtype; 0 on a row with attend_len = 0."""
    B, _, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, 1, Hkv, G, D)
    s = torch.einsum("bthgd,bshd->bhgts", qg.float(), k_cache.float()) * scale
    attend = torch.as_tensor(attend_len, device=q.device)
    slots = torch.arange(S, device=q.device)
    if attend.dim() == 0:
        valid = slots < attend
    else:
        valid = (slots[None, :] < attend[:, None])[:, None, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgts,bshd->bthgd", p, v_cache.float())
    live = attend > 0
    out = torch.where(live if live.dim() == 0 else live[:, None, None, None, None],
                      out, 0.0)
    return out.reshape(B, 1, Hq, D).to(q.dtype)
