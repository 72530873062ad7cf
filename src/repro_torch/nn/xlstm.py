"""xLSTM cells: the mLSTM (matrix memory) and the sLSTM (scalar memory),
the port of ``repro.nn.xlstm`` as plain functions on tensors.

The mLSTM's full-sequence path is chunkwise parallel: within a chunk of
``chunk`` tokens a quadratic form weighted by the exponential gates' decay,
across chunks a recurrent matrix state C (B, H, D, D) with its normaliser
n (B, H, D) and stabiliser m (B, H), carried by a loop over the chunks.
The gates live in log space (cumulative sums of log forget gates, a
running max stabiliser), and the normaliser's denominator is floored by
exp(-m).  ``mlstm_sequential`` is its token-by-token oracle.

The fills are the JAX package's, kept exactly: a padded tail takes
log_i = -1e30 (no input) and log_f = 0 (keep the state); the chunked
path's initial m is -1e30, the oracle's -inf; the intra-chunk mask is -inf
before the exp.  ``den`` floored by exp(-m) can overflow to inf and zero a
row, as it does there.

The sLSTM mixes its state through a recurrent weight, so it runs one token
at a time; its input projection is one product over the whole sequence
before the loop.  h is kept in x's dtype, c, n and m in float32.

The GroupNorm after each cell is ``nn/norm.py::groupnorm``: per token,
over each head's channels.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import sharded
from repro_torch.nn.linear import dense, dense_init
from repro_torch.nn.norm import groupnorm, groupnorm_init

# the chunked path's "minus infinity": finite, so that m - m stays 0
NEG = -1e30


# ================================================================= mLSTM ===
def mlstm_init(gen: torch.Generator, d_model: int, n_heads: int, **place) -> dict:
    """q / k / v / out projections (d, d) without bias, the input and
    forget gates (d, H) with bias (the forget gate's + 3.0: it starts near
    remembering), and the GroupNorm; ``place``: ``dtype`` / ``device``."""
    p = {
        "wq": dense_init(gen, d_model, d_model, use_bias=False, **place),
        "wk": dense_init(gen, d_model, d_model, use_bias=False, **place),
        "wv": dense_init(gen, d_model, d_model, use_bias=False, **place),
        "wi": dense_init(gen, d_model, n_heads, **place),
        "wf": dense_init(gen, d_model, n_heads, **place),
        "out": dense_init(gen, d_model, d_model, use_bias=False, **place),
        "norm": groupnorm_init(d_model, **place),
    }
    p["wf"]["b"] = p["wf"]["b"] + 3.0
    return p


def mlstm_sequential(q, k, v, log_i, log_f):
    """The oracle, one token at a time.  q, k, v: (B, T, H, D); the gates
    (B, T, H) in log space.  Returns (B, T, H, D) float32."""
    B, T, H, D = q.shape
    dev = q.device
    C = torch.zeros((B, H, D, D), device=dev)
    n = torch.zeros((B, H, D), device=dev)
    m = torch.full((B, H), -math.inf, device=dev)
    ys = []
    for t in range(T):
        qt, kt, vt = q[:, t].float(), k[:, t].float(), v[:, t].float()
        lf, li = log_f[:, t], log_i[:, t]
        m_new = torch.maximum(lf + m, li)
        fg = torch.exp(lf + m - m_new)
        ig = torch.exp(li - m_new)
        C = fg[..., None, None] * C + ig[..., None, None] * (kt[..., :, None] * vt[..., None, :])
        n = fg[..., None] * n + ig[..., None] * kt
        m = m_new
        num = torch.einsum("bhd,bhde->bhe", qt, C)
        den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", qt, n)), torch.exp(-m))
        ys.append(num / den[..., None])
    return torch.stack(ys, dim=1)


def _pad_time(a, pad: int, fill: float = 0.0):
    """a (B, T, ...) with ``pad`` positions of ``fill`` after T."""
    if pad == 0:
        return a
    tail = torch.full((a.shape[0], pad) + a.shape[2:], fill, dtype=a.dtype,
                      device=a.device)
    return torch.cat([a, tail], dim=1)


def mlstm_chunked(q, k, v, log_i, log_f, *, chunk: int = 64):
    """The chunkwise-parallel mLSTM, ``mlstm_sequential``'s function.

    q, k, v: (B, T, H, D) (q scaled by the caller); log_i / log_f: (B, T,
    H).  Returns (y (B, T, H, D) float32, {"C", "n", "m"}: the state after
    the last token)."""
    B, T, H, D = q.shape
    Tc = min(chunk, T)
    n_chunks = -(-T // Tc)
    pad = n_chunks * Tc - T
    qf = _pad_time(q.float(), pad)
    kf = _pad_time(k.float(), pad)
    vf = _pad_time(v.float(), pad)
    lif = _pad_time(log_i, pad, NEG)        # no input from the padded tail
    lff = _pad_time(log_f, pad, 0.0)        # and no decay: the state is kept
    dev = q.device
    tri = torch.ones((Tc, Tc), dtype=torch.bool, device=dev).tril()[None, :, :, None]
    C = torch.zeros((B, H, D, D), device=dev)
    n = torch.zeros((B, H, D), device=dev)
    m = torch.full((B, H), NEG, device=dev)
    ys = []
    for c in range(n_chunks):
        sl = slice(c * Tc, (c + 1) * Tc)
        qt, kt, vt, li, lf = qf[:, sl], kf[:, sl], vf[:, sl], lif[:, sl], lff[:, sl]
        lf_cum = torch.cumsum(lf, dim=1)                    # inclusive
        # log weight of the pair (t, s <= t): lf_cum[t] - lf_cum[s] + li[s]
        a_t = lf_cum                                        # (B, Tc, H)
        b_s = li - lf_cum
        m_loc = a_t + torch.cummax(b_s, dim=1).values       # in-chunk stabiliser
        m_inter = m[:, None, :] + a_t                       # the carried state's
        m_tot = torch.maximum(m_loc, m_inter)

        logw = a_t[:, :, None, :] + b_s[:, None, :, :]      # (B, t, s, H)
        logw = torch.where(tri, logw, -math.inf)
        w = torch.exp(logw - m_tot[:, :, None, :])
        scores = torch.einsum("bthd,bshd->btsh", qt, kt)
        weighted = scores * w
        num = torch.einsum("btsh,bshd->bthd", weighted, vt)
        den = torch.sum(weighted, dim=2)                    # (B, t, H)

        cross_w = torch.exp(m_inter - m_tot)
        num = num + cross_w[..., None] * torch.einsum("bthd,bhde->bthe", qt, C)
        den = den + cross_w * torch.einsum("bthd,bhd->bth", qt, n)
        ys.append(num / torch.maximum(torch.abs(den), torch.exp(-m_tot))[..., None])

        a_last = lf_cum[:, -1]                              # (B, H) total decay
        m_new = torch.maximum(m + a_last,
                              torch.amax(b_s + a_last[:, None], dim=1))
        w_state = torch.exp(b_s + a_last[:, None] - m_new[:, None])   # (B, Tc, H)
        decay = torch.exp(m + a_last - m_new)
        # the JAX package's three-operand einsum bth,bthd,bthe->bhde, with
        # the gate weight taken into k first
        C = decay[:, :, None, None] * C + torch.einsum(
            "bthd,bthe->bhde", w_state[..., None] * kt, vt)
        n = decay[..., None] * n + torch.einsum("bth,bthd->bhd", w_state, kt)
        m = m_new
    y = torch.cat(ys, dim=1)[:, :T]
    return y, {"C": C, "n": n, "m": m}


def _mlstm_gates(params, x, n_heads: int):
    """q (scaled by 1 / sqrt(D)), k, v (B, T, H, D) and the log gates
    (B, T, H) float32 of x (B, T, d)."""
    B, T, d_model = x.shape
    D = d_model // n_heads
    q = dense(params["wq"], x).reshape(B, T, n_heads, D) / math.sqrt(D)
    k = dense(params["wk"], x).reshape(B, T, n_heads, D)
    v = dense(params["wv"], x).reshape(B, T, n_heads, D)
    log_i = dense(params["wi"], x).float()
    log_f = F.logsigmoid(dense(params["wf"], x).float())
    return q, k, v, log_i, log_f


def mlstm_apply(params, x, *, n_heads: int, chunk: int = 64,
                return_state: bool = False):
    """x: (B, T, d) -> (B, T, d) [, the state after the last token]."""
    if sharded.is_dtensor(x):
        # the recurrence runs on plain tensors (DTensor has no sharding
        # strategy for its loop's writes), params gathered, over each
        # rank's rows (rows are independent)
        return sharded.run_local(mlstm_apply, params, x, n_heads=n_heads, chunk=chunk,
                                 return_state=return_state)
    B, T, d_model = x.shape
    y, state = mlstm_chunked(*_mlstm_gates(params, x, n_heads), chunk=chunk)
    y = groupnorm(params["norm"], y.reshape(B, T, d_model).to(x.dtype), groups=n_heads)
    out = dense(params["out"], y)
    return (out, state) if return_state else out


def mlstm_decode_init_state(batch: int, n_heads: int, head_dim: int, *,
                            device=None) -> dict:
    return {"C": torch.zeros((batch, n_heads, head_dim, head_dim), device=device),
            "n": torch.zeros((batch, n_heads, head_dim), device=device),
            "m": torch.full((batch, n_heads), NEG, device=device)}


def mlstm_decode_apply(params, x, state, *, n_heads: int):
    """One token: x (B, 1, d) -> (y (B, 1, d), the new state)."""
    if sharded.is_dtensor(x):
        # the recurrence runs on plain tensors (DTensor has no sharding
        # strategy for its loop's writes), params gathered, over each
        # rank's rows (rows are independent)
        return sharded.run_local(mlstm_decode_apply, params, x, state, n_heads=n_heads)
    B, _, d_model = x.shape
    q, k, v, li, lf = _mlstm_gates(params, x, n_heads)
    q, k, v = q[:, 0].float(), k[:, 0].float(), v[:, 0].float()
    li, lf = li[:, 0], lf[:, 0]
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(lf + m, li)
    fg = torch.exp(lf + m - m_new)
    ig = torch.exp(li - m_new)
    C = fg[..., None, None] * C + ig[..., None, None] * (k[..., :, None] * v[..., None, :])
    n = fg[..., None] * n + ig[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", q, n)), torch.exp(-m_new))
    y = (num / den[..., None]).reshape(B, 1, d_model).to(x.dtype)
    y = groupnorm(params["norm"], y, groups=n_heads)
    return dense(params["out"], y), {"C": C, "n": n, "m": m_new}


# ================================================================= sLSTM ===
def slstm_init(gen: torch.Generator, d_model: int, n_heads: int, **place) -> dict:
    """The input projection of the gates i, f, z, o (d, 4d) with bias, the
    recurrent one (d, 4d) normal of std 1 / sqrt(d) without, and the
    GroupNorm."""
    return {
        "wx": dense_init(gen, d_model, 4 * d_model, **place),
        "wr": dense_init(gen, d_model, 4 * d_model, use_bias=False,
                         std=1.0 / math.sqrt(d_model), **place),
        "norm": groupnorm_init(d_model, **place),
    }


def _slstm_cell(params, xw_t, state):
    """One step from the token's input projection xw_t (B, 4d) and the
    state (h, c, n, m).  Returns the new state; h in xw_t's dtype."""
    h, c, n, m = state
    pre = xw_t + dense(params["wr"], h)
    zi, zf, zz, zo = torch.chunk(pre.float(), 4, dim=-1)
    log_f = F.logsigmoid(zf)
    m_new = torch.maximum(log_f + m, zi)
    ig = torch.exp(zi - m_new)
    fg = torch.exp(log_f + m - m_new)
    c_new = fg * c + ig * torch.tanh(zz)
    n_new = fg * n + ig
    h_new = torch.sigmoid(zo) * c_new / torch.clamp(n_new, min=1e-6)
    return h_new.to(xw_t.dtype), c_new, n_new, m_new


def slstm_step(params, xt, state):
    """xt: (B, d); state (h, c, n, m), each (B, d).  Returns (h, the new
    state)."""
    new = _slstm_cell(params, dense(params["wx"], xt), state)
    return new[0], new


def slstm_decode_init_state(batch: int, d_model: int, dtype=torch.float32, *,
                            device=None) -> dict:
    return {"h": torch.zeros((batch, d_model), dtype=dtype, device=device),
            "c": torch.zeros((batch, d_model), device=device),
            "n": torch.zeros((batch, d_model), device=device),
            "m": torch.full((batch, d_model), NEG, device=device)}


def slstm_apply(params, x, *, n_heads: int, return_state: bool = False):
    """x: (B, T, d) -> (B, T, d) [, the state after the last token], one
    token at a time."""
    if sharded.is_dtensor(x):
        # the recurrence runs on plain tensors (DTensor has no sharding
        # strategy for its loop's writes), params gathered, over each
        # rank's rows (rows are independent)
        return sharded.run_local(slstm_apply, params, x, n_heads=n_heads,
                                 return_state=return_state)
    B, T, d_model = x.shape
    init = slstm_decode_init_state(B, d_model, x.dtype, device=x.device)
    state = (init["h"], init["c"], init["n"], init["m"])
    xw = dense(params["wx"], x)
    hs = []
    for t in range(T):
        state = _slstm_cell(params, xw[:, t], state)
        hs.append(state[0])
    y = groupnorm(params["norm"], torch.stack(hs, dim=1), groups=n_heads)
    if return_state:
        return y, dict(zip("hcnm", state))
    return y


def slstm_decode_apply(params, x, state, *, n_heads: int):
    """One token: x (B, 1, d) -> (y (B, 1, d), the new state)."""
    if sharded.is_dtensor(x):
        # the recurrence runs on plain tensors (DTensor has no sharding
        # strategy for its loop's writes), params gathered, over each
        # rank's rows (rows are independent)
        return sharded.run_local(slstm_decode_apply, params, x, state, n_heads=n_heads)
    h, new = slstm_step(params, x[:, 0], (state["h"], state["c"], state["n"], state["m"]))
    y = groupnorm(params["norm"], h[:, None, :], groups=n_heads)
    return y, dict(zip("hcnm", new))
