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

Under a mesh (a DTensor x) the cells compute on the params' placed blocks
(``launch/partition.py``: the mLSTM's q / k / v split their H * D
columns and ``out`` its rows over the model axis, ``wi`` / ``wf`` stand
replicated; the sLSTM's ``wx`` / ``wr`` split their 4 * d columns), and on
the decode state's blocks where ``cache_shardings`` puts them, as GSPMD
lowers the JAX package's cells; nothing is gathered whole but
activations.  A rank's work is plain tensors between the collectives:

  * mLSTM: the state C (B, H, D, D) splits its value axis (and n its key
    axis, as the cache does), so rank r computes the value columns
    [r D / k, (r + 1) D / k) of every head: q and k gathered (B, T, d),
    v's column block realigned to those columns by an all-to-all;
    ``mlstm_chunked`` then runs unchanged on them (its normaliser and
    den need only q, k and the gates; a decode step sums q . n over the
    key blocks, an all-reduce of (B, H)); the per-head GroupNorm takes its
    mean and variance from the ranks' partial sums (two all-reduces of
    (B, T, H)); the output is realigned back to ``out``'s row block and
    its product summed.  xlstm-350m's 4 heads on a 16-way axis split
    each head 4 ways; nothing here needs H to divide the axis.
  * sLSTM: ``wr`` mixes the whole h every token, so each token gathers h
    (B, d) and the rank's gate columns [i | f | z | o] of its block are
    realigned to its d / k channels by an all-to-all of (B, 4 d / k); the
    cell runs on those channels (the state splits d in the cache), and the
    GroupNorm on the gathered h.

The rank functions between the collectives (``_mlstm_rank_in``,
``mlstm_chunked``, ``_head_sums``, ``_value_norm``; ``_slstm_pre``,
``_slstm_update``) take plain tensors, so the k ranks' work can also be
run in turn on one device with the collectives done by hand
(chip_smoke.py's phase 21e does, at full width).
"""
from __future__ import annotations

import functools
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

    q, k, v: (B, T, H, D) (q scaled by the caller; v may hold a block of
    the value columns, (B, T, H, Dv)); log_i / log_f: (B, T, H).  Returns
    (y (B, T, H, Dv) float32, {"C" (B, H, D, Dv), "n", "m"}: the state
    after the last token)."""
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
    C = torch.zeros((B, H, D, v.shape[-1]), device=dev)
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


def _log_gates(params, x):
    """The input and forget gates (B, T, H) of x in log space, float32."""
    return dense(params["wi"], x).float(), F.logsigmoid(dense(params["wf"], x).float())


def _mlstm_gates(params, x, n_heads: int):
    """q (scaled by 1 / sqrt(D)), k, v (B, T, H, D) and the log gates
    (B, T, H) float32 of x (B, T, d)."""
    B, T, d_model = x.shape
    D = d_model // n_heads
    q = dense(params["wq"], x).reshape(B, T, n_heads, D) / math.sqrt(D)
    k = dense(params["wk"], x).reshape(B, T, n_heads, D)
    v = dense(params["wv"], x).reshape(B, T, n_heads, D)
    return (q, k, v) + _log_gates(params, x)


def mlstm_apply(params, x, *, n_heads: int, chunk: int = 64,
                return_state: bool = False):
    """x: (B, T, d) -> (B, T, d) [, the state after the last token]."""
    if sharded.is_dtensor(x):
        return _mlstm_meshed(params, x, None, n_heads=n_heads, chunk=chunk,
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
        return _mlstm_meshed(params, x, state, n_heads=n_heads)
    B, _, d_model = x.shape
    q, k, v, li, lf = _mlstm_gates(params, x, n_heads)
    y, state = _mlstm_step(q[:, 0], k[:, 0], v[:, 0], li[:, 0], lf[:, 0], state)
    y = groupnorm(params["norm"], y.reshape(B, 1, d_model).to(x.dtype), groups=n_heads)
    return dense(params["out"], y), state


def _mlstm_step(q, k, v, li, lf, state, *, key=None, total=None):
    """One token's update of the state {"C", "n", "m"} from q, k (B, H, D),
    v (B, H, Dv) and the log gates (B, H): (y (B, H, Dv) float32, the new
    state).  ``key`` (a slice) and ``total``: a rank's n holds those key
    columns only, and ``total`` sums q . n's partial products."""
    q, k, v = q.float(), k.float(), v.float()
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(lf + m, li)
    fg = torch.exp(lf + m - m_new)
    ig = torch.exp(li - m_new)
    C = fg[..., None, None] * C + ig[..., None, None] * (k[..., :, None] * v[..., None, :])
    qn, kn = (q, k) if key is None else (q[..., key], k[..., key])
    n = fg[..., None] * n + ig[..., None] * kn
    num = torch.einsum("bhd,bhde->bhe", q, C)
    dot = torch.einsum("bhd,bhd->bh", qn, n)
    den = torch.maximum(torch.abs(dot if total is None else total(dot)), torch.exp(-m_new))
    return num / den[..., None], {"C": C, "n": n, "m": m_new}


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
    pre = _slstm_pre(params["wr"], xw_t, h)
    return _slstm_update(torch.chunk(pre.float(), 4, dim=-1), c, n, m, xw_t.dtype)


def _slstm_pre(wr, xw_t, h):
    """The pre-activations xw_t + h wr of one token from the whole h (B, d):
    all four gates, or under a mesh a rank's block of their columns."""
    return xw_t + dense(wr, h)


def _slstm_update(gates, c, n, m, dtype):
    """The cell's update from its four pre-activations [i, f, z, o]
    (float32, each of c's shape): (h in ``dtype``, c, n, m)."""
    zi, zf, zz, zo = gates
    log_f = F.logsigmoid(zf)
    m_new = torch.maximum(log_f + m, zi)
    ig = torch.exp(zi - m_new)
    fg = torch.exp(log_f + m - m_new)
    c_new = fg * c + ig * torch.tanh(zz)
    n_new = fg * n + ig
    h_new = torch.sigmoid(zo) * c_new / torch.clamp(n_new, min=1e-6)
    return h_new.to(dtype), c_new, n_new, m_new


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
        return _slstm_meshed(params, x, None, n_heads=n_heads,
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
        return _slstm_meshed(params, x, state, n_heads=n_heads)
    h, new = slstm_step(params, x[:, 0], (state["h"], state["c"], state["n"], state["m"]))
    y = groupnorm(params["norm"], h[:, None, :], groups=n_heads)
    return y, dict(zip("hcnm", new))


# ---------------------------------------------------------------- meshed ---
def _mlstm_rank_in(w, gates, x):
    """A rank's work before the gathers: its column blocks of x's q, k and
    v products (B, T, H * D / k) and the log gates (B, T, H), whole
    (``wi`` / ``wf`` stand replicated)."""
    return (dense(w["wq"], x), dense(w["wk"], x), dense(w["wv"], x)) + _log_gates(gates, x)


def _head_sums(y, mu=None):
    """A rank's part of the per-head GroupNorm statistics of its block y
    (B, T, H, Dv) of each head's channels: their sum, or with ``mu`` the
    sum of their squared distances from it.  The ranks' parts add up to
    the head's."""
    y32 = y.float()
    return torch.sum(y32 if mu is None else (y32 - mu) ** 2, dim=-1, keepdim=True)


def _value_norm(norm, y, mu, var, eps: float = 1e-5):
    """``groupnorm`` of the block y from its heads' statistics; ``norm``
    holds the block's scale / bias (H, Dv)."""
    out = (y.float() - mu) * (var + eps) ** -0.5
    return (out * norm["scale"].float() + norm["bias"].float()).to(y.dtype)


def _value_block(t, n_heads: int, r: int, k: int):
    """Block r of k of each head's channels of t (..., H * D): (..., H, D / k)."""
    t = t.reshape(t.shape[:-1] + (n_heads, t.shape[-1] // n_heads))
    n = t.shape[-1] // k
    return t[..., r * n:(r + 1) * n]


def _mlstm_meshed(params, x, state, *, n_heads: int, chunk: int = 64,
                  return_state: bool = False):
    """``mlstm_apply`` (``state`` None) or ``mlstm_decode_apply`` of a
    DTensor x on params at their placements (the module docstring).
    Returns y as a DTensor at x's split of the rows [, the state as
    DTensors: in ``state``'s placements, or for a prefill the cache's]."""
    mesh = x.device_mesh
    place = sharded.keep_dims(x, {0})
    rows = sharded.split_dims(x, 0)
    group = sharded.layer_group(mesh, params["wq"]["w"], 1, rows)
    B, T, d = x.shape
    H, k = n_heads, group.size
    D = d // H
    if D % k:
        raise ValueError(f"the mLSTM's head width {D} does not split {k} ways")
    pb = functools.partial(sharded.param_block, group=group, rows=rows)
    w = {name: {"w": pb(params[name]["w"], axis=axis)}
         for name, axis in (("wq", 1), ("wk", 1), ("wv", 1), ("out", 0))}
    gates = {name: {key: pb(t, axis=None, share=True) for key, t in params[name].items()}
             for name in ("wi", "wf")}
    norm = {key: _value_block(pb(t, axis=None, share=True), H, group.index, k)
            for key, t in params["norm"].items()}
    xl = sharded.SumGrad.apply(sharded.local_block(x, place), group)
    Bl = xl.shape[0]
    qb, kb, vb, li, lf = _mlstm_rank_in(w, gates, xl)
    q = group.gather(qb, -1).reshape(Bl, T, H, D) / math.sqrt(D)
    kk = group.gather(kb, -1).reshape(Bl, T, H, D)
    v = group.realign(vb, H).permute(1, 2, 0, 3)                        # (B, T, H, Dv)
    if state is None:
        y, new = mlstm_chunked(q, kk, v, li, lf, chunk=chunk)
        n_blk = D // k
        new["n"] = new["n"][..., group.index * n_blk:(group.index + 1) * n_blk]
    else:
        old = {"C": sharded.state_block(state["C"], rows, group, 3),
               "n": sharded.state_block(state["n"], rows, group, 2),
               "m": sharded.state_block(state["m"], rows, group, None)}
        n_blk = old["n"].shape[-1]
        y, new = _mlstm_step(q[:, 0], kk[:, 0], v[:, 0], li[:, 0], lf[:, 0], old,
                             key=slice(group.index * n_blk, (group.index + 1) * n_blk),
                             total=lambda t: sharded.all_reduce(t, group))
        y = y[:, None]
    y = y.to(x.dtype)
    mu = sharded.all_reduce(_head_sums(y), group) / D
    y = _value_norm(norm, y, mu, sharded.all_reduce(_head_sums(y, mu), group) / D)
    y = group.unalign(y.permute(2, 0, 1, 3), H)                        # (B, T, d / k)
    out = dense(w["out"], y)
    out = sharded.wrap(sharded.reduce_out(out.float(), group).to(out.dtype), mesh, place,
                       x.shape)
    if state is None and not return_state:
        return out
    like = state or {"C": (B, H, D, D), "n": (B, H, D), "m": (B, H)}
    return out, {name: sharded.state_out(new[name], like[name], rows, group, axis)
                 for name, axis in (("C", 3), ("n", 2), ("m", None))}


def _slstm_meshed(params, x, state, *, n_heads: int, return_state: bool = False):
    """``slstm_apply`` (``state`` None) or ``slstm_decode_apply`` of a
    DTensor x on params at their placements (the module docstring)."""
    mesh = x.device_mesh
    place = sharded.keep_dims(x, {0})
    rows = sharded.split_dims(x, 0)
    group = sharded.layer_group(mesh, params["wr"]["w"], 1, rows)
    B, T, d = x.shape
    pb = functools.partial(sharded.param_block, group=group, rows=rows)
    wx = {"w": pb(params["wx"]["w"], axis=1), "b": pb(params["wx"]["b"], axis=0)}
    wr = {"w": pb(params["wr"]["w"], axis=1)}
    norm = {key: pb(t, axis=None) for key, t in params["norm"].items()}
    xl = sharded.SumGrad.apply(sharded.local_block(x, place), group)
    xw = dense(wx, xl)                                                  # (B, T, 4 d / k)
    if state is None:
        init = slstm_decode_init_state(xl.shape[0], d // group.size, x.dtype, device=xl.device)
        h_blk, c, n, m = (init[key] for key in "hcnm")
        h = torch.zeros((xl.shape[0], d), dtype=x.dtype, device=xl.device)
    else:
        h_blk, c, n, m = (sharded.state_block(state[key], rows, group, 1) for key in "hcnm")
        h = group.gather(h_blk, -1)
    hs = []
    for t in range(T):
        if t:
            h = group.gather(h_blk, -1)
        pre = group.realign(_slstm_pre(wr, xw[:, t], h), 4)
        h_blk, c, n, m = _slstm_update(pre.float().unbind(0), c, n, m, x.dtype)
        hs.append(h_blk)
    y = groupnorm(norm, group.gather(torch.stack(hs, dim=1), -1, whole_grad=True),
                  groups=n_heads)
    y = sharded.wrap(y, mesh, place, x.shape)
    if state is None and not return_state:
        return y
    like = state or dict.fromkeys("hcnm", (B, d))
    return y, {key: sharded.state_out(t, like[key], rows, group, 1)
               for key, t in zip("hcnm", (h_blk, c, n, m))}
