"""The Mamba block (a selective state-space layer), the port of
``repro.nn.ssm`` as plain functions on tensors.

Training / prefill: ``in_proj`` splits into the SSM's input x and the
gate z; x runs through a depthwise causal conv (``d_conv`` taps, left pad
``d_conv - 1``) and SiLU, then gives the per-token SSM parameters
(``_ssm_params``: the step dt by softplus, B and C) and the selective scan
``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t``, ``y_t = C_t . h_t + D x_t``,
gated by SiLU(z) before ``out_proj``.

``mamba_scan`` is chunked, as the JAX package's: time is padded to a
multiple of ``chunk`` (dt = 0 in the pad, so the pad's decay is 1 and its
input 0, and the state after the last chunk is the state after the last
real token), each chunk's decays and inputs (B, Tc, d_inner, d_state) are
formed at once, and the state (B, d_inner, d_state) is carried from chunk
to chunk.  Within a chunk the recurrence is a plain sequential loop over
its Tc tokens (one multiply-add each), where JAX runs a log-step
``associative_scan``: the same sums in another order, so the two agree to
float32 rounding, and the port's chunked scan rounds as its own
one-token decode step does.

Decode carries (conv, ssm): the last ``d_conv - 1`` pre-conv inputs in
the model's dtype (zeros before the first token) and the SSM state in
float32.  ``dt_bias``, ``A_log`` and ``D`` are float32 whatever the
model's dtype, as in the JAX package.

Under a mesh (a DTensor x) the block computes on the params' placed
blocks (``launch/partition.py``: every param splits d_inner over the
model axis, ``in_proj`` its 2 * d_inner columns), as GSPMD lowers the JAX
package's layer: the scan is per channel, so each rank runs it on its
d_inner block.  A rank's work is ``_mix_in`` and ``_mix_out`` (and their
one-token forms) on plain tensors, with the collectives between them in
``_mamba_meshed``: ``in_proj``'s column block holds [x_in | z] columns of
other ranks' channels, so the projected activations are realigned by an
all-to-all (never the weight); ``x_proj``'s rows split, so its output is
summed (an all-reduce of (B, T, r + 2 * d_state)); ``out_proj``'s rows
split, so the output is too (both sums in float32, rounded once, as the
unsplit products accumulate).  The decode state's ``ssm`` leaf splits
d_state in the cache (``cache_shardings``' first dividing axis from the
end), so a step moves the rank's block to its d_inner channels and back
(an all-to-all each way of (B, d_inner / k, d_state / k) blocks, 1 MB a
layer at jamba's decode_32k, as against gathering dt and x_c and summing
y, 1.5 MB, plus ``A_log``); prefill writes it so once.  The rank
functions take plain tensors, so the k ranks' work can also be run in
turn on one device with the collectives done by hand (chip_smoke.py's
phase 21e does, at full width, on the blocks ``_blocks`` cuts).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import sharded
from repro_torch.nn.activations import silu
from repro_torch.nn.init import on_meta
from repro_torch.nn.linear import conv1d, conv1d_init, dense, dense_init


def _rank(d_model: int, dt_rank: int | None) -> int:
    return dt_rank or max(1, d_model // 16)


def mamba_init(gen: torch.Generator, d_model: int, *, expand: int = 2,
               d_state: int = 16, d_conv: int = 4, dt_rank: int | None = None,
               dtype=torch.float32, device=None) -> dict:
    """The block's weights: projections without bias in ``dtype``, the
    depthwise conv ``conv_w`` (d_inner, 1, d_conv) (JAX's is (d_conv, 1,
    d_inner)) he-normal over d_conv, ``conv_b`` zeros; in float32 the
    S4D-real ``A_log`` = log(1 .. d_state) on every channel, ``dt_bias``
    the inverse softplus of a step drawn uniform in [0.001, 0.1], and
    ``D`` ones."""
    d_inner = expand * d_model
    r = _rank(d_model, dt_rank)
    place = {"dtype": dtype, "device": device}
    f32 = {"dtype": torch.float32, "device": device or gen.device}
    p = {"in_proj": dense_init(gen, d_model, 2 * d_inner, use_bias=False, **place)}
    conv = conv1d_init(gen, d_inner, d_inner, d_conv, groups=d_inner, **place)
    p["conv_w"], p["conv_b"] = conv["w"], conv["b"]
    p["x_proj"] = dense_init(gen, d_inner, r + 2 * d_state, use_bias=False, **place)
    p["dt_proj"] = dense_init(gen, r, d_inner, use_bias=False, **place)
    if on_meta(device):
        p["dt_bias"] = torch.empty(d_inner, **f32)
    else:
        dt = 0.001 + 0.099 * torch.rand(d_inner, generator=gen, device=gen.device)
        p["dt_bias"] = torch.log(torch.expm1(dt)).to(**f32)
    p["A_log"] = torch.log(torch.arange(1, d_state + 1, **f32)).expand(
        d_inner, d_state).contiguous()
    p["D"] = torch.ones(d_inner, **f32)
    p["out_proj"] = dense_init(gen, d_inner, d_model, use_bias=False, **place)
    return p


def _ssm_params(params, proj, *, d_state: int, dt_rank: int):
    """Per-token SSM parameters from x_proj's output proj (B, T, r + 2 *
    d_state): dt (B, T, d_inner) (d_inner: dt_proj's columns), B and C
    (B, T, d_state), all float32."""
    dt_low, B_mat, C_mat = torch.split(proj, [dt_rank, d_state, d_state], dim=-1)
    z = dense(params["dt_proj"], dt_low).float() + params["dt_bias"]
    dt = torch.logaddexp(z, torch.zeros_like(z))   # JAX's softplus (F.softplus cuts off at 20)
    return dt, B_mat.float(), C_mat.float()


def mamba_scan(dt, A_log, B_mat, C_mat, x, h0, *, chunk: int = 128):
    """The chunked selective scan (the module docstring).  dt, x: (B, T,
    d_inner); A_log: (d_inner, d_state); B_mat, C_mat: (B, T, d_state);
    h0: (B, d_inner, d_state).  Returns y (B, T, d_inner) float32 and the
    final state."""
    Bsz, T, _ = x.shape
    Tc = min(chunk, T)
    pad = -(-T // Tc) * Tc - T

    def padt(a):
        return F.pad(a, (0, 0, 0, pad)) if pad else a

    dt_p, x_p, B_p, C_p = padt(dt), padt(x.float()), padt(B_mat), padt(C_mat)
    neg_A = -torch.exp(A_log)
    h, ys = h0, []
    for t0 in range(0, T + pad, Tc):
        sl = slice(t0, t0 + Tc)
        dA = torch.exp(dt_p[:, sl, :, None] * neg_A)                  # (B, Tc, di, ds)
        dBx = (dt_p[:, sl] * x_p[:, sl])[..., None] * B_p[:, sl, None, :]
        hs = []
        for t in range(Tc):
            h = torch.addcmul(dBx[:, t], dA[:, t], h)
            hs.append(h)
        ys.append(torch.einsum("btds,bts->btd", torch.stack(hs, 1), C_p[:, sl]))
    return torch.cat(ys, 1)[:, :T], h


def _mix_in(params, x_in, *, d_conv: int):
    """A rank's work before x_proj's sum: the padded pre-conv input, the
    post-conv activations x_c and x_proj's product (a partial sum over the
    ranks that split d_inner) of x_in (B, T, d_inner), d_inner the rank's
    channels."""
    x_pad = F.pad(x_in, (0, 0, d_conv - 1, 0))
    x_c = silu(conv1d({"w": params["conv_w"], "b": params["conv_b"]}, x_pad,
                      padding="VALID", groups=x_in.shape[-1]))
    return x_pad, x_c, dense(params["x_proj"], x_c)


def _mix_out(params, x_c, z, proj, *, d_state: int, dt_rank: int, chunk: int):
    """A rank's work after x_proj's sum: the scan of its channels and
    out_proj's product (a partial sum, as ``_mix_in``'s).  Returns (the
    product, the final state (B, d_inner, d_state))."""
    dt, B_mat, C_mat = _ssm_params(params, proj, d_state=d_state, dt_rank=dt_rank)
    h0 = torch.zeros((x_c.shape[0], x_c.shape[-1], d_state), dtype=torch.float32,
                     device=x_c.device)
    y, h_final = mamba_scan(dt, params["A_log"], B_mat, C_mat, x_c, h0, chunk=chunk)
    y = y + params["D"] * x_c.float()
    return dense(params["out_proj"], y.to(z.dtype) * silu(z)), h_final


def mamba_apply(params, x, *, d_state: int = 16, d_conv: int = 4,
                dt_rank: int | None = None, chunk: int = 128,
                return_state: bool = False):
    """The block over a sequence x (B, T, d_model).  With ``return_state``
    also the decode state after the last token: {"conv": the last d_conv -
    1 pre-conv inputs (B, d_conv - 1, d_inner), zeros where T is shorter,
    "ssm": (B, d_inner, d_state) float32}."""
    kw = {"d_state": d_state, "dt_rank": _rank(x.shape[-1], dt_rank)}
    if sharded.is_dtensor(x):
        return _mamba_meshed(params, x, None, d_conv=d_conv, chunk=chunk,
                             return_state=return_state, **kw)
    x_in, z = dense(params["in_proj"], x).chunk(2, dim=-1)
    x_pad, x_c, proj = _mix_in(params, x_in, d_conv=d_conv)
    out, h_final = _mix_out(params, x_c, z, proj, chunk=chunk, **kw)
    if return_state:
        return out, {"conv": x_pad[:, x.shape[1]:], "ssm": h_final}
    return out


def mamba_decode_init_state(batch: int, d_inner: int, d_state: int, d_conv: int,
                            dtype=torch.float32, *, device=None) -> dict:
    return {"conv": torch.zeros((batch, d_conv - 1, d_inner), dtype=dtype, device=device),
            "ssm": torch.zeros((batch, d_inner, d_state), dtype=torch.float32,
                               device=device)}


def _step_in(params, x_in, conv):
    """``_mix_in`` of one token x_in (B, 1, d_inner) from the conv state:
    (the conv buffer (B, d_conv, d_inner), x_c (B, 1, d_inner), x_proj's
    partial product)."""
    conv_buf = torch.cat([conv, x_in], dim=1)
    x_c = torch.einsum("bkd,dk->bd", conv_buf, params["conv_w"][:, 0, :]) + params["conv_b"]
    x_c = silu(x_c)[:, None, :]
    return conv_buf, x_c, dense(params["x_proj"], x_c)


def _step_out(params, x_c, z, proj, h, *, d_state: int, dt_rank: int):
    """``_mix_out`` of one token from the SSM state h (B, d_inner,
    d_state): (out_proj's partial product, the new state)."""
    dt, B_mat, C_mat = _ssm_params(params, proj, d_state=d_state, dt_rank=dt_rank)
    dA = torch.exp(dt[:, 0, :, None] * -torch.exp(params["A_log"]))
    dBx = (dt[:, 0] * x_c[:, 0].float())[..., None] * B_mat[:, 0, None, :]
    h = torch.addcmul(dBx, dA, h)
    y = torch.einsum("bds,bs->bd", h, C_mat[:, 0]) + params["D"] * x_c[:, 0].float()
    return dense(params["out_proj"], y[:, None, :].to(z.dtype) * silu(z)), h


def mamba_decode_apply(params, x, state, *, d_state: int = 16, d_conv: int = 4,
                       dt_rank: int | None = None):
    """One token x (B, 1, d_model) from ``state``.  Returns (y (B, 1,
    d_model), the new state)."""
    kw = {"d_state": d_state, "dt_rank": _rank(x.shape[-1], dt_rank)}
    if sharded.is_dtensor(x):
        return _mamba_meshed(params, x, state, d_conv=d_conv, **kw)
    x_in, z = dense(params["in_proj"], x).chunk(2, dim=-1)          # (B, 1, di)
    conv_buf, x_c, proj = _step_in(params, x_in, state["conv"])
    out, h = _step_out(params, x_c, z, proj, state["ssm"], **kw)
    return out, {"conv": conv_buf[:, 1:], "ssm": h}


def mamba_reference(params, x, *, d_state: int = 16, d_conv: int = 4,
                    dt_rank: int | None = None):
    """The sequential oracle: ``mamba_decode_apply`` over every token of x
    (B, T, d_model) from the empty state."""
    B, T, _ = x.shape
    state = mamba_decode_init_state(B, params["conv_b"].shape[0], d_state, d_conv,
                                    dtype=x.dtype, device=x.device)
    ys = []
    for t in range(T):
        y, state = mamba_decode_apply(params, x[:, t:t + 1], state, d_state=d_state,
                                      d_conv=d_conv, dt_rank=dt_rank)
        ys.append(y)
    return torch.cat(ys, 1)


# ---------------------------------------------------------------- meshed ---
# d_inner axis of each param (port layout; ``in_proj`` splits its 2 *
# d_inner columns)
_CHANNEL_AXIS = {"in_proj": 1, "conv_w": 0, "conv_b": 0, "x_proj": 0, "dt_proj": 1,
                 "dt_bias": 0, "A_log": 0, "D": 0, "out_proj": 0}


def _weight(params, name):
    return params[name]["w"] if isinstance(params[name], dict) else params[name]


def _blocks(params, cut):
    """The params with each leaf (a dense's ``w`` for the projections) as
    ``cut(leaf, its d_inner axis)``."""
    out = {}
    for name, axis in _CHANNEL_AXIS.items():
        leaf = cut(_weight(params, name), axis)
        out[name] = {"w": leaf} if isinstance(params[name], dict) else leaf
    return out


def _total(proj, group):
    """x_proj's partial products summed over ``group`` in float32 (an
    all-reduce), rounded once to their dtype: the unsplit product's
    float32 accumulation."""
    return sharded.all_reduce(proj.float(), group).to(proj.dtype)


def _mamba_meshed(params, x, state, *, d_state: int, d_conv: int, dt_rank: int,
                  chunk: int = 128, return_state: bool = False):
    """``mamba_apply`` (``state`` None) or ``mamba_decode_apply`` of a
    DTensor x on params at their placements (the module docstring): each
    rank's rows of x, its d_inner block of every param (FSDP's data-axis
    splits gathered), the state's blocks moved to its channels and back.
    Returns y as a DTensor at x's split of the rows (replicated
    elsewhere) [, the state as DTensors: in ``state``'s placements, or
    for a prefill the cache's (``sharded.state_out``)]."""
    mesh = x.device_mesh
    place = sharded.keep_dims(x, {0})
    rows = sharded.split_dims(x, 0)
    group = sharded.layer_group(mesh, params["conv_b"], 0, rows)

    pl = _blocks(params, lambda t, axis: sharded.param_block(t, group, axis, rows))
    xl = sharded.SumGrad.apply(sharded.local_block(x, place), group)
    x_in, z = group.realign(dense(pl["in_proj"], xl), 2)
    kw = {"d_state": d_state, "dt_rank": dt_rank}
    if state is None:
        x_pad, x_c, proj = _mix_in(pl, x_in, d_conv=d_conv)
        out, h = _mix_out(pl, x_c, z, _total(proj, group), chunk=chunk, **kw)
        conv = x_pad[:, x.shape[1]:]
    else:
        conv_l = sharded.state_block(state["conv"], rows, group, 2)
        h_l = sharded.state_block(state["ssm"], rows, group, 1)
        conv_buf, x_c, proj = _step_in(pl, x_in, conv_l)
        out, h = _step_out(pl, x_c, z, _total(proj, group), h_l, **kw)
        conv = conv_buf[:, 1:]
    y = sharded.reduce_out(out.float(), group).to(out.dtype)
    y = sharded.wrap(y, mesh, place, x.shape)
    if state is None and not return_state:
        return y
    B, di = x.shape[0], params["conv_b"].shape[0]
    like = state or {"conv": (B, d_conv - 1, di), "ssm": (B, di, d_state)}
    new = {"conv": sharded.state_out(conv, like["conv"], rows, group, 2),
           "ssm": sharded.state_out(h, like["ssm"], rows, group, 1)}
    return y, new
