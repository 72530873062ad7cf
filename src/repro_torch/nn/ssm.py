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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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


def _ssm_params(params, x_in, *, d_state: int, dt_rank: int):
    """Per-token SSM parameters of the post-conv activations x_in (B, T,
    d_inner): dt (B, T, d_inner), B and C (B, T, d_state), all float32."""
    proj = dense(params["x_proj"], x_in)
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


def mamba_apply(params, x, *, d_state: int = 16, d_conv: int = 4,
                dt_rank: int | None = None, chunk: int = 128,
                return_state: bool = False):
    """The block over a sequence x (B, T, d_model).  With ``return_state``
    also the decode state after the last token: {"conv": the last d_conv -
    1 pre-conv inputs (B, d_conv - 1, d_inner), zeros where T is shorter,
    "ssm": (B, d_inner, d_state) float32}."""
    B, T, d_model = x.shape
    d_inner = params["conv_b"].shape[0]
    r = _rank(d_model, dt_rank)
    x_in, z = dense(params["in_proj"], x).chunk(2, dim=-1)
    x_pad = F.pad(x_in, (0, 0, d_conv - 1, 0))
    x_c = silu(conv1d({"w": params["conv_w"], "b": params["conv_b"]}, x_pad,
                      padding="VALID", groups=d_inner))
    dt, B_mat, C_mat = _ssm_params(params, x_c, d_state=d_state, dt_rank=r)
    h0 = torch.zeros((B, d_inner, d_state), dtype=torch.float32, device=x.device)
    y, h_final = mamba_scan(dt, params["A_log"], B_mat, C_mat, x_c, h0, chunk=chunk)
    y = y + params["D"] * x_c.float()
    out = dense(params["out_proj"], y.to(x.dtype) * silu(z))
    if return_state:
        return out, {"conv": x_pad[:, T:], "ssm": h_final}
    return out


def mamba_decode_init_state(batch: int, d_inner: int, d_state: int, d_conv: int,
                            dtype=torch.float32, *, device=None) -> dict:
    return {"conv": torch.zeros((batch, d_conv - 1, d_inner), dtype=dtype, device=device),
            "ssm": torch.zeros((batch, d_inner, d_state), dtype=torch.float32,
                               device=device)}


def mamba_decode_apply(params, x, state, *, d_state: int = 16, d_conv: int = 4,
                       dt_rank: int | None = None):
    """One token x (B, 1, d_model) from ``state``.  Returns (y (B, 1,
    d_model), the new state)."""
    r = _rank(x.shape[-1], dt_rank)
    x_in, z = dense(params["in_proj"], x).chunk(2, dim=-1)          # (B, 1, di)
    conv_buf = torch.cat([state["conv"], x_in], dim=1)               # (B, d_conv, di)
    x_c = torch.einsum("bkd,dk->bd", conv_buf, params["conv_w"][:, 0, :]) + params["conv_b"]
    x_c = silu(x_c)[:, None, :]
    dt, B_mat, C_mat = _ssm_params(params, x_c, d_state=d_state, dt_rank=r)
    dA = torch.exp(dt[:, 0, :, None] * -torch.exp(params["A_log"]))
    dBx = (dt[:, 0] * x_c[:, 0].float())[..., None] * B_mat[:, 0, None, :]
    h = torch.addcmul(dBx, dA, state["ssm"])
    y = torch.einsum("bds,bs->bd", h, C_mat[:, 0]) + params["D"] * x_c[:, 0].float()
    out = dense(params["out_proj"], y[:, None, :].to(x.dtype) * silu(z))
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
