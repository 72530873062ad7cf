"""Decoder backbones: ArchConfig -> init / training loss / prefill /
decode.

The port of ``repro.models.backbone`` for the dense archs (qwen2,
llama3.2), the MoE archs (moonshot-v1-16b-a3b, mixtral-8x7b,
arctic-480b), the VLM (internvl2-1b), the enc-dec (whisper-tiny), the
xLSTM (xlstm-350m) and the Mamba hybrid (jamba-1.5-large-398b):

- dense: every layer is RMSNorm -> causal GQA self-attention with RoPE ->
  residual, RMSNorm -> SwiGLU FFN -> residual, and a final RMSNorm before
  the (tied) readout.
- MoE: the dense layer with the FFN replaced by ``nn/moe.py``'s top-k
  experts (plus arctic's parallel dense residual FFN and moonshot's
  always-on shared expert, added to the experts' output).  Training uses
  the config's capacity factor; ``prefill`` and ``decode_step`` use the
  inference capacity (E / k when E <= 8, else min(4, E / k)), which drops
  slots only where the JAX package's drops them.  The aux losses
  (``load_balance_loss``, ``dropped_fraction``) are averaged over the MoE
  layers; ``forward_loss`` adds 0.01 x the load-balance loss.
- VLM: the dense LM, with the batch's stubbed patch embeddings (B, P,
  vision_dim) projected by ``vision_proj`` and put in front of the token
  embeddings; their labels are -100.
- enc-dec: an encoder over the batch's stubbed frame embeddings (B, F, d)
  plus sinusoidal positions (LayerNorm -> non-causal self-attention,
  LayerNorm -> GELU MLP), and a decoder whose layers add cross-attention
  to the encoder's output between the causal self-attention and the MLP;
  the decoder's token embeddings carry sinusoidal positions too.
- xLSTM: superblocks of ``cfg.xlstm.period`` layers, each RMSNorm -> an
  mLSTM cell (``nn/xlstm.py``) -> residual, except the sLSTM cell at
  ``slstm_index``; no FFN sublayer (``ffn == "none"``), an untied readout.
- hybrid: superblocks of ``cfg.hybrid.period`` layers, each RMSNorm -> a
  Mamba block (``nn/ssm.py``) -> residual, except the attention layer at
  ``attn_index``, then RMSNorm -> an FFN -> residual: MoE where ``j %
  moe.every == every - 1``, dense SwiGLU elsewhere.

A superblock is ``sublayer_specs(cfg)``: one spec {"kind", "ffn"} per
layer of it (one layer for every arch but the xLSTM and the hybrid);
layer i takes spec ``i % cfg.superblock``.  Where the JAX package stacks
the superblocks on a leading axis and scans them, the port keeps
``params["blocks"]`` (and the enc-dec ``params["encoder"]``) as a Python
list of per-layer dicts, layer ``s * superblock + j`` being sublayer j of
superblock s, and loops over it.

The decode cache of an attention arch is ``{"k", "v"}``, each one (L, B,
S, Hkv, D) tensor whose ``[i]`` slice is attention layer i's contiguous
ring of S slots; an enc-dec cache adds ``{"ck", "cv"}``, each (L, B, F,
H, D), the cross-attention K/V of the encoder's output.  The recurrent
layers' states sit in the JAX package's per-kind tensors, (n_superblocks,
layers of the kind in a superblock, B, ...): an xLSTM's ``mlstm_C`` (..,
H, D, D), ``mlstm_n`` (.., H, D) and ``mlstm_m`` (.., H) in float32,
``slstm_h`` (.., d) in the model's dtype and ``slstm_c`` / ``_n`` / ``_m``
(.., d) in float32, the m's filled with -1e30 before the first token; a
hybrid's ``mamba_conv`` (.., d_conv - 1, d_inner) in the model's dtype and
``mamba_ssm`` (.., d_inner, d_state) in float32, beside the K/V of its
attention layers (one per superblock: L = n_superblocks).
``decode_step`` writes into the cache IN PLACE and returns the same dict
(the JAX package returns new arrays).
``prefill(long_context=True)`` runs a full-attention arch as a sliding
window of ``cfg.long_context_window`` tokens, in prefill and in a ring
cache of that many slots (an xLSTM has no attention to window and a
hybrid keeps its whole context, as in the JAX package: both ignore it).

``forward_loss`` is the training forward (mean next-token cross-entropy
by ``chunked_cross_entropy``) and ``forward_hidden`` the final hidden
states.  Under a gradient each layer runs in a non-reentrant
``torch.utils.checkpoint`` (``remat=True``, the default), as the JAX
package ``jax.checkpoint``s each superblock: its activations are
recomputed in the backward, so its flash-attention and RMSNorm forwards
run twice per training step; ``remat=False`` keeps them, with bitwise the
same loss and gradients (an MoE layer's recompute routes its tokens as the
first pass did: the routing is a function of the layer's input alone).
The JAX package checkpoints whole superblocks; per layer, the arithmetic
is the same.
On CUDA those forwards and their backward kernels run in the model's
dtype, float32 or bf16.

``prefill_chunk`` advances a chunked prefill by one segment of tokens
(the continuous scheduler's staged admissions), writing the segment's
K/V into the cache in place as ``decode_step`` does.

Parameters are drawn in ``cfg.dtype`` (bfloat16 for the MoE archs at full
size), each on its way to the device before the next is drawn.  A bf16
model follows the JAX package's casts: norms, the router and the MoE
combine in float32, K/V kept in a bf16 cache, logits in float32.
"""
from __future__ import annotations

import functools
import math
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.nn.activations import mlp, mlp_init, swiglu_ffn, swiglu_ffn_init
from repro_torch.nn.attention import (
    attention_apply,
    attention_decode_apply,
    attention_init,
    cross_attention_apply,
    cross_attention_decode,
    cross_kv,
    flash_attention,
    project_qkv,
)
from repro_torch.nn.linear import dense, dense_init, embedding, embedding_init
from repro_torch.nn.moe import moe_apply, moe_init
from repro_torch.nn.norm import layernorm, layernorm_init, rmsnorm, rmsnorm_init
from repro_torch.nn.rope import apply_rope
from repro_torch.nn.ssm import mamba_apply, mamba_decode_apply, mamba_init
from repro_torch.nn.xlstm import (
    NEG,
    mlstm_apply,
    mlstm_decode_apply,
    mlstm_init,
    slstm_apply,
    slstm_decode_apply,
    slstm_init,
)

# the recurrent layers' decode state: their names, in the cache's keys
_CELL_STATE = {"mlstm": "Cnm", "slstm": "hcnm", "mamba": ("conv", "ssm")}


def sublayer_specs(cfg: ArchConfig) -> list[dict]:
    """Per-sublayer spec {"kind", "ffn"} of one superblock: a dense or MoE
    arch (and the VLM and enc-dec decoders) has one attention sublayer,
    with a dense FFN or, under ``cfg.moe``, an MoE FFN; an xLSTM's
    superblock has ``period`` cells, the sLSTM at ``slstm_index`` and
    mLSTMs elsewhere, with no FFN; a hybrid's has ``period`` layers,
    attention at ``attn_index`` and Mamba elsewhere, each with an MoE FFN
    where ``j % moe.every == every - 1`` and a dense one elsewhere."""
    if cfg.xlstm is not None:
        return [{"kind": "slstm" if j == cfg.xlstm.slstm_index else "mlstm",
                 "ffn": "none"} for j in range(cfg.superblock)]
    if cfg.hybrid is not None:
        m = cfg.moe
        return [{"kind": "attn" if j == cfg.hybrid.attn_index else "mamba",
                 "ffn": "moe" if m is not None and j % m.every == m.every - 1
                 else "dense"} for j in range(cfg.superblock)]
    return [{"kind": "attn", "ffn": "moe" if cfg.moe is not None else "dense"}]


def _mamba_kwargs(cfg: ArchConfig) -> dict:
    return {"d_state": cfg.hybrid.d_state, "d_conv": cfg.hybrid.d_conv}


def _layer_slots(cfg: ArchConfig) -> list[tuple[dict, tuple]]:
    """(spec, cache index) of each layer: an attention layer's index is
    its ordinal among the attention layers ((a,) into the (L, ...) K/V
    ring), a cell's (superblock, ordinal among its kind in the superblock)
    into the per-kind state tensors."""
    specs = sublayer_specs(cfg)
    out, n_attn = [], 0
    for i in range(cfg.n_layers):
        s, j = divmod(i, len(specs))
        spec = specs[j]
        if spec["kind"] == "attn":
            out.append((spec, (n_attn,)))
            n_attn += 1
        else:
            same = sum(1 for sp in specs[:j] if sp["kind"] == spec["kind"])
            out.append((spec, (s, same)))
    return out


# --------------------------------------------------------------- helpers ---
def _norm_init(cfg: ArchConfig, **place) -> dict:
    return (rmsnorm_init(cfg.d_model, **place) if cfg.norm == "rmsnorm"
            else layernorm_init(cfg.d_model, **place))


def _norm(cfg: ArchConfig, p, x):
    return rmsnorm(p, x) if cfg.norm == "rmsnorm" else layernorm(p, x)


def _ffn(cfg: ArchConfig, p, x):
    """The dense FFN: whisper's GELU MLP under LayerNorm configs, SwiGLU
    otherwise."""
    return mlp(p, x) if cfg.norm == "layernorm" else swiglu_ffn(p, x)


def _f32(c: float) -> float:
    return torch.tensor(c, dtype=torch.float32).item()


# Cephes' expf (the range reduction by ln 2 in two parts, a degree-5
# polynomial), which XLA:CPU emits for a float32 exp, with its multiply-adds
# fused.  torch.exp rounds differently in about 1 of 10 entries of a
# position table's frequencies.
_EXP_LN2 = tuple(_f32(c) for c in (0.693359375, -2.12194440e-4))
_EXP_POLY = tuple(_f32(c) for c in (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
                                    4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1))


def exp_f32(x):
    """exp of a float32 tensor, bit for bit the JAX package's on the CPU
    (XLA's Cephes expf with fused multiply-adds).  Each fused step runs in
    float64, whose 53 bits hold the float32 product exactly, and rounds to
    float32 once; tested over every frequency of d <= 2,048 and 200,001
    points of [-80, 80]."""
    def fma(a, b, c):
        return (a.double() * b + c).float()

    x = torch.clamp(x.float(), -88.3762626647949, 88.3762626647950)
    n = torch.floor(x * 1.44269504088896341 + 0.5)
    for c in _EXP_LN2:
        x = fma(n, -c, x.double())
    y = torch.full_like(x, _EXP_POLY[0])
    for c in _EXP_POLY[1:]:
        y = fma(y, x.double(), c)
    y = fma(y, (x * x).double(), x.double()) + 1.0
    return y * torch.exp2(n)


@functools.lru_cache(maxsize=None)
def _frequencies(d: int, device: torch.device):
    """(d / 2,) float32 frequencies of a d-wide position table, computed
    once per width and device (do not write to the result)."""
    return exp_f32(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                   * (-math.log(10000.0) / d))


def sinusoidal_positions(T: int, d: int, offset: int = 0, *, device=None):
    """(T, d) float32 sinusoidal position table of positions offset ..
    offset + T - 1: sin in the even columns, cos in the odd.

    The frequencies come from ``exp_f32``, bitwise the JAX package's:
    torch.exp differs from XLA:CPU's float32 exp by one ulp in some of
    them, which the positions scale (about 1e-4 at 1,500 frames)."""
    device = torch.device("cpu") if device is None else torch.device(device)
    pos = (torch.arange(T, device=device) + offset)[:, None].float()
    angle = pos * _frequencies(d, device)
    return torch.stack((torch.sin(angle), torch.cos(angle)), dim=-1).reshape(T, d)


# ------------------------------------------------------------------ init ---
def _init_layer(cfg: ArchConfig, spec: dict, gen: torch.Generator,
                **place) -> dict:
    p = {"norm": _norm_init(cfg, **place)}
    if spec["kind"] == "mlstm":
        p["cell"] = mlstm_init(gen, cfg.d_model, cfg.n_heads, **place)
    elif spec["kind"] == "slstm":
        p["cell"] = slstm_init(gen, cfg.d_model, cfg.n_heads, **place)
    elif spec["kind"] == "mamba":
        h = cfg.hybrid
        p["mamba"] = mamba_init(gen, cfg.d_model, expand=h.expand, d_state=h.d_state,
                                d_conv=h.d_conv, **place)
    else:
        p["attn"] = attention_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.resolved_head_dim, qkv_bias=cfg.qkv_bias,
                                   **place)
    if spec["ffn"] == "none":
        return p
    p["ffn_norm"] = _norm_init(cfg, **place)
    if spec["ffn"] == "dense":
        ffn_init = mlp_init if cfg.norm == "layernorm" else swiglu_ffn_init
        p["ffn"] = ffn_init(gen, cfg.d_model, cfg.d_ff, **place)
        return p
    m = cfg.moe
    p["moe"] = moe_init(gen, cfg.d_model, m.expert_d_ff, m.n_experts, **place)
    if m.dense_residual_ff:
        p["dense_res"] = swiglu_ffn_init(gen, cfg.d_model, m.dense_residual_ff,
                                         **place)
    if m.shared_expert_ff:
        p["shared"] = swiglu_ffn_init(gen, cfg.d_model, m.shared_expert_ff,
                                      **place)
    return p


def _init_encoder_layer(cfg: ArchConfig, gen: torch.Generator, **place) -> dict:
    return {
        "norm": _norm_init(cfg, **place),
        "attn": attention_init(gen, cfg.d_model, cfg.n_heads, cfg.n_heads,
                               cfg.resolved_head_dim, **place),
        "ffn_norm": _norm_init(cfg, **place),
        "ffn": mlp_init(gen, cfg.d_model, cfg.d_ff, **place),
    }


def _init_decoder_layer_encdec(cfg: ArchConfig, gen: torch.Generator,
                               **place) -> dict:
    return {
        "norm": _norm_init(cfg, **place),
        "attn": attention_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.resolved_head_dim, **place),
        "cross_norm": _norm_init(cfg, **place),
        "cross": attention_init(gen, cfg.d_model, cfg.n_heads, cfg.n_heads,
                                cfg.resolved_head_dim, **place),
        "ffn_norm": _norm_init(cfg, **place),
        "ffn": mlp_init(gen, cfg.d_model, cfg.d_ff, **place),
    }


def init_params(cfg: ArchConfig, seed: int = 0, *, device=None,
                gen_device="cpu") -> dict:
    """Fresh parameters from ``seed`` in ``cfg.dtype`` on ``device`` (CUDA
    by default; raises when CUDA is absent and no device was named).

    Each tensor is drawn in float32 by a generator on ``gen_device``,
    cast to ``cfg.dtype`` and moved to ``device`` before the next is drawn.
    The CPU generator (the default) gives the same weights on any device;
    ``gen_device="cuda"`` draws on the card, other numbers for the same
    seed, without the minutes the CPU takes over a full-size MoE (28.9 B
    values for moonshot-v1-16b-a3b).  The draws differ from the JAX
    package's for the same seed: bridge JAX weights with
    ``repro_torch.bridge.backbone_params_from_numpy`` to compare."""
    slots = _layer_slots(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=gen_device).manual_seed(seed)
    place = {"dtype": cfg.dtype, "device": device}
    params: dict[str, Any] = {
        "embed": embedding_init(gen, cfg.vocab, cfg.d_model, **place),
        "final_norm": _norm_init(cfg, **place),
    }
    if cfg.encdec is not None:
        params["encoder"] = [_init_encoder_layer(cfg, gen, **place)
                             for _ in range(cfg.encdec.n_encoder_layers)]
        params["enc_final_norm"] = _norm_init(cfg, **place)
        params["blocks"] = [_init_decoder_layer_encdec(cfg, gen, **place)
                            for _ in range(cfg.n_layers)]
    else:
        params["blocks"] = [_init_layer(cfg, spec, gen, **place)
                            for spec, _ in slots]
    if cfg.vlm is not None:
        params["vision_proj"] = dense_init(gen, cfg.vlm.vision_dim, cfg.d_model,
                                           **place)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab,
                                       use_bias=False, **place)
    return params


# --------------------------------------------------------------- forward ---
def _apply_ffn(cfg: ArchConfig, spec: dict, p, x, *, dropless: bool = False):
    """The post-mixer FFN sublayer with its residual.  Returns (x, aux):
    aux is {} for a dense FFN or none (x passes through), else the MoE
    layer's aux.  ``dropless`` (inference) sizes the MoE capacity as the
    JAX package does: E / k (provably dropless) when E <= 8, else min(4,
    E / k); training keeps the configured capacity factor."""
    if spec["ffn"] == "none":
        return x, {}
    h = _norm(cfg, p["ffn_norm"], x)
    if spec["ffn"] == "dense":
        return x + _ffn(cfg, p["ffn"], h), {}
    m = cfg.moe
    if dropless:
        e_over_k = m.n_experts / m.top_k
        cap = e_over_k if m.n_experts <= 8 else min(4.0, e_over_k)
    else:
        cap = m.capacity_factor
    y, aux = moe_apply(p["moe"], h, top_k=m.top_k, capacity_factor=cap)
    if "dense_res" in p:
        y = y + swiglu_ffn(p["dense_res"], h)
    if "shared" in p:
        y = y + swiglu_ffn(p["shared"], h)
    return x + y, aux


def _apply_sublayer(cfg: ArchConfig, spec: dict, p, x, *, window: int,
                    dropless: bool = False, kv_valid_len=None):
    """Full-sequence (training / prefill) layer.  Returns (x, its decode
    state, aux): (k, v) of an attention layer, a cell's or a Mamba block's
    state dict after the last token."""
    h = _norm(cfg, p["norm"], x)
    if spec["kind"] == "mamba":
        y, state = mamba_apply(p["mamba"], h, return_state=True, **_mamba_kwargs(cfg))
    elif spec["kind"] == "mlstm":
        y, state = mlstm_apply(p["cell"], h, n_heads=cfg.n_heads, return_state=True)
    elif spec["kind"] == "slstm":
        y, state = slstm_apply(p["cell"], h, n_heads=cfg.n_heads, return_state=True)
    else:
        y, k, v = attention_apply(
            p["attn"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim, causal=True, window=window,
            rope_theta=cfg.rope_theta, return_kv=True, kv_valid_len=kv_valid_len)
        state = (k, v)
    x, aux = _apply_ffn(cfg, spec, p, x + y, dropless=dropless)
    return x, state, aux


def _zero_aux(device) -> dict:
    return {"load_balance_loss": torch.zeros((), device=device),
            "dropped_fraction": torch.zeros((), device=device)}


def _acc_aux(acc: dict, aux: dict, n: int) -> dict:
    """acc plus a layer's MoE aux over n, the MoE layer count (a dense
    layer's empty aux adds nothing)."""
    if not aux:
        return acc
    return {k: acc[k] + aux[k] / n for k in acc}


def _moe_layer_count(cfg: ArchConfig) -> int:
    return sum(1 for s in sublayer_specs(cfg) if s["ffn"] == "moe") * cfg.n_superblocks or 1


def _layer_loop(layers, x, body, remat: bool, *args):
    """x through ``body(p, x, *args) -> x`` for each layer dict of
    ``layers``; each in a non-reentrant checkpoint under a gradient when
    ``remat``."""
    for p in layers:
        if remat and torch.is_grad_enabled():
            x = checkpoint(body, p, x, *args, use_reentrant=False)
        else:
            x = body(p, x, *args)
    return x


def _run_layers(cfg: ArchConfig, params, x, *, window: int, remat: bool = True):
    """Every layer over x (B, T, d), layer i by spec ``i % superblock``.
    Returns (x, aux), aux the MoE aux losses averaged over the MoE layers
    (zeros for an arch without)."""
    specs = sublayer_specs(cfg)
    n_moe = _moe_layer_count(cfg)

    def body(p, h, j):
        h, _, aux = _apply_sublayer(cfg, specs[j], p, h, window=window)
        return h, aux

    acc = _zero_aux(x.device)
    for i, p in enumerate(params["blocks"]):
        j = i % len(specs)
        if remat and torch.is_grad_enabled():
            x, aux = checkpoint(body, p, x, j, use_reentrant=False)
        else:
            x, aux = body(p, x, j)
        acc = _acc_aux(acc, aux, n_moe)
    return x, acc


def _encoder_layer(cfg: ArchConfig, p, h):
    a = _norm(cfg, p["norm"], h)
    h = h + attention_apply(p["attn"], a, n_heads=cfg.n_heads,
                            n_kv_heads=cfg.n_heads, head_dim=cfg.resolved_head_dim,
                            causal=False, rope_theta=0.0)
    return h + mlp(p["ffn"], _norm(cfg, p["ffn_norm"], h))


def _run_encoder(cfg: ArchConfig, params, frames, *, remat: bool = True):
    """Whisper-style encoder over the stubbed frame embeddings (B, F, d)."""
    x = frames.to(cfg.dtype)
    x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                 device=x.device).to(x.dtype)
    x = _layer_loop(params["encoder"], x,
                    lambda p, h: _encoder_layer(cfg, p, h), remat)
    return _norm(cfg, params["enc_final_norm"], x)


def _decoder_layer_encdec(cfg: ArchConfig, p, h, enc_out):
    """One enc-dec decoder layer over the full sequence.  Returns (h, its
    cache entries k, v, ck, cv)."""
    hd = cfg.resolved_head_dim
    a = _norm(cfg, p["norm"], h)
    sa, k, v = attention_apply(p["attn"], a, n_heads=cfg.n_heads,
                               n_kv_heads=cfg.n_kv_heads, head_dim=hd,
                               causal=True, rope_theta=0.0, return_kv=True)
    h = h + sa
    c = _norm(cfg, p["cross_norm"], h)
    ck, cv = cross_kv(p["cross"], enc_out, n_kv_heads=cfg.n_heads, head_dim=hd)
    h = h + cross_attention_apply(p["cross"], c, ck, cv, n_heads=cfg.n_heads,
                                  head_dim=hd)
    h = h + mlp(p["ffn"], _norm(cfg, p["ffn_norm"], h))
    return h, (k, v, ck, cv)


def _run_decoder_encdec(cfg: ArchConfig, params, x, enc_out, *,
                        remat: bool = True):
    """Whisper-style decoder over the full sequence x (B, T, d)."""
    return _layer_loop(params["blocks"], x, lambda p, h, e: _decoder_layer_encdec(
        cfg, p, h, e)[0], remat, enc_out)


def _hidden(cfg: ArchConfig, params, batch, *, window: int, remat: bool):
    """Final hidden states before the final norm, the labels (VLM: padded
    with -100 over the patches) and the MoE aux losses."""
    x, labels = _embed_inputs(cfg, params, batch)
    if cfg.encdec is not None:
        enc_out = _run_encoder(cfg, params, _batch_tensor(params, batch, "frames"),
                               remat=remat)
        x = _run_decoder_encdec(cfg, params, x, enc_out, remat=remat)
        return x, labels, _zero_aux(x.device)
    x, aux = _run_layers(cfg, params, x, window=window, remat=remat)
    return x, labels, aux


def _readout_weight(cfg: ArchConfig, params):
    if cfg.tie_embeddings:
        return params["embed"]["table"].T          # (d, V)
    return params["lm_head"]["w"]


def _logits(cfg: ArchConfig, params, last):
    """last: (B, d) final-normed hidden states -> (B, vocab) float32."""
    return last.float() @ _readout_weight(cfg, params).float()


# -------------------------------------------------------------- training ---
def _chunk_ce(xc, w_vocab, lc, ignore_label: int):
    """(sum of the chunk's CE over its labelled tokens, their count)."""
    logits = xc.float() @ w_vocab.float()
    logz = torch.logsumexp(logits, dim=-1)
    # the gold logit by gather: JAX's one-hot sum adds exact zeros to it
    gold = torch.gather(logits, -1, torch.clamp(lc, min=0)[..., None])[..., 0]
    mask = (lc != ignore_label).float()
    return torch.sum((logz - gold) * mask), torch.sum(mask)


def chunked_cross_entropy(x, w_vocab, labels, *, chunk: int = 512,
                          ignore_label: int = -100):
    """Mean CE over the labelled tokens without keeping (B, T, V) logits:
    one chunk of ``chunk`` positions at a time (the last may be shorter),
    each chunk in a checkpoint under a gradient, so its logits are
    recomputed in the backward and never held past their chunk.

    x: (B, T, d); w_vocab: (d, V); labels: (B, T) integers, positions
    labelled ``ignore_label`` count for nothing."""
    B, T, _ = x.shape
    labels = labels.long()
    Tc = min(chunk, T)
    loss_sum = x.new_zeros((), dtype=torch.float32)
    cnt = x.new_zeros((), dtype=torch.float32)
    for t0 in range(0, T, Tc):
        args = (x[:, t0:t0 + Tc], w_vocab, labels[:, t0:t0 + Tc], ignore_label)
        if torch.is_grad_enabled():
            s, c = checkpoint(_chunk_ce, *args, use_reentrant=False)
        else:
            s, c = _chunk_ce(*args)
        loss_sum, cnt = loss_sum + s, cnt + c
    return loss_sum / torch.clamp(cnt, min=1.0)


def _check_batch(cfg: ArchConfig, batch) -> None:
    """Refuse keys the config does not take: "patches" belong to a VLM,
    "frames" to an enc-dec (which needs them)."""
    allowed = {"tokens", "labels"}
    allowed |= {"patches"} if cfg.vlm is not None else set()
    allowed |= {"frames"} if cfg.encdec is not None else set()
    extra = sorted(set(batch) - allowed)
    if extra:
        raise ValueError(f"{cfg.name} does not take {extra} (its batch keys: "
                         f"{sorted(allowed)})")
    if cfg.encdec is not None and "frames" not in batch:
        raise ValueError(f"{cfg.name}: an enc-dec batch needs its \"frames\"")


def _batch_tensor(params, batch, key: str):
    return torch.as_tensor(batch[key], device=params["embed"]["table"].device)


def _embed_inputs(cfg: ArchConfig, params, batch):
    """(x (B, T, d), labels or None) of a batch: {"tokens": (B, T)
    [, "labels": (B, T)] [, "patches": (B, P, vision_dim)] [, "frames":
    (B, F, d)]}, tensors or numpy arrays, moved to the params' device.  A
    VLM puts the projected patches in front of the tokens (labels -100
    there); a config without RoPE adds sinusoidal positions."""
    _check_batch(cfg, batch)
    x = embedding(params["embed"], _batch_tensor(params, batch, "tokens").long())
    labels = batch.get("labels")
    if labels is not None:
        labels = _batch_tensor(params, batch, "labels").long()
    if cfg.vlm is not None and "patches" in batch:
        pv = dense(params["vision_proj"],
                   _batch_tensor(params, batch, "patches").to(cfg.dtype))
        x = torch.cat([pv, x], dim=1)
        if labels is not None:
            pad = torch.full(pv.shape[:2], -100, dtype=labels.dtype,
                             device=labels.device)
            labels = torch.cat([pad, labels], dim=1)
    if cfg.rope_theta == 0:                 # sinusoidal positions (whisper)
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                     device=x.device).to(x.dtype)
    return x, labels


def forward_loss(cfg: ArchConfig, params, batch, *, window: int = 0,
                 loss_chunk: int = 512, remat: bool = True):
    """Training forward: mean next-token CE, plus 0.01 x the MoE
    load-balance loss for an MoE arch (at the config's capacity factor).
    Returns (loss, metrics) with JAX's metric keys (ce and the MoE aux
    losses, zeros for a dense arch).

    batch: {"tokens": (B, T), "labels": (B, T)} [+ "patches" (VLM) /
    "frames" (enc-dec)]."""
    x, labels, aux = _hidden(cfg, params, batch,
                             window=window or cfg.sliding_window, remat=remat)
    x = _norm(cfg, params["final_norm"], x)
    ce = chunked_cross_entropy(x, _readout_weight(cfg, params), labels,
                               chunk=loss_chunk)
    loss = ce + 0.01 * aux["load_balance_loss"] if cfg.moe is not None else ce
    return loss, {"ce": ce, **aux}


def forward_hidden(cfg: ArchConfig, params, batch, *, window: int = 0,
                   remat: bool = True):
    """Final hidden states (B, T, d): AgileNN's remote path."""
    x, _, _ = _hidden(cfg, params, batch, window=window or cfg.sliding_window,
                      remat=remat)
    return _norm(cfg, params["final_norm"], x)


# ------------------------------------------------------------- decoding ----
def cache_window(cfg: ArchConfig, context_len: int, *,
                 long_context: bool = False) -> int:
    """KV ring-buffer capacity for a decode context of `context_len`: the
    native sliding window, else with ``long_context`` (full-attention
    archs switch to a sliding window at 500k tokens; hybrid and xLSTM
    archs do not) the ``long_context_window``, else the whole context."""
    if cfg.sliding_window:
        return min(cfg.sliding_window, context_len)
    if long_context and cfg.hybrid is None and cfg.xlstm is None:
        return min(cfg.long_context_window, context_len)
    return context_len


def _cell_cache(cfg: ArchConfig, batch: int, device, alloc) -> dict:
    """The recurrent layers' state tensors (the module docstring's
    shapes), each made by ``alloc(shape, dtype, fill)``."""
    specs = sublayer_specs(cfg)
    n_sb, H, hd, d = cfg.n_superblocks, cfg.n_heads, cfg.resolved_head_dim, cfg.d_model
    f32 = torch.float32
    shapes = {"mlstm": {"C": ((H, hd, hd), f32), "n": ((H, hd), f32), "m": ((H,), f32)},
              "slstm": {"h": ((d,), cfg.dtype), "c": ((d,), f32), "n": ((d,), f32),
                        "m": ((d,), f32)}}
    if cfg.hybrid is not None:
        hy = cfg.hybrid
        d_inner = hy.expand * d
        shapes["mamba"] = {"conv": ((hy.d_conv - 1, d_inner), cfg.dtype),
                           "ssm": ((d_inner, hy.d_state), f32)}
    out = {}
    for kind, names in _CELL_STATE.items():
        n = sum(1 for s in specs if s["kind"] == kind)
        for name in names if n else ():
            shape, dtype = shapes[kind][name]
            out[f"{kind}_{name}"] = alloc((n_sb, n, batch) + shape, dtype,
                                          NEG if name == "m" else 0.0)
    return out


def init_cache(cfg: ArchConfig, batch: int, context_len: int, *,
               long_context: bool = False, device=None) -> dict:
    """Zero decode cache: {"k", "v"}, each (L, B, S, Hkv, D) in cfg.dtype
    (CUDA by default), L the attention layers, S = cache_window(context_len,
    long_context=); an enc-dec cache adds {"ck", "cv"}, each (L, B, F, H,
    D).  The recurrent layers' states (an xLSTM's cells, a hybrid's Mamba
    blocks) as in the module docstring, the m's at -1e30."""
    device = resolve_device(device)
    out = _cell_cache(cfg, batch, device, lambda shape, dtype, fill: torch.full(
        shape, fill, dtype=dtype, device=device))
    n_attn = sum(1 for spec, _ in _layer_slots(cfg) if spec["kind"] == "attn")
    if not n_attn:
        return out
    S = cache_window(cfg, context_len, long_context=long_context)
    hd = cfg.resolved_head_dim
    shape = (n_attn, batch, S, cfg.n_kv_heads, hd)
    out["k"] = torch.zeros(shape, dtype=cfg.dtype, device=device)
    out["v"] = torch.zeros(shape, dtype=cfg.dtype, device=device)
    if cfg.encdec is not None:
        cross = (cfg.n_layers, batch, cfg.encdec.n_frames, cfg.n_heads, hd)
        out["ck"] = torch.zeros(cross, dtype=cfg.dtype, device=device)
        out["cv"] = torch.zeros(cross, dtype=cfg.dtype, device=device)
    return out


def _ring_compact(kv, S: int, T: int):
    """(..., B, T, H, D) -> ring buffer (..., B, S, H, D) holding the last S
    tokens at slots (pos % S)."""
    tail = kv[..., max(0, T - S):T, :, :]
    if T <= S:
        pad = torch.zeros(kv.shape[:-3] + (S - T,) + kv.shape[-2:],
                          dtype=kv.dtype, device=kv.device)
        return torch.cat([tail, pad], dim=-3)
    return torch.roll(tail, T % S, dims=-3)


def prefill(cfg: ArchConfig, params, batch, *, long_context: bool = False,
            max_len: int = 0, lengths=None, aux: dict | None = None):
    """Prefill: run the context, return (last-token logits, decode cache,
    context length).

    batch: {"tokens": (B, T) integer tensor} [+ "patches" (VLM), whose P
    positions come first and count in the context length; + "frames"
    (enc-dec), which the encoder takes].  The cache is ring-compacted to
    cache_window(max_len, long_context=) slots (max_len: total context +
    generation budget; defaults to context length + 64).  With
    ``long_context`` a full-attention arch attends within the last
    min(long_context_window, context length) positions.

    The recurrent layers' part of the cache is their states after the
    last token (the module docstring's layout); ``max_len`` and
    ``long_context`` do not shape it.

    lengths: optional (B,) valid prompt lengths of a right-padded token
    batch (no patches, not enc-dec, no recurrent cells or Mamba blocks,
    which would take the pads into their state): pad keys are masked out of attention
    for every row, and the logits are gathered at each row's last real
    token.  The padded width must fit the cache window.  An MoE arch runs
    at the inference capacity (``_apply_ffn(dropless=True)``); pad tokens
    route like any other, as in the JAX package.

    aux: an optional dict, filled with the MoE aux losses of this forward
    (``load_balance_loss``, ``dropped_fraction``: () float32 tensors on the
    device, averaged over the MoE layers; zeros for a dense arch)."""
    slots = _layer_slots(cfg)
    if lengths is not None and (cfg.encdec is not None or cfg.xlstm is not None
                                or cfg.hybrid is not None or "patches" in batch):
        raise ValueError("bucketed (right-padded) prefill takes token batches "
                         "of an attention-only decoder")
    x, _ = _embed_inputs(cfg, params, batch)
    B, total_T = x.shape[0], x.shape[1]
    S = cache_window(cfg, max_len or total_T + 64, long_context=long_context)
    if lengths is not None and total_T > S:
        raise ValueError(f"bucket {total_T} exceeds cache window {S}: ring "
                         "compaction would drop real (non-pad) tokens")
    hd = cfg.resolved_head_dim
    n_attn = sum(1 for spec, _ in slots if spec["kind"] == "attn")
    cache = _cell_cache(cfg, B, x.device, lambda shape, dtype, fill: torch.empty(
        shape, dtype=dtype, device=x.device))
    if n_attn:
        shape = (n_attn, B, S, cfg.n_kv_heads, hd)
        cache["k"] = torch.empty(shape, dtype=x.dtype, device=x.device)
        cache["v"] = torch.empty(shape, dtype=x.dtype, device=x.device)
    if cfg.encdec is not None:
        enc_out = _run_encoder(cfg, params, _batch_tensor(params, batch, "frames"))
        cross = (cfg.n_layers, B, enc_out.shape[1], cfg.n_heads, hd)
        cache["ck"] = torch.empty(cross, dtype=x.dtype, device=x.device)
        cache["cv"] = torch.empty(cross, dtype=x.dtype, device=x.device)
        for i, p in enumerate(params["blocks"]):
            x, (k, v, ck, cv) = _decoder_layer_encdec(cfg, p, x, enc_out)
            cache["k"][i] = _ring_compact(k, S, total_T)
            cache["v"][i] = _ring_compact(v, S, total_T)
            cache["ck"][i], cache["cv"][i] = ck, cv
    else:
        window = cfg.sliding_window or (
            cache_window(cfg, total_T, long_context=True) if long_context else 0)
        n_moe = _moe_layer_count(cfg)
        acc = None if aux is None else _zero_aux(x.device)
        for p, (spec, at) in zip(params["blocks"], slots):
            x, state, layer_aux = _apply_sublayer(
                cfg, spec, p, x, window=window, dropless=True,
                kv_valid_len=lengths)
            if spec["kind"] == "attn":
                cache["k"][at] = _ring_compact(state[0], S, total_T)
                cache["v"][at] = _ring_compact(state[1], S, total_T)
            else:
                for name in _CELL_STATE[spec["kind"]]:
                    cache[f"{spec['kind']}_{name}"][at] = state[name]
            if aux is not None:
                acc = _acc_aux(acc, layer_aux, n_moe)
        if aux is not None:
            aux.update(acc)
    x = _norm(cfg, params["final_norm"], x)
    if lengths is None:
        last = x[:, -1]
    else:
        last = x[torch.arange(B, device=x.device), lengths.to(x.device) - 1]
    return _logits(cfg, params, last), cache, total_T


def decode_step(cfg: ArchConfig, params, tokens, cache, cache_len, *,
                aux: dict | None = None):
    """One decoding step.  tokens: (B, 1) integer tensor; cache from
    init_cache/prefill; cache_len: an int (every row at one depth) or a
    (B,) tensor (each row at its own depth; RoPE archs only, since
    sinusoidal positions take one offset).  Returns (logits (B, vocab)
    float32, cache), the cache updated IN PLACE.  The recurrent layers
    advance their states (cache_len does not enter them).  An MoE arch routes the
    step's B tokens as one group at the inference capacity (at moonshot's
    E = 64, k = 6 and B = 8: 4 slots an expert, so slots can drop, as in
    the JAX package); ``aux`` as in ``prefill``."""
    slots = _layer_slots(cfg)
    per_row = isinstance(cache_len, torch.Tensor) and cache_len.dim() > 0
    if per_row and cfg.rope_theta <= 0:
        raise ValueError(f"{cfg.name}: a per-row cache_len needs RoPE positions "
                         "(absolute sinusoidal offsets are scalar-only)")
    hd = cfg.resolved_head_dim
    x = embedding(params["embed"], tokens)
    if cfg.rope_theta == 0:
        x = x + sinusoidal_positions(1, cfg.d_model, offset=int(cache_len),
                                     device=x.device).to(x.dtype)
    n_moe = _moe_layer_count(cfg)
    acc = None if aux is None else _zero_aux(x.device)
    for i, (p, (spec, at)) in enumerate(zip(params["blocks"], slots)):
        h = _norm(cfg, p["norm"], x)
        kind = spec["kind"]
        if kind == "attn":
            y, _, _ = attention_decode_apply(
                p["attn"], h, cache["k"][at], cache["v"][at], cache_len,
                n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=hd,
                rope_theta=cfg.rope_theta)
        else:
            names = _CELL_STATE[kind]
            state = {n: cache[f"{kind}_{n}"][at] for n in names}
            if kind == "mamba":
                y, state = mamba_decode_apply(p["mamba"], h, state,
                                              **_mamba_kwargs(cfg))
            else:
                step = mlstm_decode_apply if kind == "mlstm" else slstm_decode_apply
                y, state = step(p["cell"], h, state, n_heads=cfg.n_heads)
            for n in names:
                cache[f"{kind}_{n}"][at].copy_(state[n])
        x = x + y
        if cfg.encdec is not None:
            c = _norm(cfg, p["cross_norm"], x)
            x = x + cross_attention_decode(p["cross"], c, cache["ck"][i],
                                           cache["cv"][i], n_heads=cfg.n_heads,
                                           head_dim=hd)
        x, layer_aux = _apply_ffn(cfg, spec, p, x, dropless=True)
        if aux is not None:
            acc = _acc_aux(acc, layer_aux, n_moe)
    if aux is not None:
        aux.update(acc)
    x = _norm(cfg, params["final_norm"], x)
    return _logits(cfg, params, x[:, 0]), cache


def prefill_chunk(cfg: ArchConfig, params, tokens, cache, depth: int, *,
                  attend_width: int, last_index=0):
    """Advance a chunked prefill by one token segment.

    tokens: (B, C) integer tensor, the next C prompt tokens (pad-extended
    past the prompt tail); cache: {"k", "v"} from ``init_cache`` whose
    slots [0, depth) already hold the previous segments' keys; depth: the
    host int of tokens already prefilled.  The segment's K/V (RoPE at
    positions depth + i) are written IN PLACE at slots [depth, depth + C),
    then its queries attend the first ``attend_width`` cache slots through
    ``flash_attention(q_offset=depth)``, so a row at position depth + i
    sees the keys a one-shot prefill of that padded width would show it.
    Stale keys past depth + C are causally masked (slot == position in a
    cache that is not a ring).  At B = 1 the attended slots are one
    contiguous run, which the kernel takes without a copy.

    last_index: an int, or a (B,) sequence / integer tensor, of the
    segment row whose logits are returned.  Returns (logits (B, vocab)
    float32, cache).  Chunked prefill needs a pure-attention dense-FFN
    RoPE decoder with no sliding window, no patches, no encoder, no MoE and
    no recurrent cells or Mamba blocks, which would take the pad tokens
    into their state (ValueError otherwise)."""
    if (cfg.rope_theta <= 0 or cfg.sliding_window or cfg.vlm is not None
            or cfg.encdec is not None or cfg.moe is not None
            or cfg.xlstm is not None or cfg.hybrid is not None):
        raise ValueError(
            f"{cfg.name}: chunked prefill needs a pure-attention dense-FFN "
            "RoPE decoder (no MoE, recurrent cells, Mamba blocks, patches or "
            "encoder) with no sliding window (a ring cache breaks slot == "
            "position)")
    B, C = tokens.shape
    S = cache["k"].shape[2]
    if not (0 <= depth and depth + C <= S and attend_width <= S):
        raise ValueError(f"segment [{depth}, {depth + C}) or attend width "
                         f"{attend_width} past the cache's {S} slots")
    hd = cfg.resolved_head_dim
    x = embedding(params["embed"], tokens)
    positions = depth + torch.arange(C, device=x.device)[None, :]
    for i, p in enumerate(params["blocks"]):
        hn = rmsnorm(p["norm"], x)
        q, k, v = project_qkv(p["attn"], hn, n_heads=cfg.n_heads,
                              n_kv_heads=cfg.n_kv_heads, head_dim=hd)
        q = apply_rope(q, positions, cfg.rope_theta)
        cache["k"][i, :, depth:depth + C] = apply_rope(
            k, positions, cfg.rope_theta).to(cache["k"].dtype)
        cache["v"][i, :, depth:depth + C] = v.to(cache["v"].dtype)
        out = flash_attention(q, cache["k"][i, :, :attend_width],
                              cache["v"][i, :, :attend_width], causal=True,
                              q_offset=depth)
        x = x + dense(p["attn"]["wo"], out.reshape(B, C, cfg.n_heads * hd))
        x = x + swiglu_ffn(p["ffn"], rmsnorm(p["ffn_norm"], x))
    x = rmsnorm(params["final_norm"], x)
    if isinstance(last_index, int):
        last = x[:, last_index]
    else:
        idx = torch.as_tensor(last_index, device=x.device)
        last = x[torch.arange(B, device=x.device), idx]
    return _logits(cfg, params, last), cache
