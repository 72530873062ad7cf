"""Dense decoder backbone: ArchConfig -> init / prefill / decode.

The port of ``repro.models.backbone`` for dense archs (qwen2, llama3.2):
every layer is RMSNorm -> causal GQA self-attention with RoPE -> residual,
RMSNorm -> SwiGLU FFN -> residual, and a final RMSNorm before the (tied)
readout.  Where the JAX package stacks the layers on a leading
(n_superblocks,) axis and scans them, the port keeps ``params["blocks"]``
as a Python list of per-layer dicts and loops over it.

The decode cache is ``{"k", "v"}``, each one (L, B, S, Hkv, D) tensor
whose ``[i]`` slice is layer i's contiguous ring of S slots.
``decode_step`` writes into it IN PLACE and returns the same dict (the
JAX package returns new arrays).

``prefill_chunk`` advances a chunked prefill by one segment of tokens
(the continuous scheduler's staged admissions), writing the segment's
K/V into the cache in place as ``decode_step`` does.

Configs with MoE, hybrid (Mamba), xLSTM, enc-dec or VLM parts raise
NotImplementedError: those branches are not ported yet.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import resolve_device, tree_to
from repro_torch.configs.base import ArchConfig
from repro_torch.nn.activations import swiglu_ffn, swiglu_ffn_init
from repro_torch.nn.attention import (
    attention_apply,
    attention_decode_apply,
    attention_init,
    flash_attention,
    project_qkv,
)
from repro_torch.nn.linear import dense, dense_init, embedding, embedding_init
from repro_torch.nn.norm import rmsnorm, rmsnorm_init
from repro_torch.nn.rope import apply_rope

# parts of a config the port's backbone cannot run yet, and where they wait
_UNPORTED = (
    ("moe", "ROADMAP Queue 1 item 6 (arch zoo: MoE)"),
    ("hybrid", "ROADMAP Queue 1 item 6 (arch zoo: Mamba hybrid)"),
    ("xlstm", "ROADMAP Queue 1 item 6 (arch zoo: xLSTM)"),
    ("encdec", "ROADMAP Queue 1 item 6 (arch zoo: enc-dec)"),
    ("vlm", "ROADMAP Queue 1 item 6 (arch zoo: VLM)"),
)


def _check_dense(cfg: ArchConfig) -> None:
    for name, item in _UNPORTED:
        if getattr(cfg, name) is not None:
            raise NotImplementedError(
                f"{cfg.name}: the port's backbone runs dense archs only; "
                f"`{name}` configs wait for {item}")


def sublayer_specs(cfg: ArchConfig) -> list[dict]:
    """Per-sublayer spec of one superblock: a dense arch has one
    attention sublayer with a dense FFN."""
    _check_dense(cfg)
    return [{"kind": "attn", "ffn": "dense"}]


# ------------------------------------------------------------------ init ---
def _init_layer(cfg: ArchConfig, gen: torch.Generator) -> dict:
    return {
        "norm": rmsnorm_init(cfg.d_model),
        "attn": attention_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.resolved_head_dim, qkv_bias=cfg.qkv_bias),
        "ffn_norm": rmsnorm_init(cfg.d_model),
        "ffn": swiglu_ffn_init(gen, cfg.d_model, cfg.d_ff),
    }


def init_params(cfg: ArchConfig, seed: int = 0, *, device=None) -> dict:
    """Fresh float32 parameters from ``seed``, drawn on the CPU and moved
    to ``device`` (CUDA by default; raises when CUDA is absent and no
    device was named).  The draws differ from the JAX package's for the
    same seed: bridge JAX weights with
    ``repro_torch.bridge.backbone_params_from_numpy`` to compare."""
    sublayer_specs(cfg)
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params: dict[str, Any] = {
        "embed": embedding_init(gen, cfg.vocab, cfg.d_model),
        "final_norm": rmsnorm_init(cfg.d_model),
        "blocks": [_init_layer(cfg, gen) for _ in range(cfg.n_layers)],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab,
                                       use_bias=False)
    return tree_to(params, device)


# --------------------------------------------------------------- forward ---
def _apply_sublayer(cfg: ArchConfig, p, x, *, window: int, kv_valid_len=None):
    """Full-sequence (prefill) layer.  Returns (x, (k, v))."""
    h = rmsnorm(p["norm"], x)
    y, k, v = attention_apply(
        p["attn"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, causal=True, window=window,
        rope_theta=cfg.rope_theta, return_kv=True, kv_valid_len=kv_valid_len)
    x = x + y
    x = x + swiglu_ffn(p["ffn"], rmsnorm(p["ffn_norm"], x))
    return x, (k, v)


def _readout_weight(cfg: ArchConfig, params):
    if cfg.tie_embeddings:
        return params["embed"]["table"].T          # (d, V)
    return params["lm_head"]["w"]


def _logits(cfg: ArchConfig, params, last):
    """last: (B, d) final-normed hidden states -> (B, vocab) float32."""
    return last.float() @ _readout_weight(cfg, params).float()


# ------------------------------------------------------------- decoding ----
def cache_window(cfg: ArchConfig, context_len: int) -> int:
    """KV ring-buffer capacity for a decode context of `context_len`.
    (The JAX package's ``long_context`` switch to a sliding window at 500k
    tokens is not ported.)"""
    if cfg.sliding_window:
        return min(cfg.sliding_window, context_len)
    return context_len


def init_cache(cfg: ArchConfig, batch: int, context_len: int, *,
               device=None) -> dict:
    """Zero decode cache: {"k", "v"}, each (L, B, S, Hkv, D) in cfg.dtype
    (CUDA by default)."""
    sublayer_specs(cfg)
    S = cache_window(cfg, context_len)
    shape = (cfg.n_layers, batch, S, cfg.n_kv_heads, cfg.resolved_head_dim)
    device = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def _ring_compact(kv, S: int, T: int):
    """(..., B, T, H, D) -> ring buffer (..., B, S, H, D) holding the last S
    tokens at slots (pos % S)."""
    tail = kv[..., max(0, T - S):T, :, :]
    if T <= S:
        pad = torch.zeros(kv.shape[:-3] + (S - T,) + kv.shape[-2:],
                          dtype=kv.dtype, device=kv.device)
        return torch.cat([tail, pad], dim=-3)
    return torch.roll(tail, T % S, dims=-3)


def prefill(cfg: ArchConfig, params, batch, *, max_len: int = 0, lengths=None):
    """Prefill: run the context, return (last-token logits, decode cache,
    prompt length).

    batch: {"tokens": (B, T) integer tensor}.  The cache is ring-compacted
    to cache_window(max_len) slots (max_len: total context + generation
    budget; defaults to prompt length + 64).

    lengths: optional (B,) valid prompt lengths of a right-padded batch:
    pad keys are masked out of attention for every row, and the logits are
    gathered at each row's last real token.  The padded width must fit the
    cache window."""
    sublayer_specs(cfg)
    if set(batch) != {"tokens"}:
        raise NotImplementedError(
            f"prefill takes token batches only, got {sorted(batch)}: patch / "
            "frame extras wait for ROADMAP Queue 1 item 6 (arch zoo)")
    tokens = batch["tokens"]
    B, T = tokens.shape
    x = embedding(params["embed"], tokens)
    S = cache_window(cfg, max_len or T + 64)
    if lengths is not None and T > S:
        raise ValueError(f"bucket {T} exceeds cache window {S}: ring "
                         "compaction would drop real (non-pad) tokens")
    hd = cfg.resolved_head_dim
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, hd)
    cache = {"k": torch.empty(shape, dtype=x.dtype, device=x.device),
             "v": torch.empty(shape, dtype=x.dtype, device=x.device)}
    for i, p in enumerate(params["blocks"]):
        x, (k, v) = _apply_sublayer(cfg, p, x, window=cfg.sliding_window,
                                    kv_valid_len=lengths)
        cache["k"][i] = _ring_compact(k, S, T)
        cache["v"][i] = _ring_compact(v, S, T)
    x = rmsnorm(params["final_norm"], x)
    if lengths is None:
        last = x[:, -1]
    else:
        last = x[torch.arange(B, device=x.device), lengths.to(x.device) - 1]
    return _logits(cfg, params, last), cache, T


def decode_step(cfg: ArchConfig, params, tokens, cache, cache_len):
    """One decoding step.  tokens: (B, 1) integer tensor; cache from
    init_cache/prefill; cache_len: an int (every row at one depth) or a
    (B,) tensor (each row at its own depth).  Returns (logits (B, vocab)
    float32, cache), the cache updated IN PLACE."""
    sublayer_specs(cfg)
    x = embedding(params["embed"], tokens)
    for i, p in enumerate(params["blocks"]):
        h = rmsnorm(p["norm"], x)
        y, _, _ = attention_decode_apply(
            p["attn"], h, cache["k"][i], cache["v"][i], cache_len,
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta)
        x = x + y
        x = x + swiglu_ffn(p["ffn"], rmsnorm(p["ffn_norm"], x))
    x = rmsnorm(params["final_norm"], x)
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
    RoPE decoder with no sliding window (ValueError otherwise)."""
    sublayer_specs(cfg)
    if cfg.rope_theta <= 0 or cfg.sliding_window:
        raise ValueError(
            f"{cfg.name}: chunked prefill needs a pure-attention dense-FFN "
            "RoPE decoder with no sliding window (a ring cache breaks "
            "slot == position)")
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
