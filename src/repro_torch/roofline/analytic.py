"""Analytic roofline terms per (arch x shape x mesh), on the H100.

The JAX package's formulas (``repro.roofline.analytic``) under the same
names, defaults and arithmetic; only the peaks they divide by are the
H100 SXM's (``roofline/analysis.py``): bf16 on the tensor cores, HBM3,
and NVLink 4 where the JAX package divides by TPU v5e's ICI.  The JAX
package derives its time terms analytically because XLA's
``cost_analysis`` counts a scanned loop's body once; the port counts a
step as it runs (``analysis.analyze_step``), and these formulas are the
estimate that count is held beside.

All terms are per-chip seconds:
  compute    = FLOPs / (chips * 989 TFLOP/s)
  memory     = HBM bytes touched per chip / 3.35 TB/s
  collective = per-chip link bytes / 450 GB/s

Collective accounting (per chip, per step):
  TP all-reduce of activation A within a model group: 2*A_local
  FSDP all-gather of params P over the data axes:      P/model_size
  FSDP reduce-scatter of grads:                        P/model_size
  MoE all-to-all (dispatch + return):                  2*tokens*k*d*b/chips
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.models.backbone import cache_window, sublayer_specs
from repro_torch.roofline.analysis import HBM_BW, LINK_BW, PEAK_FLOPS, active_param_count

BYTES = {"float32": 4, "bfloat16": 2}


@dataclasses.dataclass
class MeshSpec:
    data: int = 16
    model: int = 16
    pod: int = 1

    @property
    def chips(self) -> int:
        return self.data * self.model * self.pod

    @property
    def dsize(self) -> int:
        return self.data * self.pod


def _attn_layers(cfg: ArchConfig) -> int:
    return sum(1 for s in sublayer_specs(cfg) if s["kind"] == "attn") * cfg.n_superblocks


def _moe_layers(cfg: ArchConfig) -> int:
    return sum(1 for s in sublayer_specs(cfg) if s["ffn"] == "moe") * cfg.n_superblocks


def _param_bytes(cfg: ArchConfig) -> float:
    # total params (all experts), not just active
    n = total_param_count(cfg)
    return n * BYTES[cfg.param_dtype]


def total_param_count(cfg: ArchConfig) -> int:
    n = active_param_count(cfg)
    if cfg.moe is not None:
        d = cfg.d_model
        per_moe = 3 * d * cfg.moe.expert_d_ff
        n += _moe_layers(cfg) * per_moe * (cfg.moe.n_experts - cfg.moe.top_k)
    return n


def flops_estimate(cfg: ArchConfig, shape: InputShape) -> float:
    """Parameter flops + attention flops (+3x for backward on train)."""
    B, T = shape.global_batch, shape.seq_len
    decode = shape.kind == "decode"
    tokens = B * (1 if decode else T)
    mult = 3.0 if shape.kind == "train" else 1.0
    n_active = active_param_count(cfg)
    flops = mult * 2.0 * n_active * tokens

    # attention: q @ k^T and p @ v
    hd = cfg.resolved_head_dim
    H = cfg.n_heads
    L_attn = _attn_layers(cfg)
    window = cfg.sliding_window or (cfg.long_context_window
                                    if shape.name == "long_500k" else 0)
    if decode:
        s_eff = cache_window(cfg, T, long_context=shape.name == "long_500k")
        flops += L_attn * 4.0 * B * s_eff * H * hd
    else:
        s_eff = min(window, T) if window else T
        # causal: average context T/2 (or window)
        avg_ctx = s_eff if window and window < T else T / 2
        flops += mult * L_attn * 4.0 * B * T * avg_ctx * H * hd
    return flops


def memory_bytes_per_chip(cfg: ArchConfig, shape: InputShape, mesh: MeshSpec,
                          *, n_micro: int = 1, fsdp_serve: bool = False) -> float:
    """HBM bytes touched per chip per step (coarse napkin model)."""
    B, T = shape.global_batch, shape.seq_len
    pb = _param_bytes(cfg)
    act_b = 2  # activations bf16 in compute
    d = cfg.d_model
    if shape.kind == "train":
        # FSDP: per microbatch, gathered params are read fwd+bwd from HBM
        p_read = 2 * n_micro * pb / mesh.model
        # updates: read+write grads, momentum, params (sharded over chips)
        p_upd = 5 * pb / mesh.chips
        # remat activations: write fwd + read bwd + recompute write
        act = 3 * cfg.n_layers * B * T * d * act_b / mesh.chips
        return p_read + p_upd + act
    if shape.kind == "prefill":
        p_read = pb / (mesh.chips if fsdp_serve else mesh.model)
        act = 2 * cfg.n_layers * B * T * d * act_b / mesh.chips
        cache = _cache_bytes(cfg, shape) / mesh.chips
        return p_read + act + cache
    # decode: params + full cache read per token
    p_read = pb / mesh.model  # gathered (fsdp_serve) or resident: read once
    cache = _cache_bytes(cfg, shape) / mesh.chips
    return p_read + cache


def _cache_bytes(cfg: ArchConfig, shape: InputShape) -> float:
    B, T = shape.global_batch, shape.seq_len
    S = cache_window(cfg, T, long_context=shape.name == "long_500k")
    hd = cfg.resolved_head_dim
    b = BYTES[cfg.param_dtype]
    kv = _attn_layers(cfg) * B * S * cfg.n_kv_heads * hd * 2 * b
    if cfg.encdec is not None:
        kv += cfg.n_layers * B * cfg.encdec.n_frames * cfg.n_heads * hd * 2 * b
    specs = sublayer_specs(cfg)
    n_mamba = sum(1 for s in specs if s["kind"] == "mamba") * cfg.n_superblocks
    if n_mamba:
        di = cfg.hybrid.expand * cfg.d_model
        kv += n_mamba * B * di * cfg.hybrid.d_state * 4
    n_ml = sum(1 for s in specs if s["kind"] == "mlstm") * cfg.n_superblocks
    if n_ml:
        kv += n_ml * B * cfg.n_heads * hd * hd * 4
    return kv


def collective_bytes_per_chip(cfg: ArchConfig, shape: InputShape,
                              mesh: MeshSpec, *, n_micro: int = 1,
                              fsdp_serve: bool = False) -> float:
    B, T = shape.global_batch, shape.seq_len
    decode = shape.kind == "decode"
    tokens_l = B * (1 if decode else T) / mesh.dsize   # per model-group tokens
    d = cfg.d_model
    ab = 2  # bf16 activations
    pb = _param_bytes(cfg)
    L = cfg.n_layers
    n_moe = _moe_layers(cfg)
    total = 0.0
    if shape.kind == "train":
        # FSDP param gathers fwd+bwd + grad reduce-scatter, per microbatch
        total += n_micro * 3 * pb / mesh.model
        # TP all-reduce: 2 per layer fwd + 2 bwd, each 2*A_local per chip
        a_loc = (B / n_micro / mesh.dsize) * T * d * ab
        total += n_micro * L * 4 * 2 * a_loc
        # MoE all-to-all both ways per moe layer (fwd + bwd)
        if n_moe:
            tk = (B / n_micro) * T * cfg.moe.top_k * d * ab
            total += n_micro * n_moe * 2 * 2 * tk / mesh.chips
        if mesh.pod > 1:
            total += pb / mesh.chips  # cross-pod grad reduce share
        return total
    # inference
    if fsdp_serve:
        total += pb / mesh.model          # per-layer weight gathers
    a_loc = tokens_l * d * ab
    total += L * 2 * 2 * a_loc            # 2 TP all-reduces per layer
    if n_moe:
        tk = B * (1 if decode else T) * cfg.moe.top_k * d * ab
        total += n_moe * 2 * tk / mesh.chips
    return total


def strategy_roofline(cfg: ArchConfig, shape: InputShape, *, chips: int = 256,
                      tp: int = 16, fsdp: bool = True, n_micro: int = 1,
                      expert_resident: bool = False,
                      replicated_params: bool = False) -> dict:
    """Roofline terms under an explicit sharding strategy (§Perf).

    tp: tensor-parallel degree (1 = pure DP; chips = all-chip TP).
    fsdp: weight/grad/opt sharding over the data axes (train) or 2D weight
      gathers (serve).  replicated_params (tp=1, no fsdp): grads all-reduce.
    expert_resident: 2D expert placement — expert weights never gathered;
      only token all-to-all moves.
    """
    dsize = chips // max(tp, 1)
    B, T = shape.global_batch, shape.seq_len
    decode = shape.kind == "decode"
    pb = _param_bytes(cfg)
    d = cfg.d_model
    ab = 2
    L = cfg.n_layers
    n_moe = _moe_layers(cfg)
    eb = 0.0
    if cfg.moe is not None:
        eb = (3 * d * cfg.moe.expert_d_ff * cfg.moe.n_experts
              * _moe_layers(cfg) * BYTES[cfg.param_dtype])
    pb_gathered = pb - (eb if expert_resident else 0.0)

    flops = flops_estimate(cfg, shape)
    coll = 0.0
    mem = 0.0
    if shape.kind == "train":
        if replicated_params:
            coll += 2 * pb                     # grad all-reduce (ring: 2x)
            mem += 2 * n_micro * pb + 5 * pb   # reads fwd/bwd + update
        elif fsdp:
            coll += n_micro * 3 * pb_gathered / max(tp, 1)
            mem += 2 * n_micro * pb_gathered / max(tp, 1) + 5 * pb / chips
            if expert_resident:
                mem += 2 * n_micro * eb / chips
        if tp > 1:
            a_loc = (B / n_micro / dsize) * T * d * ab
            coll += n_micro * L * 4 * 2 * a_loc
        if n_moe:
            tk = (B / n_micro) * T * cfg.moe.top_k * d * ab
            coll += n_micro * n_moe * 2 * 2 * tk / chips
        mem += 3 * L * B * T * d * ab / chips
    else:
        if fsdp and not expert_resident:
            coll += pb_gathered / max(tp, 1)
            mem += pb_gathered / max(tp, 1)
        else:
            mem += pb / chips if tp == chips else pb / max(tp, 1)
        tokens_l = B * (1 if decode else T) / max(dsize, 1)
        if tp > 1:
            coll += L * 2 * 2 * tokens_l * d * ab
        if n_moe:
            tk = B * (1 if decode else T) * cfg.moe.top_k * d * ab
            coll += n_moe * 2 * tk / chips
        mem += _cache_bytes(cfg, shape) / chips
        if not decode:
            mem += 2 * L * B * T * d * ab / chips
    terms = {
        "compute_s": flops / (chips * PEAK_FLOPS),
        "memory_s": mem / HBM_BW,
        "collective_s": coll / LINK_BW,
    }
    dominant = max(terms, key=terms.get)
    step_s = max(terms.values())
    return {**terms, "dominant": dominant, "step_s_bound": step_s,
            "flops": flops, "chips": chips, "tp": tp, "n_micro": n_micro}


def analytic_roofline(cfg: ArchConfig, shape: InputShape,
                      mesh: MeshSpec | None = None, *, n_micro: int = 1,
                      fsdp_serve: bool = False) -> dict:
    mesh = mesh or MeshSpec()
    flops = flops_estimate(cfg, shape)
    mem = memory_bytes_per_chip(cfg, shape, mesh, n_micro=n_micro,
                                fsdp_serve=fsdp_serve)
    coll = collective_bytes_per_chip(cfg, shape, mesh, n_micro=n_micro,
                                     fsdp_serve=fsdp_serve)
    terms = {
        "compute_s": flops / (mesh.chips * PEAK_FLOPS),
        "memory_s": mem / HBM_BW,
        "collective_s": coll / LINK_BW,
    }
    dominant = max(terms, key=terms.get)
    return {"flops": flops, "hbm_bytes_per_chip": mem,
            "collective_bytes_per_chip": coll,
            **terms, "dominant": dominant, "chips": mesh.chips}
