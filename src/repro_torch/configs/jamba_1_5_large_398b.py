"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887]."""
from repro_torch.configs.base import ArchConfig, HybridSpec, MoESpec, register

CONFIG = register(ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    hybrid=HybridSpec(period=8, attn_index=0, d_state=16, d_conv=4, expand=2),
    moe=MoESpec(n_experts=16, top_k=2, expert_d_ff=24576, every=2),
    param_dtype="bfloat16",
    source="arXiv:2403.19887",
))
