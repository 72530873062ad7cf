"""moonshot-v1-16b-a3b [dense->moe] — Moonlight 16B-A3B: MoE 64e top-6 with a
shared expert [hf:moonshotai/Moonlight-16B-A3B]."""
from repro_torch.configs.base import ArchConfig, MoESpec, register

CONFIG = register(ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=163840,
    rope_theta=50_000.0,
    moe=MoESpec(n_experts=64, top_k=6, expert_d_ff=1408,
                shared_expert_ff=2816),  # 2 shared experts' worth
    param_dtype="bfloat16",
    source="hf:moonshotai/Moonlight-16B-A3B",
))
