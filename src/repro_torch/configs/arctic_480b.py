"""arctic-480b [moe] — 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base]."""
from repro_torch.configs.base import ArchConfig, MoESpec, register

CONFIG = register(ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab=32000,
    moe=MoESpec(n_experts=128, top_k=2, expert_d_ff=4864,
                dense_residual_ff=7168 * 2),  # dense-MoE hybrid residual path
    param_dtype="bfloat16",
    source="hf:Snowflake/snowflake-arctic-base",
))
