"""internvl2-1b [vlm] — InternViT (STUBBED frontend: the batch carries
patch embeddings) + InternLM2 LM backbone [arXiv:2404.16821]."""
from repro_torch.configs.base import ArchConfig, VLMSpec, register

CONFIG = register(ArchConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151655,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    vlm=VLMSpec(n_patches=256, vision_dim=1024),
    source="arXiv:2404.16821",
))
