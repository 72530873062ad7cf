"""whisper-tiny [audio] — encoder-decoder with a conv mel frontend (STUBBED:
the batch carries precomputed frame embeddings) [arXiv:2212.04356]."""
from repro_torch.configs.base import ArchConfig, EncDecSpec, register

CONFIG = register(ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,             # decoder layers; encoder in EncDecSpec
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    norm="layernorm",
    rope_theta=0.0,         # whisper uses sinusoidal positions
    encdec=EncDecSpec(n_encoder_layers=4, n_frames=1500),
    source="arXiv:2212.04356",
))
