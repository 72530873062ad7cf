"""Architecture configuration dataclasses and the config registry.

The fields and defaults are those of ``repro.configs.base``, so a config
means the same model in both packages.  ``dtype`` gives a torch dtype
(``param_dtype``: the MoE archs are bfloat16 at full size, and
``reduced()`` forces float32 as the JAX package's does).  The port
registers the dense archs, internvl2-1b (VLM), whisper-tiny (enc-dec),
the MoE archs, xlstm-350m and the Mamba hybrid jamba-1.5-large-398b.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import torch


@dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    expert_d_ff: int
    every: int = 1                 # MoE FFN every `every`-th layer (jamba: 2)
    dense_residual_ff: int = 0     # arctic: parallel dense FFN width
    shared_expert_ff: int = 0      # moonshot: always-on shared expert width
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class HybridSpec:
    """Jamba-style interleave: one attention layer per `period` layers."""
    period: int = 8                # 1:7 attention:mamba
    attn_index: int = 0            # position of the attention layer in the block
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2


@dataclass(frozen=True)
class XLSTMSpec:
    period: int = 8                # one sLSTM per 8 layers, rest mLSTM
    slstm_index: int = 7


@dataclass(frozen=True)
class EncDecSpec:
    n_encoder_layers: int = 4
    n_frames: int = 1500           # whisper-tiny 30s mel frames / 2 (conv stride)


@dataclass(frozen=True)
class VLMSpec:
    n_patches: int = 256           # stubbed ViT patch embeddings per image
    vision_dim: int = 1024         # raw frontend width before projector


@dataclass(frozen=True)
class AgileSpec:
    """AgileNN split-serving integration (the paper's technique)."""
    enabled: bool = False
    extractor_channels: int = 24   # lightweight on-device feature extractor
    k: int = 5                     # channels retained locally (top importance)
    rho: float = 0.8               # required cumulative normalized importance
    lam: float = 0.3               # loss mixing lambda
    alpha_temperature: float = 6.0 # T in alpha = sigmoid(w/T)
    ig_steps: int = 16             # integrated-gradients interpolations


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 => d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    tie_embeddings: bool = False
    sliding_window: int = 0        # native SWA (mixtral: 4096)
    long_context_window: int = 8192  # SWA used for long_500k on full-attn archs
    moe: Optional[MoESpec] = None
    hybrid: Optional[HybridSpec] = None
    xlstm: Optional[XLSTMSpec] = None
    encdec: Optional[EncDecSpec] = None
    vlm: Optional[VLMSpec] = None
    agile: AgileSpec = field(default_factory=AgileSpec)
    param_dtype: str = "float32"   # big archs: bfloat16
    source: str = ""               # citation

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def superblock(self) -> int:
        """Layers per superblock (the JAX package stacks and scans them)."""
        if self.hybrid is not None:
            return self.hybrid.period
        if self.xlstm is not None:
            return self.xlstm.period
        return 1

    @property
    def n_superblocks(self) -> int:
        if self.n_layers % self.superblock:
            raise ValueError(f"{self.name}: {self.n_layers} layers do not "
                             f"split into superblocks of {self.superblock}")
        return self.n_layers // self.superblock

    @property
    def dtype(self) -> torch.dtype:
        return {"float32": torch.float32,
                "bfloat16": torch.bfloat16}[self.param_dtype]

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: <=2 superblocks, d_model <= 512, <= 4 experts."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv_heads = min(self.n_kv_heads, max(1, n_heads // 2))
        while n_heads % n_kv_heads:
            n_kv_heads -= 1
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, n_experts=min(4, self.moe.n_experts),
                top_k=min(2, self.moe.top_k),
                expert_d_ff=min(128, self.moe.expert_d_ff),
                dense_residual_ff=min(128, self.moe.dense_residual_ff),
                shared_expert_ff=min(128, self.moe.shared_expert_ff))
        encdec = None
        if self.encdec is not None:
            encdec = dataclasses.replace(self.encdec, n_encoder_layers=2, n_frames=16)
        vlm = None
        if self.vlm is not None:
            vlm = dataclasses.replace(self.vlm, n_patches=8, vision_dim=64)
        max_sb = 1 if self.superblock > 1 else 2
        return dataclasses.replace(
            self, name=self.name + "-reduced",
            n_layers=self.superblock * min(max_sb, self.n_superblocks),
            d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv_heads,
            head_dim=0, d_ff=min(self.d_ff, 512), vocab=min(self.vocab, 512),
            moe=moe, encdec=encdec, vlm=vlm, param_dtype="float32")


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    import repro_torch.configs  # noqa: F401  (registers the archs)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)
