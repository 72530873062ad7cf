"""The paper's own evaluation configuration: AgileNN on CIFAR-scale images.

Feature extractor: 2 conv layers x 24 channels; Local NN: GAP + dense;
Remote NN: MobileNetV2-style (first conv removed, consumes extractor
features); Reference NN: a larger pre-trained CNN (EfficientNet role).
(Paper §7: images scaled to 96x96.)

The fields and defaults are those of ``repro.configs.agilenn_cifar``, so a
config means the same model in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass, field


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
class AgileNNConfig:
    name: str = "agilenn-cifar"
    image_size: int = 32           # synthetic CIFAR-like (96 in the paper)
    n_classes: int = 10
    extractor_channels: int = 24   # paper: 2 conv layers, 24 output channels each
    extractor_layers: int = 2
    local_hidden: int = 0          # Local NN = GAP + dense (minimum complexity)
    remote_width: int = 64         # MobileNetV2-ish width multiplier base
    remote_blocks: int = 6
    reference_width: int = 96      # larger reference CNN (pre-trained)
    reference_blocks: int = 8
    agile: AgileSpec = field(default_factory=lambda: AgileSpec(
        enabled=True, extractor_channels=24, k=5, rho=0.8, lam=0.3,
        alpha_temperature=6.0, ig_steps=16))
    # device model (paper's implementation, §6-7)
    mcu_hz: float = 216e6          # STM32F746 Cortex-M7
    link_bps: float = 6e6          # ESP-WROOM WiFi, UDP 6 Mbps
    mcu_macs_per_cycle: float = 1.0  # CMSIS-NN int8 MAC throughput (approx)


def gateway_demo_config() -> AgileNNConfig:
    """The CPU-sized AgileNN system of the offload-gateway demos: 16x16
    images, a 16-wide 2-block Remote NN."""
    return AgileNNConfig(image_size=16, remote_width=16, remote_blocks=2,
                         reference_width=16, reference_blocks=2,
                         agile=AgileSpec(enabled=True, extractor_channels=24,
                                         k=5, rho=0.8, lam=0.3, ig_steps=2))
