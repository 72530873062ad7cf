"""Per-client adaptive rate control (the DynO-style dynamic split knob).

A copy of ``repro.serve.gateway.control``: ``requantize`` stays numpy
on the host, as in the JAX package.

When a client's measured end-to-end latency drifts above its SLO the
controller walks down a *rate ladder* — first fewer quantization bits,
then a smaller fraction of offloaded channels — and walks back up once
the channel recovers.  Level 0 is the static configuration: the full
learned codebook and every remote channel, bit-identical to the
single-image offload path (`run_offload_inference`), so a fleet with no
SLO reproduces today's deployment exactly.

Dropping channels exploits the same property the split itself does: the
disorder loss orders channels by importance, so the transmitted prefix
keeps the most informative features and the gateway zero-fills the tail.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.compress.quantize import quantization_bits


@dataclasses.dataclass(frozen=True)
class RateProfile:
    bits: int                # quantization bits (codebook of 2**bits centers)
    keep_frac: float = 1.0   # fraction of offloaded channels transmitted

    @property
    def key(self) -> tuple:
        return (self.bits, self.keep_frac)


def default_ladder(n_centers: int) -> tuple[RateProfile, ...]:
    """Static profile first, then progressively cheaper payloads."""
    full = quantization_bits(n_centers)
    ladder = [RateProfile(bits=full, keep_frac=1.0)]
    for bits, frac in ((full - 1, 1.0), (full - 1, 0.5),
                       (max(1, full - 2), 0.5), (max(1, full - 2), 0.25)):
        prof = RateProfile(bits=max(1, bits), keep_frac=frac)
        if prof != ladder[-1]:
            ladder.append(prof)
    return tuple(ladder)


# Degradation floor of the channel-masking ladder: no payload channel
# survives.  The gateway zero-fills the whole offloaded feature map and
# still serves Remote NN + combine — a lost or corrupted payload costs
# accuracy, not a round trip (the SemanticNN posture).
ERASED = RateProfile(bits=1, keep_frac=0.0)


def keep_channels(prof: RateProfile, n_remote: int, full_bits: int) -> int:
    """Transmitted-channel count of a rate profile: the full set at the
    static profile, an importance-prefix otherwise, and zero at the
    `ERASED` floor (the gateway zero-fills everything past this count)."""
    if prof.keep_frac <= 0.0:
        return 0
    if prof.bits >= full_bits and prof.keep_frac >= 1.0:
        return n_remote
    return max(1, int(round(prof.keep_frac * n_remote)))


def subset_centers(centers: np.ndarray, bits: int) -> np.ndarray:
    """Codebook of a reduced-bit profile: 2**bits centers spread evenly
    over the *sorted* learned codebook.  A bit width covering the whole
    codebook returns it unchanged, keeping indices compatible with the
    fused offload kernel's full-codebook output."""
    centers = np.asarray(centers, np.float32)
    m = 1 << bits
    if m >= centers.shape[0]:
        return centers
    order = np.argsort(centers, kind="stable")
    pick = np.round(np.linspace(0, centers.shape[0] - 1, m)).astype(int)
    return centers[order][pick]


def requantize(values: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """Nearest-center indices, ties to the lowest index — the numpy
    mirror of ``kernels.common.nearest_center_scan`` for host-side
    re-quantization at reduced bit widths."""
    d2 = (values[..., None].astype(np.float32)
          - centers.astype(np.float32)) ** 2
    return np.argmin(d2, axis=-1).astype(np.int32)


class RateController:
    """EWMA latency tracker walking the rate ladder against an SLO.

    ``slo_s=None`` disables control: the profile is pinned to level 0
    (the static configuration).  Recovery uses a hysteresis band below
    the SLO so the level doesn't oscillate across the threshold."""

    def __init__(self, ladder: tuple[RateProfile, ...],
                 slo_s: "float | None" = None, *, ewma: float = 0.4,
                 recover: float = 0.7):
        assert ladder, "empty rate ladder"
        self.ladder = tuple(ladder)
        self.slo_s = slo_s
        self.ewma = ewma
        self.recover = recover
        self.level = 0
        self._lat: "float | None" = None

    def profile(self) -> RateProfile:
        return self.ladder[self.level]

    def observe(self, e2e_s: float) -> None:
        if self.slo_s is None:
            return
        self._lat = (e2e_s if self._lat is None
                     else (1.0 - self.ewma) * self._lat + self.ewma * e2e_s)
        if self._lat > self.slo_s:
            self.level = min(self.level + 1, len(self.ladder) - 1)
        elif self._lat < self.recover * self.slo_s:
            self.level = max(self.level - 1, 0)
