"""Embedded-device cost model (paper §6-§7 hardware).

A copy of ``repro.serve.device_model``.  Its figures model the weak device
and its radio; none of them is a timing of the GPU.

Latency and energy for the STM32F746-class local device:
  - compute: MACs / (f_cpu * MACs-per-cycle)   (CMSIS-NN int8 ~1 MAC/cycle)
  - radio:   bytes * 8 / link_bps              (ESP-WROOM WiFi, UDP 6 Mbps,
                                                narrowband option 270 kbps)
  - energy:  P_cpu * t_compute + P_tx * t_tx
Constants (documented, order-of-magnitude from the STM32F746 and
ESP-WROOM-02D datasheets):
  P_cpu ~ 0.33 W (100 mA @ 3.3 V active), P_tx ~ 0.56 W (170 mA @ 3.3 V).
The server side (A6000 role) uses a 5 TMAC/s effective throughput; it is
never the bottleneck, matching the paper.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    cpu_hz: float = 216e6
    macs_per_cycle: float = 1.0
    link_bps: float = 6e6
    p_cpu_w: float = 0.33
    p_tx_w: float = 0.56
    server_macs_per_s: float = 5e12
    server_overhead_s: float = 1e-3      # decompress + dispatch

    def compute_time(self, macs: float) -> float:
        return macs / (self.cpu_hz * self.macs_per_cycle)

    def tx_time(self, payload_bytes: float) -> float:
        return payload_bytes * 8.0 / self.link_bps

    def server_time(self, macs: float) -> float:
        return self.server_overhead_s + macs / self.server_macs_per_s

    def energy(self, local_macs: float, payload_bytes: float) -> float:
        return (self.p_cpu_w * self.compute_time(local_macs)
                + self.p_tx_w * self.tx_time(payload_bytes))


@dataclasses.dataclass
class InferenceCost:
    local_compute_s: float
    tx_s: float
    server_s: float
    payload_bytes: float
    local_macs: float
    remote_macs: float

    @property
    def end_to_end_s(self) -> float:
        return self.local_compute_s + self.tx_s + self.server_s

    @property
    def as_dict(self) -> dict:
        return {
            "local_compute_ms": self.local_compute_s * 1e3,
            "tx_ms": self.tx_s * 1e3,
            "server_ms": self.server_s * 1e3,
            "end_to_end_ms": self.end_to_end_s * 1e3,
            "payload_bytes": self.payload_bytes,
            "local_macs": self.local_macs,
            "remote_macs": self.remote_macs,
        }


def mcu_memory_model(local_param_count: int, activation_floats: int,
                     *, int8: bool = True) -> dict:
    """SRAM/flash estimate for the local model (TFLite-Micro style):
    weights in flash (int8), activations in SRAM (int8 ping-pong)."""
    w_bytes = local_param_count * (1 if int8 else 4)
    a_bytes = activation_floats * (1 if int8 else 4)
    return {"flash_bytes": w_bytes, "sram_bytes": a_bytes}
