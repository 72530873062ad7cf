"""Multi-client offload gateway: a fleet of simulated weak devices
driving the batched Remote-NN serving path end-to-end over lossy links.

  fleet   = Fleet(cfg, params, mixed_fleet(32), seed=0)
  report  = OffloadGateway(cfg, params, fleet).run()
  print(report.summary())
"""
from repro_torch.serve.gateway.channel import (
    LOSSY_WIFI, NARROWBAND, WIFI_UDP, Channel, ChannelConfig, Delivery,
)
from repro_torch.serve.gateway.control import (
    ERASED, RateController, RateProfile, default_ladder, keep_channels,
    requantize, subset_centers,
)
from repro_torch.serve.gateway.fleet import (
    ClientSpec, DeviceClient, Fleet, Payload, mixed_fleet,
)
from repro_torch.serve.gateway.gateway import (
    GatewayConfig, GatewayReport, OffloadGateway, RequestTrace,
)

__all__ = [
    "Channel", "ChannelConfig", "Delivery",
    "WIFI_UDP", "NARROWBAND", "LOSSY_WIFI",
    "ERASED", "RateController", "RateProfile", "default_ladder",
    "keep_channels", "requantize", "subset_centers",
    "ClientSpec", "DeviceClient", "Fleet", "Payload", "mixed_fleet",
    "GatewayConfig", "GatewayReport", "OffloadGateway", "RequestTrace",
]
