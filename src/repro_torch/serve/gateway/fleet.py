"""A simulated fleet of weak devices running the AgileNN local path.

The port of ``repro.serve.gateway.fleet``.  The fleet runs on the params'
torch device: its images go there once, the batched device pass runs
there (on CUDA, the fused offload kernel), and its three outputs come
back to the host in one copy each; everything after is numpy.

Each client owns a seeded Poisson arrival process, a link (`Channel`), a
rate controller and a slice of a fleet-wide synthetic request stream.
The device half of the pipeline (extractor -> fused top-k split/quantize
-> Local NN) runs *batched across the whole fleet* in one call
(`core.agile.device_forward_fn`) when the fleet is built.  The host-side
radio framing is batched too: the first request sent under a rate
profile triggers one vectorized requantize + `pack_indices_batch` pass
and one LZW sweep over every fleet row at that framing, and all later
sends under the profile are cache hits — simulation time per request is
just the device/channel timing bookkeeping.  (The MCU's per-inference
codec cost is accounted in *simulated* time by the device model either
way; batching only removes redundant host work from the wall clock.)

Compute and transmit timestamps come from the `DeviceModel` cost model
(STM32F746-class MCU), with each client's link bandwidth taken from its
channel, so one fleet can mix WiFi and narrowband devices.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import fp32_math
from repro_torch.compress.lzw import compress_payload, pack_indices_batch
from repro_torch.compress.quantize import quantization_bits
from repro_torch.configs.agilenn_cifar import AgileNNConfig
from repro_torch.core.agile import device_forward_fn
from repro_torch.data.synthetic import ImageDatasetSpec, SyntheticImages
from repro_torch.serve.device_model import DeviceModel
from repro_torch.serve.gateway.channel import (
    WIFI_UDP, NARROWBAND, LOSSY_WIFI, Channel, ChannelConfig,
)
from repro_torch.serve.gateway.control import (
    RateController, default_ladder, keep_channels, requantize, subset_centers,
)
from repro_torch.serve.offload import local_path_macs, remote_nn_macs


@dataclasses.dataclass(frozen=True)
class ClientSpec:
    channel: ChannelConfig = WIFI_UDP
    arrival_rate_hz: float = 25.0      # Poisson inference arrivals
    n_requests: int = 4
    slo_ms: "float | None" = None      # None => static configuration
    deadline_ms: "float | None" = None  # per-request deadline: the radio
                                        # stops retrying past it, the
                                        # gateway sheds on admission miss,
                                        # and the request resolves as a
                                        # Local-NN fallback

    def __post_init__(self):
        def bad(field, why):
            raise ValueError(f"ClientSpec.{field} {why} "
                             f"(got {getattr(self, field)!r})")
        if not isinstance(self.channel, ChannelConfig):
            bad("channel", "must be a ChannelConfig")
        if not self.arrival_rate_hz > 0:
            bad("arrival_rate_hz", "must be > 0")
        if self.n_requests < 0:
            bad("n_requests", "must be >= 0")
        if self.slo_ms is not None and not self.slo_ms > 0:
            bad("slo_ms", "must be > 0 (or None for the static profile)")
        if self.deadline_ms is not None and not self.deadline_ms > 0:
            bad("deadline_ms", "must be > 0 (or None for no deadline)")


def mixed_fleet(n_clients: int, *, n_requests: int = 4,
                arrival_rate_hz: float = 25.0,
                channels: tuple[ChannelConfig, ...] = (
                    WIFI_UDP, NARROWBAND, LOSSY_WIFI),
                slo_ms: "float | None" = None,
                deadline_ms: "float | None" = None) -> tuple[ClientSpec, ...]:
    """Round-robin mix of link types across the fleet."""
    return tuple(ClientSpec(channel=channels[i % len(channels)],
                            arrival_rate_hz=arrival_rate_hz,
                            n_requests=n_requests, slo_ms=slo_ms,
                            deadline_ms=deadline_ms)
                 for i in range(n_clients))


@dataclasses.dataclass
class Payload:
    """One radio frame: LZW-compressed bit-packed quantization indices.

    ``bits``/``keep``/``count`` describe the framing (in a real system a
    one-byte header; accounted as free here); ``codes`` is the LZW code
    stream actually on the air — the gateway's decode recovers the
    bit-packed indices from it."""
    client: int
    req: int
    bits: int
    keep: int            # transmitted remote channels (importance prefix)
    count: int           # packed index count = feat_hw^2 * keep
    nbytes: int          # radio bytes after LZW
    codes: list


class DeviceClient:
    """Host-side state of one simulated device."""

    def __init__(self, index: int, spec: ClientSpec, cfg: AgileNNConfig,
                 row0: int, ladder, seed: int):
        self.index = index
        self.spec = spec
        self.row0 = row0
        self.device = DeviceModel(cpu_hz=cfg.mcu_hz,
                                  link_bps=spec.channel.bandwidth_bps,
                                  macs_per_cycle=cfg.mcu_macs_per_cycle)
        self.channel = Channel(spec.channel, seed=seed + 1)
        slo_s = None if spec.slo_ms is None else spec.slo_ms * 1e-3
        self.controller = RateController(ladder, slo_s)
        rng = np.random.RandomState(seed)
        self.born = np.cumsum(rng.exponential(
            1.0 / spec.arrival_rate_hz, spec.n_requests))


class Fleet:
    """The device side of the gateway simulation, batched where the math
    is heavy and per-request where the radio framing is.

    Runs on the device of ``params`` (``init_agile_params(device=)`` or
    ``bridge.params_from_numpy(device=)``: CUDA unless the CPU was
    named)."""

    def __init__(self, cfg: AgileNNConfig, params,
                 specs: tuple[ClientSpec, ...], *, seed: int = 0):
        assert specs, "empty fleet"
        self.cfg = cfg
        self.params = params
        self.seed = seed
        feat_hw = cfg.image_size // (2 ** cfg.extractor_layers)
        self.feat_hw = feat_hw
        self.n_remote = cfg.extractor_channels - cfg.agile.k
        self.local_macs = local_path_macs(cfg, feat_hw)
        self.remote_macs = remote_nn_macs(cfg, feat_hw)

        self.device = params["quant"]["centers"].device
        centers = params["quant"]["centers"].detach().cpu().numpy().astype(
            np.float32)
        self.full_bits = quantization_bits(centers.shape[0])
        self._centers = {self.full_bits: centers}
        ladder = default_ladder(centers.shape[0])

        self.clients: list[DeviceClient] = []
        row0 = 0
        for i, spec in enumerate(specs):
            self.clients.append(DeviceClient(
                i, spec, cfg, row0, ladder, seed=seed + 101 * i))
            row0 += spec.n_requests
        self.n_requests = row0

        # fleet-wide request stream + one batched device pass (the only
        # device work the fleet does: one offload_fused launch on CUDA;
        # everything at simulation time is numpy / pure python)
        data = SyntheticImages(ImageDatasetSpec(
            image_size=cfg.image_size, n_classes=cfg.n_classes, seed=seed))
        self.images, self.labels = data.batch(self.n_requests,
                                              seed=seed + 1)
        with fp32_math():
            local_logits, f_remote, idx = device_forward_fn(cfg, params)(
                params, torch.from_numpy(self.images).to(self.device))
        self.local_logits = local_logits.cpu().numpy()
        self.f_remote = f_remote.cpu().numpy().astype(np.float32, copy=False)
        self.idx = idx.cpu().numpy()
        # per-profile payload cache, filled fleet-wide on first use: one
        # vectorized requantize + pack_indices_batch pass and one LZW
        # sweep per (bits, keep) framing, so simulation-time make_payload
        # is a dict hit — the codec cost is paid once per profile inside
        # the measured pipeline, not once per request
        self._payloads: dict[tuple[int, int], list] = {}

    def centers_for(self, bits: int) -> np.ndarray:
        if bits not in self._centers:
            self._centers[bits] = subset_centers(
                self._centers[self.full_bits], bits)
        return self._centers[bits]

    def compute_time(self, client: DeviceClient) -> float:
        return client.device.compute_time(self.local_macs)

    def _encoded_rows(self, bits: int, keep: int) -> list:
        """(nbytes, codes) for every fleet row under one framing, batched:
        the static profile reuses the fused kernel's full-codebook
        indices (byte-identical to per-image `pack_indices`, so that
        path stays bit-identical to the single-image offload); reduced
        profiles requantize the whole fleet's features in one pass."""
        got = self._payloads.get((bits, keep))
        if got is None:
            if bits >= self.full_bits and keep >= self.n_remote:
                idx = self.idx
            else:
                idx = requantize(self.f_remote[..., :keep],
                                 self.centers_for(bits))
            packed = pack_indices_batch(idx, bits)
            got = [compress_payload(p) for p in packed]
            self._payloads[(bits, keep)] = got
        return got

    def make_payload(self, client: DeviceClient, req: int) -> Payload:
        """One request's radio frame under the client's *current* rate
        profile, served from the per-profile fleet-wide codec cache."""
        prof = client.controller.profile()
        row = client.row0 + req
        keep = keep_channels(prof, self.n_remote, self.full_bits)
        nbytes, codes = self._encoded_rows(prof.bits, keep)[row]
        return Payload(client=client.index, req=req, bits=prof.bits,
                       keep=keep, count=self.feat_hw * self.feat_hw * keep,
                       nbytes=nbytes, codes=codes)
