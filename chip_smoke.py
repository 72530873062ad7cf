#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Phases, each of which raises on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from ``src/repro_torch/csrc`` with nvcc, all
     sources at once;
  3. each kernel against its plain PyTorch version on the card, bit-exact
     (``torch.equal``), at the main-path shape, ragged row counts,
     L in {4, 8, 16} and inputs on codebook midpoints;
  4. the AgileNN deployment path at the paper's width
     (``AgileNNConfig(image_size=96)``, B = 256, seed-0 params, shuffled
     mapping) through its entry points, with every launch count set to 0
     just before and read just after; the outputs are checked against the
     port's own CPU run of the same params;
  5. each kernel's time (CUDA events, median of 30 launches, L2 flushed),
     its plain version's, its bound, and images/s of the whole path.

Prints the card line, a {"kernels": [...]} line, and last
{"ok": true, "device": {...}}.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.compress.quantize import dequantize  # noqa: E402
from repro_torch.configs.agilenn_cifar import AgileNNConfig  # noqa: E402
from repro_torch.core.agile import (  # noqa: E402
    agile_forward,
    device_forward_fn,
    init_agile_params,
    offload_payload_arrays,
    remote_forward,
    tree_to,
)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.offload_fused.kernel import offload_fused_cuda  # noqa: E402
from repro_torch.kernels.offload_fused.ops import fused_offload  # noqa: E402
from repro_torch.kernels.offload_fused.ref import offload_fused_ref  # noqa: E402
from repro_torch.kernels.quantize.kernel import quantize_cuda  # noqa: E402
from repro_torch.kernels.quantize.ref import quantize_ref  # noqa: E402
from repro_torch.kernels.topk_split.kernel import channel_permute_cuda  # noqa: E402
from repro_torch.kernels.topk_split.ref import channel_permute_ref  # noqa: E402
from repro_torch.models.cnn import (  # noqa: E402
    extractor_apply,
    local_nn_apply,
    remote_nn_apply,
)
from repro_torch.nn.linear import conv2d  # noqa: E402
from repro_torch.nn.norm import groupnorm  # noqa: E402
from repro_torch.serve.offload import measure_payload, run_offload_inference  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth and
# fp32 outside the tensor cores, the type these kernels compute in.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BATCH = 256
TIMING_REPS = 30
# logits of the card vs the CPU on rows whose indices agree: fp32 convs
# sum in another order (cuDNN vs the CPU), through 6 GroupNorm blocks
LOGIT_TOL = 1e-3


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = TIMING_REPS) -> float:
    """Median device time of one call of ``fn``, by CUDA events.

    Before each call the L2 is flushed and the stream is held busy while
    the host enqueues the call, so the events time the device work alone,
    not the host's launch overhead."""
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")  # 256 MB
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(5_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def max_err(outs, refs) -> float:
    """Bit-exact comparison of every output; the largest |difference|."""
    err = 0.0
    for o, r in zip(outs, refs):
        check(o.shape == r.shape and o.dtype == r.dtype,
              f"shape/dtype {tuple(o.shape)} {o.dtype} vs {tuple(r.shape)} {r.dtype}")
        err = max(err, (o.double() - r.double()).abs().max().item()
                  if o.numel() else 0.0)
        check(torch.equal(o, r), f"kernel differs from its plain version by {err}")
    torch.cuda.synchronize()
    return err


def tie_inputs(rows: int, C: int, L: int):
    """Inputs on codebook midpoints and centers, centers at half-integers:
    the two distances of a midpoint are exactly equal."""
    centers = torch.arange(L, dtype=torch.float32, device="cuda") - (L - 1) / 2
    pool = torch.cat([(centers[:-1] + centers[1:]) / 2, centers])
    x = pool.repeat(-(-rows * C // pool.numel()))[:rows * C].reshape(rows, C)
    return x.contiguous(), centers


def phase_kernels(raw: torch.Tensor, centers: torch.Tensor, perm, k: int):
    """Every kernel vs its plain version on the card; returns max |err|."""
    N, C = raw.shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {"offload_fused": 0.0, "quantize": 0.0, "topk_split": 0.0}
    cases = [(raw, centers, perm, k)]
    for rows in (1, 7, 257, N + 3):
        for L in (4, 8, 16):
            x = torch.randn(rows, C, generator=gen, device="cuda") * 3
            cases.append((x, torch.linspace(-3, 3, L, device="cuda"),
                          tuple(reversed(range(C))), k))
    for L in (4, 8, 16):
        x, c = tie_inputs(513, C, L)
        cases.append((x, c, perm, k))
    for width, kw in ((3, 1), (8, 3), (64, 5)):       # other row widths
        x = torch.randn(1001, width, generator=gen, device="cuda") * 3
        p = tuple(int(i) for i in np.random.RandomState(width).permutation(width))
        cases.append((x, torch.linspace(-3, 3, 8, device="cuda"), p, kw))
    for x, c, p, kk in cases:
        errs["offload_fused"] = max(errs["offload_fused"], max_err(
            offload_fused_cuda(x, c, perm=p, k=kk),
            [t.contiguous() for t in offload_fused_ref(x, c, p, kk)]))
        remote = x[:, kk:].contiguous()
        errs["quantize"] = max(errs["quantize"], max_err(
            quantize_cuda(remote, c), quantize_ref(remote, c)))
        errs["topk_split"] = max(errs["topk_split"], max_err(
            [channel_permute_cuda(x, p)], [channel_permute_ref(x, p)]))
    print(f"phase 3: {len(cases)} cases per kernel, every output bit-exact "
          f"with its plain version: {errs}")
    return errs


def phase_main_path(cfg, params, images):
    """The deployment path through its entry points, launch counts from 0."""
    for kern in _build.KERNELS.values():
        kern.launches = 0
    preds, cost = run_offload_inference(cfg, params, images)
    local_logits, f_remote, idx = device_forward_fn(cfg, params)(params, images)
    split_logits = remote_forward(cfg, params, dequantize(params["quant"], idx),
                                  local_logits)
    logits, internals = agile_forward(cfg, params, images)
    logits_2p, internals_2p = agile_forward(cfg, params, images, use_fused=False)
    torch.cuda.synchronize()
    launches = {n: kern.launches for n, kern in _build.KERNELS.items()}
    print(f"phase 4: launches on the main path: {launches}")
    for n, count in launches.items():
        check(count > 0, f"kernel {n} was not launched on the main path")

    B, F = images.shape[0], cfg.image_size // 4
    R = cfg.extractor_channels - cfg.agile.k
    check(logits.shape == (B, cfg.n_classes) and bool(torch.isfinite(logits).all()),
          f"logits {tuple(logits.shape)} not finite/expected")
    check(tuple(idx.shape) == (B, F, F, R) and idx.dtype == torch.int32,
          f"indices {tuple(idx.shape)} {idx.dtype}")
    check(np.array_equal(preds, logits.argmax(-1).cpu().numpy()),
          "run_offload_inference predictions differ from agile_forward")
    check(torch.equal(split_logits, logits),
          "device_forward -> remote_forward differs from agile_forward")
    check(torch.equal(logits_2p, logits)
          and torch.equal(internals_2p["features"], internals["features"]),
          "the two-pass path differs from the fused path")

    # the same params, run by the port on the CPU
    cpu = tree_to(params, "cpu")
    logits_cpu, _ = agile_forward(cfg, cpu, images)
    idx_cpu = offload_payload_arrays(cfg, cpu, images)
    flipped = (idx.cpu() != idx_cpu)
    flip_frac = flipped.float().mean().item()
    clean = ~flipped.reshape(B, -1).any(dim=1)
    diff = (logits.cpu() - logits_cpu).abs()
    err_clean = diff[clean].max().item() if clean.any() else 0.0
    print(f"phase 4: index flips card vs CPU: {flip_frac:.3e} of {idx.numel()} "
          f"({int((~clean).sum())} of {B} images touched); logits |card - CPU| "
          f"max {diff.max().item():.3e}, on untouched images {err_clean:.3e} "
          f"(tolerance {LOGIT_TOL} abs + rel)")
    check(torch.allclose(logits.cpu()[clean], logits_cpu[clean],
                         atol=LOGIT_TOL, rtol=LOGIT_TOL),
          f"logits differ from the CPU run by {err_clean}")
    payload, _ = measure_payload(cfg, params, images)
    payload_cpu, _ = measure_payload(cfg, cpu, images)
    if not flipped.any():
        check(payload == payload_cpu, f"payload {payload} B vs CPU {payload_cpu} B")
    print(f"phase 4: payload {payload} B on the card, {payload_cpu} B on the "
          f"CPU ({payload / B:.2f} B per image); cost per image "
          f"{cost.as_dict}")
    return launches, {"index_flip_fraction": flip_frac,
                      "logit_max_abs_diff_vs_cpu": diff.max().item(),
                      "payload_bytes": payload, "payload_bytes_cpu": payload_cpu}


def phase_timing(cfg, params, images, raw, centers, perm, k, launches, errs, card):
    N, C = raw.shape
    L = centers.numel()
    remote = raw[:, k:].contiguous()
    n = remote.numel()
    perm_t = torch.tensor(perm, device="cuda")
    rows = []
    specs = [
        ("offload_fused", "src/repro_torch/csrc/offload_fused.cu",
         "src/repro/kernels/offload_fused/kernel.py:44",
         lambda: offload_fused_cuda(raw, centers, perm=perm, k=k),
         lambda: offload_fused_ref(raw, centers, perm, k), None,
         N * C * 4 + L * 4 + N * (k + 3 * (C - k)) * 4, 3 * L * N * (C - k)),
        ("quantize", "src/repro_torch/csrc/quantize.cu",
         "src/repro/kernels/quantize/kernel.py:27",
         lambda: quantize_cuda(remote, centers),
         lambda: quantize_ref(remote, centers), None,
         n * 4 + L * 4 + n * 8, 3 * L * n),
        ("topk_split", "src/repro_torch/csrc/topk_split.cu",
         "src/repro/kernels/topk_split/kernel.py:28",
         lambda: channel_permute_cuda(raw, perm),
         lambda: channel_permute_ref(raw, perm),
         lambda: torch.index_select(raw, 1, perm_t),
         2 * N * C * 4, 0),
    ]
    for name, src, replaces, kern, plain, library, nbytes, ops in specs:
        bound_ms, bound_by = bound(nbytes, ops)
        ms, plain_ms = time_ms(kern), time_ms(plain)
        library_ms = time_ms(library) if library else None
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": library_ms})
        print(f"phase 5: {name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {library_ms if library_ms is None else f'{library_ms:.4f}'} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}, {nbytes} B, {ops} ops), "
              f"{launches[name]} launches on the main path  [{card}]")

    # the whole path: the entry point (host LZW included), and its device part
    x_dev = torch.as_tensor(images, device="cuda")
    fn = device_forward_fn(cfg, params)

    def device_path():
        local_logits, _, idx = fn(params, x_dev)
        return remote_forward(cfg, params, dequantize(params["quant"], idx),
                              local_logits)

    device_ms = time_ms(device_path, reps=10)
    # the device path layer by layer, and inside the Remote NN its widest
    # GroupNorm against the 1x1 conv that feeds it
    raw4 = extractor_apply(params["extractor"], x_dev)
    f_local, _, idx, _ = fused_offload(raw4, centers, perm=perm, k=k)
    f_q = dequantize(params["quant"], idx)
    blk = params["remote"]["blocks"][0]
    stem = torch.randn(raw4.shape[:3] + (cfg.remote_width,), device="cuda")
    wide = conv2d(blk["pw1"], stem)
    stages = {
        "extractor": lambda: extractor_apply(params["extractor"], x_dev),
        "offload_fused": lambda: fused_offload(raw4, centers, perm=perm, k=k),
        "local_nn": lambda: local_nn_apply(params["local"], f_local),
        "dequantize": lambda: dequantize(params["quant"], idx),
        "remote_nn": lambda: remote_nn_apply(params["remote"], f_q),
        "remote_nn.pw1_conv": lambda: conv2d(blk["pw1"], stem),
        "remote_nn.groupnorm": lambda: groupnorm(blk["n1"], wide, groups=8),
    }
    stage_ms = {name: time_ms(f, reps=10) for name, f in stages.items()}
    print(f"phase 5: device path by layer (ms): "
          + ", ".join(f"{n} {t:.4f}" for n, t in stage_ms.items())
          + f"; the widest GroupNorm and its conv at {tuple(wide.shape)}  [{card}]")
    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        run_offload_inference(cfg, params, images)
        host.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    measure_payload(cfg, params, x_dev)
    payload_s = time.perf_counter() - t0
    B = images.shape[0]
    path = {"device_path_ms": device_ms, "device_path_stage_ms": stage_ms,
            "device_path_images_per_s": B / (device_ms / 1e3),
            "run_offload_inference_s": statistics.median(host),
            "run_offload_inference_images_per_s": B / statistics.median(host),
            "measure_payload_s": payload_s}
    print(f"phase 5: device path (device_forward_fn -> remote_forward, B={B}): "
          f"{device_ms:.3f} ms = {path['device_path_images_per_s']:.0f} images/s; "
          f"run_offload_inference (host LZW included): "
          f"{path['run_offload_inference_s']:.3f} s = "
          f"{path['run_offload_inference_images_per_s']:.1f} images/s, of which "
          f"measure_payload {payload_s:.3f} s  [{card}]")
    return rows, path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the full record as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False

    card = card_line()
    print(f"phase 1: card: {card}")
    t0 = time.perf_counter()
    libs = _build.build(sorted(_build.KERNELS))
    build_s = time.perf_counter() - t0
    print(f"phase 2: built {sorted(libs)} in {build_s:.2f} s")
    for name, lib in libs.items():
        log = lib.with_suffix(".log")
        for line in log.read_text().splitlines() if log.exists() else []:
            if "registers" in line or "spill" in line:
                print(f"phase 2: {name}: {line.strip()}")

    cfg = AgileNNConfig(image_size=96)
    params = init_agile_params(cfg, seed=0)
    params["mapping"] = tuple(
        int(p) for p in np.random.RandomState(0).permutation(cfg.extractor_channels))
    images = np.random.RandomState(1).standard_normal(
        (BATCH, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    k, perm, centers = cfg.agile.k, params["mapping"], params["quant"]["centers"]
    raw = extractor_apply(params["extractor"], torch.as_tensor(images, device="cuda"))
    raw = raw.reshape(-1, cfg.extractor_channels)

    errs = phase_kernels(raw, centers, perm, k)
    launches, path_checks = phase_main_path(cfg, params, images)
    rows, path = phase_timing(cfg, params, images, raw, centers, perm, k,
                              launches, errs, card)

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "device": device, "build_s": build_s,
                       "config": {"image_size": cfg.image_size, "batch": BATCH},
                       "kernels": rows, "path": path, "checks": path_checks},
                      f, indent=1)
    print(f"card: {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
