#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Phases, each of which raises on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from ``src/repro_torch/csrc`` with nvcc, all
     sources at once; print registers and spills, and check that flash
     attention's SASS holds tensor-core products (HMMA) and asynchronous
     copies (LDGSTS), and that the permute, the fused offload pass and
     decode attention copy in by LDGSTS and write by 16-byte stores;
  AgileNN offload inference (slice 1):
  3. each offload kernel against its plain PyTorch version on the card,
     bit-exact (``torch.equal``), at the main-path shape, ragged row
     counts, L in {4, 8, 16} and inputs on codebook midpoints; the permute
     and the fused pass also at N in {1, 3, 5} x C in {3, 24, 64} (the
     fused pass at k in {0, C / 3, C}), and a view 1 float off 16-byte
     alignment must raise ValueError in both;
  4. the AgileNN deployment path at the paper's width
     (``AgileNNConfig(image_size=96)``, B = 256, seed-0 params, shuffled
     mapping) through its entry points, with every launch count set to 0
     just before and read just after; the outputs are checked against the
     port's own CPU run of the same params;
  5. each offload kernel's time (CUDA events, median of 30 launches, L2
     flushed), its plain version's, its bound (and the fused kernel's
     device time from torch.profiler), and images/s of the path;
  dense LLM serving (slice 2):
  6. RMSNorm, flash attention and paged decode attention against their
     plain versions on the card (atol = rtol = 2e-5): ragged row counts
     and widths; causal, window, q_offset, ragged kv_valid_len (a 0
     among them), T and S off the tile, T in {1, 15}, D 64 and 128, the
     prefill shapes of qwen2-1.5b and llama3.2-1b; per-row attend_len (a
     0 among them, which must give exactly 0), S off the page, G in {1,
     4, 7, 8}; decode attend_len on a split boundary and one off it, 1
     and S, per-row depths in different splits, B in {1, 32}, and a cache
     poisoned with NaN past attend_len (the kernel must not read it).
     Flash on inputs x8, where fp32 itself misses 2e-5, is held against
     float64: its error at most SPLIT_COST times the plain version's;
  7. qwen2-0.5b at full width (seed-0 params, fp32, TF32 off) through
     ``ServeEngine(max_len=1024).generate``: 8 prompts of 512 tokens, 32
     new tokens, greedy, then once sampled, with every launch count set
     to 0 just before and read just after;
  8. the same params on the card and on the CPU (B = 2, T = 128, 8
     tokens): prefill logits within 1e-3, greedy tokens equal unless the
     CPU's top-2 margin at the first divergence is within the tolerance;
  9. each LLM kernel's time, its plain version's, the library call's and
     its bound (decode attention also with a (B,) attend_len, its grid
     sized from S, and its two kernels' device times from torch.profiler);
     prefill and decode tokens/s, the decode step's kernels and their
     summed device time from torch.profiler, and the time by part.

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

from repro_torch import tree_to  # noqa: E402
from repro_torch.compress.quantize import dequantize  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.agilenn_cifar import AgileNNConfig  # noqa: E402
from repro_torch.core.agile import (  # noqa: E402
    agile_forward,
    device_forward_fn,
    init_agile_params,
    offload_payload_arrays,
    remote_forward,
)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.attention.kernel import flash_attention_cuda  # noqa: E402
from repro_torch.kernels.attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.common import auto_page_size  # noqa: E402
from repro_torch.kernels.decode_attention.kernel import (  # noqa: E402
    decode_attention_cuda,
    split_slots,
)
from repro_torch.kernels.decode_attention.ops import DEFAULT_PAGE  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro_torch.kernels.offload_fused.kernel import offload_fused_cuda  # noqa: E402
from repro_torch.kernels.offload_fused.ops import fused_offload  # noqa: E402
from repro_torch.kernels.offload_fused.ref import offload_fused_ref  # noqa: E402
from repro_torch.kernels.quantize.kernel import quantize_cuda  # noqa: E402
from repro_torch.kernels.quantize.ref import quantize_ref  # noqa: E402
from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402
from repro_torch.kernels.topk_split.kernel import channel_permute_cuda  # noqa: E402
from repro_torch.kernels.topk_split.ref import channel_permute_ref  # noqa: E402
from repro_torch.models import backbone as bb  # noqa: E402
from repro_torch.models.cnn import (  # noqa: E402
    extractor_apply,
    local_nn_apply,
    remote_nn_apply,
)
from repro_torch.nn.activations import swiglu_ffn  # noqa: E402
from repro_torch.nn.attention import project_qkv  # noqa: E402
from repro_torch.nn.linear import conv2d, dense  # noqa: E402
from repro_torch.nn.norm import groupnorm, rmsnorm  # noqa: E402
from repro_torch.nn.rope import apply_rope  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
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
OFFLOAD_KERNELS = ("offload_fused", "quantize", "topk_split")

# the LLM serving path: qwen2-0.5b at full width, fp32, seed-0 params
LLM_ARCH = "qwen2-0.5b"
LLM_KERNELS = ("rmsnorm", "flash_attention", "decode_attention")
LLM_BATCH, LLM_PROMPT, LLM_NEW, LLM_MAX_LEN = 8, 512, 32, 1024
# kernel vs plain on the card: the JAX package's own bars for these
# oracles (atol = rtol = 2e-5, tests/test_decode_attention.py)
LLM_KERNEL_TOL = 2e-5
# flash on inputs x8, against float64: 3xTF32 products keep about 2^-21 of
# each product, fp32 2^-24 (tests/test_torch_llm_kernels.py)
SPLIT_COST = 8
# TF32 on the tensor cores, dense (NVIDIA data sheet, 700 W); 3xTF32
# issues three TF32 products for each fp32 one
TF32_OPS_PER_S = 495e12
# card vs the port's CPU run, at a smaller batch: fp32 sums in another
# order over 24 layers and a 151,936-wide readout
LLM_LOGIT_TOL = 1e-3
CPU_BATCH, CPU_PROMPT, CPU_NEW, CPU_MAX_LEN = 2, 128, 8, 256


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = TIMING_REPS, hold_cycles: int = 5_000_000) -> float:
    """Median device time of one call of ``fn``, by CUDA events.

    Before each call the L2 is flushed and the stream is held busy for
    ``hold_cycles`` while the host enqueues the call, so the events time
    the device work alone, not the host's launch overhead."""
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")  # 256 MB
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(hold_cycles)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def device_kernels(fn, reps: int = 20, match: str = "") -> dict:
    """{kernel name: (device us per call, launches per call)} of the
    kernels of ``fn`` whose names hold ``match``, over ``reps`` calls, from
    torch.profiler's device events ({} if it records none): the kernels'
    own durations, without the gaps between them."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if (getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA
                or match not in evt.key):
            continue
        total = getattr(evt, "device_time_total", None)
        total = total if total is not None else evt.cuda_time_total
        out[evt.key] = (total / reps, evt.count / reps)
    return out



# what the redesigned kernels must issue: tensor-core products (HMMA) and
# asynchronous copies (LDGSTS) in flash attention, asynchronous 16-byte
# copies and 16-byte stores in the permute, the fused offload pass and
# decode attention (its partials and its output)
SASS_EXPECT = {"flash_attention": ("HMMA", "LDGSTS"),
               "topk_split": ("LDGSTS", "STG.E.128"),
               "offload_fused": ("LDGSTS", "STG.E.128"),
               "decode_attention": ("LDGSTS", "STG.E.128")}


def sass_counts(libs) -> dict:
    """Count the expected instructions in each built library's SASS."""
    cuobjdump = os.path.join(os.path.dirname(os.path.realpath(_build.find_nvcc())),
                             "cuobjdump")
    counts = {}
    for name, ops in SASS_EXPECT.items():
        sass = subprocess.run([cuobjdump, "-sass", str(libs[name])], check=True,
                              capture_output=True, text=True, timeout=120).stdout
        counts[name] = {op: sass.count(op) for op in ops}
        check(all(counts[name].values()), f"{name}: SASS lacks {counts[name]}")
    return counts


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
    # the permute and the fused pass move 16-byte tiles: row counts, widths
    # and splits off the float4
    permute_cases = [(x, p) for x, _, p, _ in cases]
    fused_cases = list(cases)
    for rows in (1, 3, 5):
        for width in (3, 24, 64):
            p = tuple(int(i) for i in
                      np.random.RandomState(rows * width).permutation(width))
            x = torch.randn(rows, width, generator=gen, device="cuda") * 3
            permute_cases.append((x, p))
            for kk in sorted({0, width // 3, width}):
                fused_cases.append((x, torch.linspace(-3, 3, 8, device="cuda"),
                                    p, kk))
    for x, c, p, kk in fused_cases:
        errs["offload_fused"] = max(errs["offload_fused"], max_err(
            offload_fused_cuda(x, c, perm=p, k=kk),
            [t.contiguous() for t in offload_fused_ref(x, c, p, kk)]))
    for x, c, p, kk in cases:
        remote = x[:, kk:].contiguous()
        errs["quantize"] = max(errs["quantize"], max_err(
            quantize_cuda(remote, c), quantize_ref(remote, c)))
    for x, p in permute_cases:
        errs["topk_split"] = max(errs["topk_split"], max_err(
            [channel_permute_cuda(x, p)], [channel_permute_ref(x, p)]))
    off = torch.randn(4 * C + 1, generator=gen, device="cuda")[1:].view(4, C)
    for name, call in (("topk_split", lambda: channel_permute_cuda(off, perm)),
                       ("offload_fused",
                        lambda: offload_fused_cuda(off, centers, perm=perm, k=k))):
        try:
            call()
            check(False, f"{name} took a view 4 bytes off 16-byte alignment")
        except ValueError as e:
            print(f"phase 3: {name}: a misaligned view is refused: {e}")
    print(f"phase 3: {len(fused_cases)} cases for the fused pass, {len(cases)} "
          f"for the quantizer, {len(permute_cases)} for the permute, every "
          f"output bit-exact with its plain version: {errs}")
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
    launches = {n: _build.KERNELS[n].launches for n in OFFLOAD_KERNELS}
    print(f"phase 4: launches on the offload path: {launches}")
    for n, count in launches.items():
        check(count > 0, f"kernel {n} was not launched on the offload path")

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

    fused_us = device_kernels(lambda: offload_fused_cuda(raw, centers, perm=perm,
                                                         k=k), match="offload_fused")
    print(f"phase 5: offload_fused device us and launches per call (torch.profiler): "
          f"{fused_us}  [{card}]")
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
            "offload_fused_kernel_us": fused_us,
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


def close_err(out, ref, tol: float, what: str) -> float:
    """The kernel's output against its plain version within ``tol`` abs +
    rel; the largest |difference|."""
    check(out.shape == ref.shape and out.dtype == ref.dtype,
          f"{what}: shape/dtype {tuple(out.shape)} {out.dtype} vs "
          f"{tuple(ref.shape)} {ref.dtype}")
    err = (out.double() - ref.double()).abs().max().item() if out.numel() else 0.0
    check(torch.allclose(out, ref, atol=tol, rtol=tol),
          f"{what}: kernel differs from its plain version by {err}")
    return err


def exact_attention(q, k, v):
    """Causal attention in float64, dense: the yardstick of fp32's error."""
    T, G = q.shape[1], q.shape[2] // k.shape[2]
    q = q.double()
    k, v = (t.double().repeat_interleave(G, 2) for t in (k, v))
    s = torch.einsum("bthd,bshd->bhts", q, k) / q.shape[-1] ** 0.5
    causal = torch.ones(T, k.shape[1], dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~causal, -float("inf")), dim=-1)
    return torch.einsum("bhts,bshd->bthd", p, v)


def phase_llm_kernels():
    """The three LLM kernels vs their plain versions on the card, at the
    main path's shapes and off them; returns max |err| per kernel."""
    gen = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    errs = dict.fromkeys(LLM_KERNELS, 0.0)
    cases = dict.fromkeys(LLM_KERNELS, 0)

    def note(name, err):
        errs[name] = max(errs[name], err)
        cases[name] += 1

    for N in (1, 7, 4096 + 3):
        for d in (128, 896, 2048):
            x, sc = randn(N, d) * 3, 1 + 0.1 * randn(d)
            note("rmsnorm", close_err(rmsnorm_cuda(x, sc), rmsnorm_ref(x, sc),
                                      LLM_KERNEL_TOL, f"rmsnorm N={N} d={d}"))
    # (B, T, S, Hq, Hkv, D, causal, window, q_offset, kv_valid_len)
    flash_cases = [
        (LLM_BATCH, LLM_PROMPT, LLM_PROMPT, 14, 2, 64, True, 0, 0, None),
        (2, 100, 100, 4, 2, 64, True, 64, 0, None),
        (2, 37, 137, 6, 2, 128, True, 0, 100, None),
        (3, 77, 77, 8, 8, 128, True, 0, 0, [77, 1, 40]),
        (2, 130, 130, 14, 2, 64, True, 0, 0, [130, 65]),
        (2, 50, 200, 4, 1, 64, False, 0, 0, None),
        (1, 10, 20, 4, 2, 64, True, 4, 50, None),       # no live key: 0
        (2, 512, 512, 12, 2, 128, True, 0, 0, None),    # qwen2-1.5b prefill
        (2, 512, 512, 32, 8, 64, True, 0, 0, None),     # llama3.2-1b prefill
        (3, 1, 1, 14, 2, 64, True, 0, 0, None),         # T off the m16 tile
        (2, 1, 300, 12, 2, 128, True, 0, 299, None),
        (3, 15, 15, 4, 2, 128, True, 0, 0, None),
        (2, 15, 90, 14, 2, 64, True, 0, 75, None),
        (3, 70, 70, 8, 2, 64, True, 0, 0, [70, 0, 33]),  # a row with no key
        (3, 40, 40, 4, 2, 128, False, 0, 0, [0, 40, 9]),
    ]
    for B, T, S, Hq, Hkv, D, causal, window, q_off, valid in flash_cases:
        q, k, v = randn(B, T, Hq, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D)
        kw = dict(causal=causal, window=window, q_offset=q_off,
                  kv_valid_len=None if valid is None
                  else torch.tensor(valid, device="cuda"))
        out = flash_attention_cuda(q, k, v, **kw)
        note("flash_attention", close_err(
            out, flash_attention_ref(q, k, v, **kw),
            LLM_KERNEL_TOL, f"flash_attention {(B, T, S, Hq, Hkv, D)} {kw}"))
        for b in range(B) if valid else ():
            check(valid[b] or not out[b].any(),
                  f"flash_attention: row {b} has no live key and is not 0")
    # inputs x8: scores reach hundreds, and fp32 misses 2e-5 whatever its
    # order of sums, so the kernel and the plain version are each held
    # against float64
    split = {}
    for B, T, Hq, Hkv, D in ((LLM_BATCH, LLM_PROMPT, 14, 2, 64),
                             (2, LLM_PROMPT, 12, 2, 128)):
        q, k, v = (8 * randn(B, T, H, D) for H in (Hq, Hkv, Hkv))
        exact = exact_attention(q, k, v)
        out, plain = flash_attention_cuda(q, k, v), flash_attention_ref(q, k, v)
        err = (out.double() - exact).abs().max().item()
        plain_err = (plain.double() - exact).abs().max().item()
        split[D] = {"kernel_vs_float64": err, "plain_vs_float64": plain_err,
                    "kernel_vs_plain": (out - plain).abs().max().item()}
        check(err <= SPLIT_COST * plain_err,
              f"flash_attention x8 {(B, T, Hq, Hkv, D)}: {err} from float64, "
              f"the plain version {plain_err}")
        cases["flash_attention"] += 1
    print(f"phase 6: flash_attention on inputs x8, max |err| (bar: kernel "
          f"within {SPLIT_COST} x the plain version's error): {split}")
    # (B, S, Hq, Hkv, D): G = 7, 4, 1, 8; S off the page in two
    for B, S, Hq, Hkv, D in ((LLM_BATCH, LLM_MAX_LEN, 14, 2, 64),
                             (3, 1000, 14, 2, 64), (3, 1024, 8, 2, 64),
                             (3, 300, 4, 4, 128), (3, 200, 16, 2, 128)):
        page = auto_page_size(S) or DEFAULT_PAGE
        q, k, v = randn(B, 1, Hq, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D)
        rows = torch.tensor(([1, page, S] * B)[:B], dtype=torch.int32,
                            device="cuda")
        empty = torch.tensor(([0, S, 1] * B)[:B], dtype=torch.int32, device="cuda")
        for attend in (rows, LLM_PROMPT + LLM_NEW // 2 if S > LLM_PROMPT else S // 2,
                       empty):
            out = decode_attention_cuda(q, k, v, attend, page_size=page)
            plain = decode_attention_ref(q, k, v, attend)
            note("decode_attention", close_err(
                out, plain, LLM_KERNEL_TOL,
                f"decode_attention {(B, S, Hq, Hkv, D)} page {page} "
                f"attend {attend}"))
            if attend is empty:   # attend_len = 0 gives exactly 0 in both
                check(not out[::3].any() and not plain[::3].any(),
                      "decode_attention: a row with attend_len = 0 is not 0")
    # the split-K grid on this card: a scalar depth on a split boundary and
    # one off it, 1 and S; per-row depths on, before and after a boundary of
    # the (B,) grid (sized from S), 0 among them; B = 1 (under one wave)
    # and 32 (over it); and a cache poisoned with NaN past each row's depth
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B, S, Hq, Hkv, D in ((LLM_BATCH, LLM_MAX_LEN, 14, 2, 64),
                             (1, LLM_MAX_LEN, 14, 2, 64),
                             (32, LLM_MAX_LEN, 14, 2, 64), (3, 1000, 8, 1, 128),
                             (4, 256, 16, 4, 64), (6, 300, 4, 1, 128)):
        page = auto_page_size(S) or DEFAULT_PAGE
        q, k, v = randn(B, 1, Hq, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D)
        edge = next(a for a in range(S // 2, 0, -1)
                    if a % split_slots(B, a, Hkv, sms) == 0)
        split = split_slots(B, S, Hkv, sms)
        depths = [split, split - 1, split + 1, 0, S, 1, 2 * split + 3, S - 1]
        rows = torch.tensor([min(S, depths[i % len(depths)]) for i in range(B)],
                            dtype=torch.int32, device="cuda")
        for attend in (edge, edge - 1, edge + 1, 1, S, rows):
            out = decode_attention_cuda(q, k, v, attend, page_size=page)
            note("decode_attention", close_err(
                out, decode_attention_ref(q, k, v, attend), LLM_KERNEL_TOL,
                f"decode_attention {(B, S, Hq, Hkv, D)} split-K attend {attend}"))
        dead = torch.arange(S, device="cuda")[None, :] >= rows[:, None].long()
        kp, vp = (t.masked_fill(dead[:, :, None, None], float("nan")) for t in (k, v))
        out = decode_attention_cuda(q, kp, vp, rows, page_size=page)
        note("decode_attention", close_err(
            out, decode_attention_ref(q, k, v, rows), LLM_KERNEL_TOL,
            f"decode_attention {(B, S, Hq, Hkv, D)} NaN past attend {rows}"))
        for b in range(B):
            check(rows[b] > 0 or not out[b].any(),
                  f"decode_attention: row {b} has attend_len 0 and is not 0")
    torch.cuda.synchronize()
    print(f"phase 6: LLM kernels vs their plain versions, within "
          f"{LLM_KERNEL_TOL} abs + rel: cases {cases}, max |err| {errs}")
    return errs, split


def phase_llm_path(cfg, params, card):
    """The serving path through ServeEngine.generate at full width, launch
    counts from 0: one greedy call, then one sampled call."""
    L = cfg.n_layers
    prompts = np.random.RandomState(2).randint(0, cfg.vocab, (LLM_BATCH, LLM_PROMPT))
    eng = ServeEngine(cfg, params, max_len=LLM_MAX_LEN, seed=0)
    for kern in _build.KERNELS.values():
        kern.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    greedy = eng.generate([Request(tokens=p, max_new_tokens=LLM_NEW)
                           for p in prompts])
    generate_s = time.perf_counter() - t0
    sampled = eng.generate([Request(tokens=p, max_new_tokens=LLM_NEW,
                                    temperature=0.8) for p in prompts])
    torch.cuda.synchronize()
    launches = {n: _build.KERNELS[n].launches for n in LLM_KERNELS}
    print(f"phase 7: launches on the LLM serving path: {launches}")
    for n, count in launches.items():
        check(count > 0, f"kernel {n} was not launched on the LLM serving path")
    # each call: one prefill and steps - 1 decode steps, 2L + 1 norms each
    forwards = greedy[0].steps + sampled[0].steps
    expect = {"rmsnorm": (2 * L + 1) * forwards, "flash_attention": 2 * L,
              "decode_attention": L * (forwards - 2)}
    check(launches == expect, f"launches {launches}, expected {expect}")
    for c in greedy + sampled:
        check(c.steps == LLM_NEW and len(c.tokens) == LLM_NEW
              and c.tokens.min() >= 0 and c.tokens.max() < cfg.vocab,
              f"completion of {len(c.tokens)} tokens, {c.steps} steps")
    differ = sum(int(np.any(g.tokens != s.tokens)) for g, s in zip(greedy, sampled))
    check(differ > 0, "sampling at temperature 0.8 gave the greedy tokens")
    print(f"phase 7: {cfg.name} at full width ({L} layers, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab}): ServeEngine.generate of {LLM_BATCH} x "
          f"{LLM_PROMPT}-token prompts, {LLM_NEW} tokens each, greedy in "
          f"{generate_s:.3f} s; the sampled call differs from greedy on "
          f"{differ} of {LLM_BATCH} rows  [{card}]")
    return launches, {"generate_s": generate_s,
                      "greedy_tokens_row0": greedy[0].tokens.tolist()}


def cpu_margin(cfg, cpu, prompt, tokens, step: int):
    """The CPU's top-2 logit margin at decode position ``step`` of one row,
    fed its own greedy ``tokens``, and the top logit's size."""
    logits, cache, T = bb.prefill(cfg, cpu, {"tokens": torch.as_tensor(prompt[None])},
                                  max_len=CPU_MAX_LEN)
    for i in range(step):
        logits, cache = bb.decode_step(cfg, cpu, torch.tensor([[int(tokens[i])]]),
                                       cache, T + i)
    top = logits[0].topk(2).values
    return (top[0] - top[1]).item(), top[0].abs().item()


def phase_llm_vs_cpu(cfg, params):
    """The same params and prompts on the card and on the CPU: prefill
    logits within LLM_LOGIT_TOL, greedy tokens equal up to a near-tie."""
    cpu = tree_to(params, "cpu")
    prompts = np.random.RandomState(3).randint(0, cfg.vocab, (CPU_BATCH, CPU_PROMPT))
    lg, _, _ = bb.prefill(cfg, params, {"tokens": torch.as_tensor(prompts, device="cuda")},
                          max_len=CPU_MAX_LEN)
    lc, _, _ = bb.prefill(cfg, cpu, {"tokens": torch.as_tensor(prompts)},
                          max_len=CPU_MAX_LEN)
    diff = (lg.cpu() - lc).abs().max().item()
    print(f"phase 8: prefill logits |card - CPU| max {diff:.3e} "
          f"(B={CPU_BATCH}, T={CPU_PROMPT}; tolerance {LLM_LOGIT_TOL} abs + rel)")
    check(torch.allclose(lg.cpu(), lc, atol=LLM_LOGIT_TOL, rtol=LLM_LOGIT_TOL),
          f"prefill logits differ from the CPU run by {diff}")
    reqs = [Request(tokens=p, max_new_tokens=CPU_NEW) for p in prompts]
    card = ServeEngine(cfg, params, max_len=CPU_MAX_LEN).generate(reqs)
    host = ServeEngine(cfg, cpu, max_len=CPU_MAX_LEN, device="cpu").generate(reqs)
    same = 0
    for b, (c, h) in enumerate(zip(card, host)):
        split = np.flatnonzero(c.tokens != h.tokens)
        if split.size == 0:
            same += 1
            continue
        i = int(split[0])
        margin, top = cpu_margin(cfg, cpu, prompts[b], h.tokens, i)
        bar = 2 * (LLM_LOGIT_TOL + LLM_LOGIT_TOL * top)
        print(f"phase 8: row {b}: greedy tokens diverge at step {i}; the CPU's "
              f"top-2 margin there is {margin:.3e} (a swap needs < {bar:.3e})")
        check(margin <= bar, f"row {b} diverges at step {i} with a CPU top-2 "
              f"margin of {margin}, beyond the logit tolerance")
    print(f"phase 8: greedy tokens ({CPU_NEW} per row) equal on the card and "
          f"the CPU on {same} of {CPU_BATCH} rows")
    return {"prefill_logit_max_abs_diff_vs_cpu": diff,
            "greedy_rows_equal_vs_cpu": same}


def phase_llm_timing(cfg, params, launches, errs, card):
    """Each LLM kernel's time, its plain version's, one library call's and
    its bound at the main path's shapes; then the path itself."""
    B, T, L = LLM_BATCH, LLM_PROMPT, cfg.n_layers
    Hq, Hkv, D, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.d_model
    G, S, attend = Hq // Hkv, LLM_MAX_LEN, LLM_PROMPT + LLM_NEW // 2
    page = auto_page_size(S) or DEFAULT_PAGE
    gen = torch.Generator(device="cuda").manual_seed(4)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    x, scale = randn(B * T, d), 1 + 0.1 * randn(d)
    q, k, v = randn(B, T, Hq, D), randn(B, T, Hkv, D), randn(B, T, Hkv, D)
    qd, kc, vc = randn(B, 1, Hq, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D)
    # the library calls' layouts, made before any timing: heads first,
    # kv heads repeated to the query heads
    def heads_first(t, rep=1):
        return t.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()

    qt, kt, vt = heads_first(q), heads_first(k, G), heads_first(v, G)
    qdt, kct, vct = heads_first(qd), heads_first(kc, G), heads_first(vc, G)
    live = (torch.arange(S, device="cuda") < attend)[None, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_err = {
        "flash_attention": (sdpa(qt, kt, vt, is_causal=True).transpose(1, 2)
                            - flash_attention_cuda(q, k, v)).abs().max().item(),
        "decode_attention": (sdpa(qdt, kct, vct, attn_mask=live).transpose(1, 2)
                             - decode_attention_cuda(qd, kc, vc, attend,
                                                     page_size=page)).abs().max().item(),
    }
    print(f"phase 9: |library call - kernel| max, the same function: {lib_err}")
    pairs = B * Hq * T * (T + 1) // 2          # live (query, key) pairs, causal
    specs = [
        ("rmsnorm", "src/repro_torch/csrc/rmsnorm.cu",
         "src/repro/kernels/rmsnorm/kernel.py:25",
         lambda: rmsnorm_cuda(x, scale), lambda: rmsnorm_ref(x, scale),
         lambda: torch.nn.functional.rms_norm(x, (d,), scale, 1e-6),
         (2 * B * T * d + d) * 4, 4 * B * T * d),
        ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
         "src/repro/kernels/attention/kernel.py:78",
         lambda: flash_attention_cuda(q, k, v), lambda: flash_attention_ref(q, k, v),
         lambda: sdpa(qt, kt, vt, is_causal=True),
         (2 * B * T * Hq * D + 2 * B * T * Hkv * D) * 4, 4 * D * pairs),
        ("decode_attention", "src/repro_torch/csrc/decode_attention.cu",
         "src/repro/kernels/decode_attention/kernel.py:79",
         lambda: decode_attention_cuda(qd, kc, vc, attend, page_size=page),
         lambda: decode_attention_ref(qd, kc, vc, attend),
         lambda: sdpa(qdt, kct, vct, attn_mask=live),
         (2 * B * Hq * D + 2 * B * attend * Hkv * D) * 4, 4 * B * Hq * attend * D),
    ]
    rows = []
    for name, src, replaces, kern, plain, library, nbytes, ops in specs:
        bound_ms, bound_by = bound(nbytes, ops)
        ms, plain_ms, library_ms = time_ms(kern), time_ms(plain), time_ms(library)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": library_ms})
        print(f"phase 9: {name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
              f"{nbytes} B, {ops} ops), {launches[name]} launches on the "
              f"serving path  [{card}]")
    # decode attention with a (B,) attend_len: the grid is sized from S and
    # the splits past a row's depth exit at once
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows_main = torch.full((B,), attend, dtype=torch.int32, device="cuda")
    tiny = torch.zeros(4, device="cuda")
    split, split_rows = split_slots(B, attend, Hkv, sms), split_slots(B, S, Hkv, sms)
    decode_grid = {
        "scalar_split": split, "scalar_blocks": B * Hkv * -(-attend // split),
        "rows_split": split_rows, "rows_blocks": B * Hkv * -(-S // split_rows),
        "rows_live_blocks": B * Hkv * -(-attend // split_rows),
        "rows_ms": time_ms(lambda: decode_attention_cuda(qd, kc, vc, rows_main,
                                                         page_size=page)),
        # the split and the combine kernel; the combine is launched early
        # and its time includes its wait for the split kernel
        "kernels_us": device_kernels(lambda: decode_attention_cuda(
            qd, kc, vc, attend, page_size=page), match="decode_"),
        # what the events read for one trivial launch: the timing floor
        "one_launch_ms": time_ms(lambda: tiny.add_(1.0))}
    print(f"phase 9: decode_attention grid at attend {attend}: an int gives "
          f"{split}-slot splits, {decode_grid['scalar_blocks']} blocks (B * Hkv "
          f"= {B * Hkv}); a (B,) tensor {split_rows}-slot splits, "
          f"{decode_grid['rows_blocks']} blocks of which "
          f"{decode_grid['rows_live_blocks']} live, {decode_grid['rows_ms']:.4f} ms; "
          f"device us and launches per call by kernel (torch.profiler): "
          f"{decode_grid['kernels_us']}; one trivial launch reads "
          f"{decode_grid['one_launch_ms']:.4f} ms by the same events  [{card}]")
    # flash runs its fp32 products as three TF32 ones on the tensor cores
    flash_tc_ms = 3 * 4 * D * pairs / TF32_OPS_PER_S * 1e3
    # and the D = 128 instantiation at qwen2-1.5b's prefill shape
    q2, k2, v2 = randn(2, T, 12, 128), randn(2, T, 2, 128), randn(2, T, 2, 128)
    q2t, k2t, v2t = heads_first(q2), heads_first(k2, 6), heads_first(v2, 6)
    flash_d128 = {"ms": time_ms(lambda: flash_attention_cuda(q2, k2, v2)),
                  "library_ms": time_ms(lambda: sdpa(q2t, k2t, v2t, is_causal=True)),
                  "bound_ms": bound((2 * 2 * T * 12 * 128 + 2 * 2 * T * 2 * 128) * 4,
                                    4 * 128 * 2 * 12 * T * (T + 1) // 2)[0]}
    print(f"phase 9: flash_attention bound on the tensor cores (3 x TF32 "
          f"operations at {TF32_OPS_PER_S / 1e12:.0f} TFLOP/s): {flash_tc_ms:.4f} ms; "
          f"at qwen2-1.5b's prefill (2, {T}, 12/2, 128): kernel "
          f"{flash_d128['ms']:.4f} ms, SDPA {flash_d128['library_ms']:.4f} ms, "
          f"fp32 bound {flash_d128['bound_ms']:.4f} ms  [{card}]")

    # the path: prefill of B x T, then one decode step at depth T
    tokens = torch.as_tensor(np.random.RandomState(5).randint(0, cfg.vocab, (B, T)),
                             device="cuda")
    host = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, cache, _ = bb.prefill(cfg, params, {"tokens": tokens}, max_len=S)
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
    prefill_s = statistics.median(host)
    step_tok = tokens[:, :1]
    host = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bb.decode_step(cfg, params, step_tok, cache, T)
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
    step_s = statistics.median(host)
    hold = 200_000_000          # about 0.1 s: longer than any call's enqueue
    prefill_dev = time_ms(lambda: bb.prefill(cfg, params, {"tokens": tokens},
                                             max_len=S), reps=3, hold_cycles=hold)
    step_dev = time_ms(lambda: bb.decode_step(cfg, params, step_tok, cache, T),
                       reps=10, hold_cycles=hold)
    # the step's kernels by torch.profiler: their summed durations (the
    # device's busy time) and their count.  The events above span every
    # gap the host leaves once the launch queue fills behind the hold.
    step_kernels = device_kernels(lambda: bb.decode_step(cfg, params, step_tok,
                                                         cache, T), reps=5)
    step_busy = sum(us for us, _ in step_kernels.values()) / 1e3
    step_launches = sum(n for _, n in step_kernels.values())

    # one layer's parts at the prefill and the decode shape, device time
    p = params["blocks"][0]
    xp, xd = randn(B, T, d), randn(B, 1, d)
    hf = randn(B, T, cfg.d_ff)
    w = bb._readout_weight(cfg, params)

    def qkv(h):
        return project_qkv(p["attn"], h, n_heads=Hq, n_kv_heads=Hkv, head_dim=D)

    pos_p = torch.arange(T, device="cuda")[None, :]
    pos_d = torch.full((B, 1), T, device="cuda")
    parts = {
        "prefill": {
            "rmsnorm": (lambda: rmsnorm(p["norm"], xp), 2 * L + 1),
            "qkv_proj": (lambda: qkv(xp), L),
            "rope": (lambda: (apply_rope(q, pos_p, cfg.rope_theta),
                              apply_rope(k, pos_p, cfg.rope_theta)), L),
            "flash_attention": (lambda: flash_attention_cuda(q, k, v), L),
            "o_proj": (lambda: dense(p["attn"]["wo"], q.reshape(B, T, Hq * D)), L),
            "ffn_gate_up": (lambda: (dense(p["ffn"]["gate"], xp),
                                     dense(p["ffn"]["up"], xp)), L),
            "ffn_down": (lambda: dense(p["ffn"]["down"], hf), L),
            "readout": (lambda: xp[:, -1] @ w, 1),
        },
        "decode": {
            "rmsnorm": (lambda: rmsnorm(p["norm"], xd), 2 * L + 1),
            "qkv_proj": (lambda: qkv(xd), L),
            "rope": (lambda: (apply_rope(qd, pos_d, cfg.rope_theta),
                              apply_rope(qd[:, :, :Hkv], pos_d, cfg.rope_theta)), L),
            "decode_attention": (lambda: decode_attention_cuda(
                qd, kc, vc, attend, page_size=page), L),
            "o_proj": (lambda: dense(p["attn"]["wo"], qd.reshape(B, 1, Hq * D)), L),
            "ffn": (lambda: swiglu_ffn(p["ffn"], xd), L),
            "readout": (lambda: xd[:, 0] @ w, 1),
        },
    }
    breakdown = {}
    for phase, stages in parts.items():
        breakdown[phase] = {}
        for name, (fn, count) in stages.items():
            one = time_ms(fn, reps=10)
            breakdown[phase][name] = {"ms_each": one, "per_forward": count,
                                      "ms_per_forward": one * count}
        total = sum(v["ms_per_forward"] for v in breakdown[phase].values())
        print(f"phase 9: {phase} by part (ms per forward, device, L2 flushed "
              f"before each): " + ", ".join(
                  f"{n} {v['ms_per_forward']:.3f} ({v['per_forward']} x "
                  f"{v['ms_each']:.4f})" for n, v in breakdown[phase].items())
              + f"; sum {total:.3f}  [{card}]")
    path = {"prefill_host_ms": prefill_s * 1e3, "prefill_device_ms": prefill_dev,
            "prefill_tokens_per_s": B * T / prefill_s,
            "decode_step_host_ms": step_s * 1e3, "decode_step_device_ms": step_dev,
            "decode_tokens_per_s": B / step_s,
            "flash_tensor_core_bound_ms": flash_tc_ms, "flash_d128": flash_d128,
            "decode_grid": decode_grid,
            "decode_device_idle_share": 1 - step_dev / (step_s * 1e3),
            "decode_step_kernel_ms": step_busy,
            "decode_step_kernels": step_launches,
            "decode_busy_share": step_busy / (step_s * 1e3),
            "prefill_device_idle_share": 1 - prefill_dev / (prefill_s * 1e3),
            "breakdown": breakdown}
    print(f"phase 9: prefill B={B} x T={T}: {prefill_s * 1e3:.3f} ms host "
          f"({path['prefill_tokens_per_s']:.0f} tokens/s), {prefill_dev:.3f} ms "
          f"device; decode step B={B} at depth {T}: {step_s * 1e3:.3f} ms host "
          f"({path['decode_tokens_per_s']:.1f} tokens/s), {step_dev:.3f} ms device "
          f"(device idle {path['decode_device_idle_share']:.1%} of the step); "
          f"its {step_launches:.0f} kernels run {step_busy:.3f} ms by torch.profiler "
          f"({path['decode_busy_share']:.1%} of the host time)  [{card}]")
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
            if "registers" in line or "spill" in line or "properties" in line:
                print(f"phase 2: {name}: {line.strip()}")
    sass = sass_counts(libs)
    print(f"phase 2: SASS instructions (cuobjdump -sass): {sass}")

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

    llm_errs, llm_split = phase_llm_kernels()
    llm_cfg = get_config(LLM_ARCH)
    t0 = time.perf_counter()
    llm_params = bb.init_params(llm_cfg, seed=0)
    init_s = time.perf_counter() - t0
    print(f"phase 7: {LLM_ARCH} seed-0 params ({llm_cfg.param_dtype}, drawn on "
          f"the CPU, moved to the card) in {init_s:.1f} s")
    llm_launches, llm_path = phase_llm_path(llm_cfg, llm_params, card)
    llm_checks = phase_llm_vs_cpu(llm_cfg, llm_params)
    llm_rows, llm_timing = phase_llm_timing(llm_cfg, llm_params, llm_launches,
                                            llm_errs, card)
    rows += llm_rows

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "device": device, "build_s": build_s,
                       "sass": sass,
                       "config": {"image_size": cfg.image_size, "batch": BATCH},
                       "kernels": rows, "path": path, "checks": path_checks,
                       "llm": {"arch": LLM_ARCH, "batch": LLM_BATCH,
                               "prompt": LLM_PROMPT, "new_tokens": LLM_NEW,
                               "max_len": LLM_MAX_LEN, "init_s": init_s,
                               "path": llm_path, "checks": llm_checks,
                               "flash_x8_errors": llm_split,
                               "timing": llm_timing}},
                      f, indent=1)
    print(f"card: {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
