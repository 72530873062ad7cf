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
     flushed), its plain version's, its bound, its device duration from
     torch.profiler and the share of its bound by that duration, and
     images/s of the path;
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
  9. each LLM kernel's time, its plain version's, the library call's, its
     bound and its torch.profiler duration (decode attention also with a
     (B,) attend_len, its grid sized from S, and its two kernels' device
     times); prefill and decode tokens/s, the decode step's kernels and
     their summed device time from torch.profiler, and the time by part;
  the multi-client offload gateway (slice 5):
 10. the pinned fleets of benchmarks/gateway.py (32 clients, mixed links,
     6 requests, W = 8; static and SLO = 30 ms) and the chaos run of
     benchmarks/faults.py (16 clients, 150 ms deadlines) at 96x96 through
     ``Fleet`` / ``OffloadGateway``, with every launch count set to 0
     just before and read just after (one offload_fused per fleet
     build); every request resolved on the ladder; the static logits
     against one batched pass, per-image ``agile_forward`` and pool width
     2 on the card, and the same fleet on the port's CPU (indices and
     simulated rows equal, logits within 1e-3); the fleet build (device
     pass, LZW sweep), run() and clients/s, ``gateway.codec_ms``, one
     W = 8 Remote-NN batch and its copies, the card's busy share over
     run(), and the simulated rows;
  AgileNN training (slice 6):
 11. (a) the permute's autograd Function at 96^2's (B = 32) feature rows:
     forward, backward (the kernel with the inverse permutation) and
     double backward bitwise equal to ``index_select``'s, three launches,
     and ``extract_features`` carrying the gradient to the extractor;
     (b) one ``agile_loss`` value-and-grad at ``AgileNNConfig()``, B = 8,
     on the card against the same machine's CPU (TRAIN_GRAD_TOL); (c) joint
     steps at 96^2 at the largest B <= 64 that fits: median step (batches
     on the card before the clock), images/s, peak memory, and a
     torch.profiler split (IG passes, outer backward, GroupNorm by
     ablation); the quantize kernel on a timed batch's STE input, bitwise
     against its plain version; (d) ``run_full_pipeline`` at
     ``AgileNNConfig()``, B = 64, with reduced step counts, launch counts
     from 0 and checked exactly, its report, and the predictions kept
     across ``finalize_for_deployment``; then, bitwise against their plain
     versions, the quantize kernel on a stage-C batch's STE input and the
     fused offload pass on evaluate's first batch (128 images).
  the continuous scheduler (slice 7):
 12. (a) flash attention at a staged segment's shape (B = 1, T = 128,
     S in {256, 512}, every q_offset the bucket stages) and a bucketed
     group prefill's (B = 4, ragged kv_valid_len), decode attention on the
     16-row pool with depths spread over its splits, and RMSNorm at the
     path's rows (16, 128, 256, 512 of d = 896), against their plain
     versions (atol = rtol = 2e-5); (b) qwen2-0.5b at full width through
     ``ServeEngine(max_len=1024, scheduler=SCHED_CFG).generate`` on 48
     requests (prompts 16-512, budgets 8-64, greedy), launch counts from
     0 and checked exactly against the forwards the run made (the
     backbone's prefill / prefill_chunk / decode_step wrapped with
     counters), its wall time and tokens/s (no profiler), rounds, decode
     steps run and live, host time by telemetry span; the card's busy
     share over eight rounds of a second run under torch.profiler, against
     that window's own wall time; one decode step alone at the pool's
     shape, host ms against its kernels' ms; (c) overlap off giving exactly
     the same tokens, every 4th request against its decode alone, a
     deadline eviction under a fake clock (a prefix of its run), a
     suspend/resume, 6 requests on the card against the port's CPU, and
     a sampled queue repeating itself under one seed.  Token checks pass
     equal or at a near-tie (phase 8's rule).

Prints the card line, a {"kernels": [...]} line, and last
{"ok": true, "device": {...}}.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import (  # noqa: E402
    fp32_math,
    tree_leaves,
    tree_map,
    tree_to,
    value_and_grad,
)
from repro_torch.compress.quantize import dequantize  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.agilenn_cifar import AgileNNConfig  # noqa: E402
from repro_torch.core.agile import (  # noqa: E402
    agile_forward,
    agile_loss,
    device_forward_fn,
    extract_features,
    init_agile_params,
    offload_payload_arrays,
    remote_forward,
)
from repro_torch.data.synthetic import ImageDatasetSpec, SyntheticImages  # noqa: E402
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
from repro_torch.kernels.quantize.ops import quantize_op  # noqa: E402
from repro_torch.kernels.quantize.ref import quantize_ref  # noqa: E402
from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402
from repro_torch.kernels.topk_split.kernel import channel_permute_cuda  # noqa: E402
from repro_torch.kernels.topk_split.ops import channel_permute_op  # noqa: E402
from repro_torch.kernels.topk_split.ref import channel_permute_ref  # noqa: E402
from repro_torch.models import backbone as bb  # noqa: E402
from repro_torch.models.cnn import (  # noqa: E402
    extractor_apply,
    local_nn_apply,
    reference_nn_apply,
    reference_nn_init,
    remote_nn_apply,
)
from repro_torch.nn.activations import swiglu_ffn  # noqa: E402
from repro_torch.nn.attention import project_qkv  # noqa: E402
from repro_torch.nn.linear import conv2d, dense  # noqa: E402
from repro_torch.nn.norm import groupnorm, rmsnorm  # noqa: E402
from repro_torch.nn.rope import apply_rope  # noqa: E402
from repro_torch.optim.sgd import sgd_init  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.faults import (  # noqa: E402
    Blackout,
    BurstLoss,
    FaultInjector,
    GatewayStall,
    PayloadCorruption,
)
from repro_torch.serve.gateway import (  # noqa: E402
    Fleet,
    GatewayConfig,
    OffloadGateway,
    mixed_fleet,
)
from repro_torch.serve.gateway import gateway as gateway_mod  # noqa: E402
from repro_torch.serve.offload import measure_payload, run_offload_inference  # noqa: E402
from repro_torch.serve.scheduler import ContinuousScheduler, SchedulerConfig  # noqa: E402
from repro_torch.serve.telemetry import Telemetry  # noqa: E402
from repro_torch.train import agile_pipeline  # noqa: E402
from repro_torch.train.agile_pipeline import joint_step, run_full_pipeline  # noqa: E402

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

# the offload gateway: the pinned fleets of benchmarks/gateway.py (32
# clients, mixed links, 6 requests, W = 8) and benchmarks/faults.py (16
# clients, 150 ms deadlines, the chaos schedule)
GATEWAY_CLIENTS, GATEWAY_REQS, GATEWAY_WIDTH = 32, 6, 8
FAULT_CLIENTS, FAULT_DEADLINE_MS = 16, 150.0
GATEWAY_LADDER = {"served", "degraded", "shed", "rejected", "fallback"}
GATEWAY_TRACE_FIELDS = ("client", "req", "channel", "bits", "keep", "payload_bytes",
                        "attempts", "t_born", "t_sent", "t_arrive", "t_serve",
                        "t_done", "e2e_s", "energy_j", "status", "deadline_missed")
# gateway logits on the card against the same requests at other batch
# shapes (one pass of 192, batch 1, pool width 2): cuDNN may choose another
# algorithm per shape, so they are held to a bar, not bitwise
GATEWAY_BATCH_TOL = 1e-4

# AgileNN training: AgileNNConfig() (32^2) and the paper's 96^2, full
# widths (reference NN 96 x 8 blocks), ig_steps 16
TRAIN_DEVICE = "cuda"
TRAIN_CFG, TRAIN_CFG_96 = AgileNNConfig(), AgileNNConfig(image_size=96)
TRAIN_KERNELS = ("topk_split", "quantize", "offload_fused")
# agile_loss value-and-grad, the card against the CPU at B = 8: fp32 sums in
# another order (cuDNN vs the CPU) through 8 reference blocks, 16 IG steps
# and a second derivative; the loss and each gradient leaf within
# TRAIN_GRAD_TOL of the CPU's largest |value| (the CPU is within 1e-5 of
# JAX at small widths, tests/test_torch_train.py)
TRAIN_LOSS_B, TRAIN_GRAD_TOL = 8, 1e-3
# the timed joint step at 96^2: the largest batch whose peak, predicted
# from the peaks at B = 4 and 8, fits TRAIN_MEM_FRACTION of the card
TRAIN_BATCHES, TRAIN_MEM_FRACTION, TRAIN_TIMED_STEPS = (64, 32, 16, 8), 0.9, 3
# run_full_pipeline at 32^2, B = 64, its 300 + 400 steps cut to the phase's time
PIPE_BATCH, PIPE_PRETRAIN, PIPE_JOINT = 64, 40, 12

# the continuous scheduler: qwen2-0.5b at full width through
# ServeEngine(max_len=1024, scheduler=SCHED_CFG); 48 requests, prompt
# lengths in [16, 512] and budgets in [8, 64], all greedy
SCHED_CFG = SchedulerConfig(buckets=(64, 128, 256, 512), max_slots=16,
                            prefill_group=4, chunk=8, page_size=32,
                            prefill_segment=128)
SCHED_REQS, SCHED_SEED = 48, 3
# the sampled rerun takes the queue's first 16 (its rounds run twice)
SCHED_SAMPLED = 16
# a second run of the queue, its rounds SCHED_PROF_FROM + 1 .. +
# SCHED_PROF_ROUNDS traced by torch.profiler (the card's busy share)
SCHED_PROF_FROM, SCHED_PROF_ROUNDS = 40, 8
# the decode step timed alone at the pool's shape: 16 rows at these depths
SCHED_STEP_DEPTHS = tuple(range(16, 577, 37))
# the same scheduler on the card and on the CPU: 6 requests of 16-200
# tokens, 12 new tokens each, 64-token segments
SCHED_CPU_LENS, SCHED_CPU_NEW, SCHED_CPU_SEGMENT = (16, 40, 64, 100, 150, 200), 12, 64


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


def device_kernels(fn, reps: int = 20, match: str = "", flush: bool = False) -> dict:
    """{kernel name: (device us per call, launches per call)} of the
    kernels of ``fn`` whose names hold ``match``, over ``reps`` calls, from
    torch.profiler's device events ({} if it records none): the kernels'
    own durations, without the gaps between them.  ``flush`` clears the
    L2 before each call, as ``time_ms`` does (the fill kernel's name holds
    no kernel name of the port)."""
    from torch.profiler import ProfilerActivity, profile
    buf = torch.empty(64 << 20, dtype=torch.int32, device="cuda") if flush else None
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if buf is not None:
                buf.zero_()
            fn()
        torch.cuda.synchronize()
    return {key: (us / reps, n / reps)
            for key, (us, n) in profiled_kernels(prof, match).items()}


def profiled_kernels(prof, match: str = "") -> dict:
    """{kernel name: (device us, launches)} of a finished torch.profiler
    run, for the kernels whose names hold ``match``."""
    out = {}
    for evt in prof.key_averages():
        if (getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA
                or match not in evt.key):
            continue
        total = getattr(evt, "device_time_total", None)
        total = total if total is not None else evt.cuda_time_total
        out[evt.key] = (total, evt.count)
    return out


def profiled_share(fn, match: str, bound_ms: float) -> dict:
    """The summed torch.profiler durations per call of the kernels of
    ``fn`` named ``match`` (L2 flushed before each call, without the CUDA
    events' floor), and the share of ``bound_ms`` they reach."""
    us = sum(t for t, _ in device_kernels(fn, match=match, flush=True).values())
    check(us > 0, f"torch.profiler recorded no device time for {match}")
    return {"us": us, "bound_share": bound_ms * 1e3 / us}


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
    kernel_us = {}
    for name, src, replaces, kern, plain, library, nbytes, ops in specs:
        bound_ms, bound_by = bound(nbytes, ops)
        ms, plain_ms = time_ms(kern), time_ms(plain)
        library_ms = time_ms(library) if library else None
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": library_ms})
        kernel_us[name] = profiled_share(kern, f"{name}_kernel", bound_ms)
        print(f"phase 5: {name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {library_ms if library_ms is None else f'{library_ms:.4f}'} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}, {nbytes} B, {ops} ops), "
              f"{launches[name]} launches on the main path; by torch.profiler "
              f"{kernel_us[name]['us']:.2f} us, {kernel_us[name]['bound_share']:.1%} "
              f"of its bound  [{card}]")
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
            "kernel_profiler_us": kernel_us,
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


def top2_margin(cfg, params, prompt, tokens, step: int, max_len: int = CPU_MAX_LEN):
    """The top-2 logit margin at decode position ``step`` of one row, fed
    its own greedy ``tokens`` on the params' device (the card or the CPU),
    and the top logit's size."""
    dev = params["embed"]["table"].device
    logits, cache, T = bb.prefill(cfg, params,
                                  {"tokens": torch.as_tensor(prompt[None], device=dev)},
                                  max_len=max_len)
    for i in range(step):
        logits, cache = bb.decode_step(
            cfg, params, torch.tensor([[int(tokens[i])]], device=dev), cache, T + i)
    top = logits[0].topk(2).values
    return (top[0] - top[1]).item(), top[0].abs().item()


def near_tie(cfg, params, prompt, ref, got, what: str, max_len: int = CPU_MAX_LEN):
    """``got`` equals the greedy tokens ``ref`` (decoded from ``params``) up
    to its length, or the first divergence sits on a near-tie of ``ref``'s
    run: a top-2 margin within what LLM_LOGIT_TOL of difference can swap.
    Returns the step of the divergence, None when there is none."""
    n = min(len(ref), len(got))
    split = np.flatnonzero(np.asarray(ref[:n]) != np.asarray(got[:n]))
    if split.size == 0:
        return None
    i = int(split[0])
    margin, top = top2_margin(cfg, params, prompt, ref, i, max_len)
    bar = 2 * (LLM_LOGIT_TOL + LLM_LOGIT_TOL * top)
    print(f"{what}: greedy tokens diverge at step {i}; the top-2 margin of "
          f"the reference there is {margin:.3e} (a swap needs < {bar:.3e})")
    check(margin <= bar, f"{what}: diverges at step {i} with a top-2 margin "
          f"of {margin}, beyond the logit tolerance")
    return i


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
        near_tie(cfg, cpu, prompts[b], h.tokens, c.tokens, f"phase 8: row {b}")
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
    rows, kernel_us = [], {}
    # the kernels' names in torch.profiler; decode attention is two kernels
    prof_names = {"rmsnorm": "rmsnorm_kernel",
                  "flash_attention": "flash_attention_kernel",
                  "decode_attention": "decode_"}
    for name, src, replaces, kern, plain, library, nbytes, ops in specs:
        bound_ms, bound_by = bound(nbytes, ops)
        ms, plain_ms, library_ms = time_ms(kern), time_ms(plain), time_ms(library)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": library_ms})
        kernel_us[name] = profiled_share(kern, prof_names[name], bound_ms)
        print(f"phase 9: {name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
              f"{nbytes} B, {ops} ops), {launches[name]} launches on the "
              f"serving path; by torch.profiler {kernel_us[name]['us']:.2f} us, "
              f"{kernel_us[name]['bound_share']:.1%} of its bound  [{card}]")
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
            "decode_grid": decode_grid, "kernel_profiler_us": kernel_us,
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


def gateway_rows(static, adaptive, chaos) -> dict:
    """The simulated rows of benchmarks/gateway.py and of the chaos run of
    benchmarks/faults.py, from the port's reports."""
    return {
        "gateway.e2e_latency_p50_ms": static.latency_percentile_ms(50),
        "gateway.e2e_latency_p99_ms": static.latency_percentile_ms(99),
        "gateway.device_energy_mj": static.device_energy_mj,
        "gateway.adaptive_e2e_latency_p99_ms": adaptive.latency_percentile_ms(99),
        "gateway.adaptive_payload_bytes": adaptive.summary()["payload_bytes_mean"],
        "gateway.adaptive_device_energy_mj": adaptive.device_energy_mj,
        "faults.fallback_rate": chaos.fallback_rate,
        "faults.deadline_miss_rate": chaos.deadline_miss_rate,
        "faults.degraded_rate": chaos.degraded_rate,
        "faults.e2e_p99_ms": chaos.latency_percentile_ms(99),
    }


def trace_key(report) -> list:
    return [tuple(getattr(t, f) for f in GATEWAY_TRACE_FIELDS) for t in report.traces]


def logits_by_request(report) -> dict:
    return {(t.client, t.req): t.logits for t in report.traces}


def max_delta(a: dict, b: dict) -> float:
    """The largest |difference| between two requests -> logits maps."""
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)


def resolved(report, n: int, what: str) -> None:
    """Every request of the fleet resolved once, on one rung of the ladder."""
    keys = {(t.client, t.req) for t in report.traces}
    statuses = {t.status for t in report.traces}
    check(len(report.traces) == n and len(keys) == n,
          f"{what}: {len(report.traces)} traces for {n} requests")
    check(statuses <= GATEWAY_LADDER, f"{what}: statuses {statuses} off the ladder")


def phase_gateway(cfg, params, card):
    """The offload gateway through Fleet / OffloadGateway at full width,
    launch counts from 0: the benchmark's pinned fleets (static, SLO = 30
    ms, chaos), then its numbers and its logits against one batched pass,
    per-image agile_forward, another pool width and the port's CPU run."""
    W = GATEWAY_WIDTH
    n_static = GATEWAY_CLIENTS * GATEWAY_REQS

    def fleet(slo_ms=None, n_clients=GATEWAY_CLIENTS, deadline_ms=None, p=params):
        return Fleet(cfg, p, mixed_fleet(n_clients, n_requests=GATEWAY_REQS,
                                         slo_ms=slo_ms, deadline_ms=deadline_ms),
                     seed=0)

    def chaos_injector():
        return FaultInjector((Blackout(0.05, 0.25),
                              BurstLoss(0.0, 1.0, p_good_bad=0.2, p_bad_good=0.3),
                              PayloadCorruption(0.0, 1.0, prob=0.25),
                              GatewayStall(0.10, 0.30, stall_s=0.02)), seed=7)

    from torch.profiler import ProfilerActivity, profile
    for kern in _build.KERNELS.values():
        kern.launches = 0
    torch.cuda.synchronize()
    builds = 0
    OffloadGateway(cfg, params, fleet(), GatewayConfig(batch_width=W)).run()  # warm-up
    builds += 1
    timed = []
    for _ in range(2):                       # best of two, as the benchmark
        timed.append(OffloadGateway(cfg, params, fleet(),
                                    GatewayConfig(batch_width=W)).run())
        builds += 1
    static = min(timed, key=lambda r: r.wall_s)
    tel = Telemetry(enabled=True)
    OffloadGateway(cfg, params, fleet(), GatewayConfig(batch_width=W),
                   telemetry=tel).run()
    builds += 1
    gw = OffloadGateway(cfg, params, fleet(), GatewayConfig(batch_width=W))
    builds += 1
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled = gw.run()
        torch.cuda.synchronize()
    adaptive = OffloadGateway(cfg, params, fleet(slo_ms=30.0),
                              GatewayConfig(batch_width=W)).run()
    narrow = OffloadGateway(cfg, params, fleet(), GatewayConfig(batch_width=2)).run()
    chaos = OffloadGateway(cfg, params, fleet(n_clients=FAULT_CLIENTS,
                                              deadline_ms=FAULT_DEADLINE_MS),
                           GatewayConfig(batch_width=W), faults=chaos_injector()).run()
    builds += 3
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in _build.KERNELS.items()}
    expect = {n: builds if n == "offload_fused" else 0 for n in _build.KERNELS}
    print(f"phase 10: launches on the gateway path ({builds} fleet builds): "
          f"{launches}")
    check(launches == expect, f"gateway launches {launches}, expected {expect}")
    for report, n, what in ((static, n_static, "static"), (profiled, n_static, "profiled"),
                            (adaptive, n_static, "adaptive"), (narrow, n_static, "W=2"),
                            (chaos, FAULT_CLIENTS * GATEWAY_REQS, "chaos")):
        resolved(report, n, what)
    check(trace_key(profiled) == trace_key(static) == trace_key(timed[0]),
          "same-seed static runs do not replay")
    check(all(np.isfinite(t.logits).all() and t.logits.shape == (cfg.n_classes,)
              for t in static.traces), "static gateway logits not finite/expected")

    # the card's busy share over run(), and the host's share of it
    busy_us = sum(us for us, _ in profiled_kernels(prof).values())
    codec = tel.histogram("gateway.codec_ms", bounds=gateway_mod._MS_BOUNDS)
    batches = tel.histogram("gateway.batch_size",
                            bounds=tuple(float(w) for w in range(1, W + 1)))

    # the fleet build's two parts: the device pass and the first LZW sweep
    f0 = fleet()
    dev = f0.device
    images = torch.from_numpy(f0.images).to(dev)
    dev_fn = device_forward_fn(cfg, params)
    device_pass_ms = time_ms(lambda: dev_fn(params, images), reps=10)
    device_pass_us = sum(us for us, _ in device_kernels(
        lambda: dev_fn(params, images), reps=5).values())
    t0 = time.perf_counter()
    fleet()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    f0._encoded_rows(f0.full_bits, f0.n_remote)
    lzw_s = time.perf_counter() - t0
    # one W = 8 Remote-NN batch on the card, and its copies each way
    deq = np.random.RandomState(0).standard_normal(
        (W, f0.feat_hw, f0.feat_hw, f0.n_remote)).astype(np.float32)
    ll = f0.local_logits[:W].copy()
    deq_d, ll_d = torch.from_numpy(deq).to(dev), torch.from_numpy(ll).to(dev)
    batch_ms = time_ms(lambda: remote_forward(cfg, params, deq_d, ll_d), reps=20)
    batch_kernels = device_kernels(lambda: remote_forward(cfg, params, deq_d, ll_d),
                                   reps=10)
    out_d = remote_forward(cfg, params, deq_d, ll_d)
    h2d, d2h, whole = [], [], []
    for _ in range(50):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.from_numpy(deq).to(dev), torch.from_numpy(ll).to(dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out_d.cpu().numpy()
        t2 = time.perf_counter()
        # one whole batch as _batch_logits runs it: H2D, remote_forward, D2H
        remote_forward(cfg, params, torch.from_numpy(deq).to(dev),
                       torch.from_numpy(ll).to(dev)).cpu().numpy()
        whole.append(time.perf_counter() - t2)
        d2h.append(t2 - t1)
        h2d.append(t1 - t0)
    numbers = {
        "fleet_build_s": build_s, "device_pass_ms": device_pass_ms,
        "device_pass_kernel_ms": device_pass_us / 1e3, "lzw_sweep_s": lzw_s,
        "run_wall_s": static.wall_s, "clients_per_s": static.clients_per_s,
        "run_wall_s_all": [r.wall_s for r in timed],
        "codec_ms_p50": codec.p50(), "codec_ms_total": codec.total,
        "remote_batches": batches.count, "remote_batch_ms": batch_ms,
        "remote_batch_kernel_ms": sum(us for us, _ in batch_kernels.values()) / 1e3,
        "remote_batch_kernels": sum(n for _, n in batch_kernels.values()),
        "remote_batch_host_ms": statistics.median(whole) * 1e3,
        "h2d_us": statistics.median(h2d) * 1e6, "d2h_us": statistics.median(d2h) * 1e6,
        "run_kernel_ms": busy_us / 1e3, "profiled_run_wall_s": profiled.wall_s,
        "busy_share": busy_us / 1e6 / static.wall_s,
        "rows": gateway_rows(static, adaptive, chaos),
    }
    print(f"phase 10: fleet of {n_static} requests at {cfg.image_size}^2: build "
          f"{build_s:.3f} s, device pass {device_pass_ms:.3f} ms by events, its "
          f"kernels {device_pass_us / 1e3:.3f} ms by torch.profiler; first LZW sweep "
          f"(static framing) {lzw_s:.3f} s  [{card}]")
    print(f"phase 10: run() of the static fleet, W={W}: {static.wall_s:.3f} s "
          f"(best of {[round(r.wall_s, 4) for r in timed]}), {static.clients_per_s:.1f} "
          f"clients/s; gateway.codec_ms p50 {codec.p50():.3f} ms over "
          f"{codec.count} batches (sum {codec.total:.1f} ms); one W={W} Remote-NN "
          f"batch {batch_ms:.4f} ms on the card by events, its "
          f"{numbers['remote_batch_kernels']:.0f} kernels "
          f"{numbers['remote_batch_kernel_ms']:.4f} ms by torch.profiler, "
          f"{numbers['remote_batch_host_ms']:.3f} ms on the host with its copies "
          f"(H2D {numbers['h2d_us']:.1f} us + D2H {numbers['d2h_us']:.1f} us); the card's "
          f"kernels over a profiled run() {busy_us / 1e3:.2f} ms, busy "
          f"{numbers['busy_share']:.2%} of the best run()  [{card}]")
    print(f"phase 10: simulated rows at {cfg.image_size}^2: {numbers['rows']}")

    # the static run's logits against one batched pass over the same images,
    # per-image agile_forward, and pool width 2; all on the card
    rows_of = {(c.index, j): c.row0 + j for c in f0.clients for j in range(GATEWAY_REQS)}
    got = logits_by_request(static)
    ll_all, _, idx_all = dev_fn(params, images)
    one_pass = remote_forward(cfg, params, dequantize(params["quant"], idx_all),
                              ll_all).cpu().numpy()
    per_image = {key: agile_forward(cfg, params, f0.images[r:r + 1])[0].cpu().numpy()[0]
                 for key, r in rows_of.items()}
    narrow_got = logits_by_request(narrow)
    deltas = {
        "vs_one_pass": max_delta(got, {k: one_pass[r] for k, r in rows_of.items()}),
        "vs_per_image": max_delta(got, per_image),
        "width_2_vs_8": max_delta(got, narrow_got),
    }
    bitwise = {
        "vs_one_pass": all(got[k].tobytes() == one_pass[r].tobytes()
                           for k, r in rows_of.items()),
        "vs_per_image": all(got[k].tobytes() == per_image[k].tobytes() for k in rows_of),
        "width_2_vs_8": all(got[k].tobytes() == narrow_got[k].tobytes() for k in rows_of),
    }
    print(f"phase 10: static gateway logits on the card, max |delta| {deltas}, "
          f"bitwise {bitwise} (bar {GATEWAY_BATCH_TOL} abs + rel)")
    for name, ref in (("one batched pass", {k: one_pass[r] for k, r in rows_of.items()}),
                      ("per-image agile_forward", per_image), ("pool width 2", narrow_got)):
        check(all(np.allclose(got[k], ref[k], atol=GATEWAY_BATCH_TOL,
                              rtol=GATEWAY_BATCH_TOL) for k in rows_of),
              f"gateway logits vs {name} beyond {GATEWAY_BATCH_TOL}")
        check(all(int(np.argmax(got[k])) == int(np.argmax(ref[k])) for k in rows_of),
              f"gateway predictions differ from {name}")

    # the same static fleet on the port's CPU
    cpu = tree_to(params, "cpu")
    t0 = time.perf_counter()
    f_cpu = fleet(p=cpu)
    r_cpu = OffloadGateway(cfg, cpu, f_cpu, GatewayConfig(batch_width=W)).run()
    cpu_s = time.perf_counter() - t0
    flips = int((f_cpu.idx != f0.idx).sum())
    same_rows = trace_key(r_cpu) == trace_key(static)
    got_cpu = logits_by_request(r_cpu)
    cpu_diff = max_delta(got, got_cpu)
    print(f"phase 10: the static fleet on the port's CPU ({cpu_s:.1f} s): index flips "
          f"{flips} of {f0.idx.size}, simulated rows equal: {same_rows}, logits "
          f"|card - CPU| max {cpu_diff:.3e} (bar {LOGIT_TOL} abs + rel)")
    check(flips == 0 and same_rows, "the card's fleet differs from the CPU's")
    check(all(np.allclose(got[k], got_cpu[k], atol=LOGIT_TOL, rtol=LOGIT_TOL)
              for k in rows_of), f"gateway logits differ from the CPU run by {cpu_diff}")
    return launches, {**numbers, "builds": builds, "logit_deltas": deltas,
                      "bitwise": bitwise, "cpu_index_flips": flips,
                      "cpu_logit_max_abs_diff": cpu_diff, "cpu_run_s": cpu_s}


# ------------------------------------------------- AgileNN training (slice 6)
def _trainable(params):
    return {k: v for k, v in params.items() if k != "mapping"}


def _reference_params(cfg, seed: int):
    """The reference NN, seed-drawn on the CPU, on the training device."""
    return tree_to(reference_nn_init(
        torch.Generator().manual_seed(seed), cfg.extractor_channels, cfg.n_classes,
        width=cfg.reference_width, blocks=cfg.reference_blocks), TRAIN_DEVICE)


def _system(cfg, seed: int = 0):
    """Seed-drawn joint params with a shuffled mapping and a reference NN."""
    params = init_agile_params(cfg, seed=seed, device=TRAIN_DEVICE)
    params["mapping"] = tuple(int(p) for p in np.random.RandomState(seed).permutation(
        cfg.extractor_channels))
    return params, _reference_params(cfg, seed + 1)


def train_permute_check(cfg, params, images):
    """(a) The permute Function on the card: forward, backward (the kernel
    with the inverse permutation) and the backward's backward, bitwise
    against index_select and its gradients; three launches of the kernel;
    and the extracted features carry the gradient to the extractor."""
    C = cfg.extractor_channels
    N = images.shape[0] * (cfg.image_size // 4) ** 2
    gen = torch.Generator(device=TRAIN_DEVICE).manual_seed(11)
    perm = tuple(int(p) for p in np.random.RandomState(11).permutation(C))
    perm_t = torch.tensor(perm, device=TRAIN_DEVICE)
    x, g = (torch.randn(N, C, generator=gen, device=TRAIN_DEVICE).requires_grad_()
            for _ in range(2))
    v = torch.randn(N, C, generator=gen, device=TRAIN_DEVICE)
    kern = _build.KERNELS["topk_split"]
    before = kern.launches
    y = channel_permute_op(x, perm)
    (gx,) = torch.autograd.grad(y, x, g, create_graph=True)
    (gg,) = torch.autograd.grad(gx, g, v)
    torch.cuda.synchronize()
    launches = kern.launches - before
    xr = x.detach().requires_grad_()
    yr = torch.index_select(xr, 1, perm_t)
    (gxr,) = torch.autograd.grad(yr, xr, g.detach())
    ggr = torch.index_select(v, 1, perm_t)
    same = {"forward": torch.equal(y, yr), "backward": torch.equal(gx, gxr),
            "double_backward": torch.equal(gg, ggr)}
    check(all(same.values()), f"the permute Function differs from index_select: {same}")
    check(launches == 3, f"the permute Function launched the kernel {launches} times, "
          f"expected 3 (forward, backward, double backward)")
    live = {**params, "extractor": tree_map(lambda t: t.detach().requires_grad_(),
                                            params["extractor"])}
    feats = extract_features(cfg, live, images[:2])
    check(feats.requires_grad, "extract_features carries no gradient on the card")
    (gw,) = torch.autograd.grad(feats.square().sum(), live["extractor"]["convs"][0]["w"])
    check(bool(torch.isfinite(gw).all()) and gw.abs().max().item() > 0,
          "no gradient reached the extractor through the permute")
    print(f"phase 11a: permute Function at ({N}, {C}): forward, backward and double "
          f"backward bitwise equal to index_select's ({launches} launches); "
          f"extract_features requires grad, extractor grad max "
          f"{gw.abs().max().item():.3e}")
    return {"rows": N, "bitwise": same, "launches": launches}


def train_loss_vs_cpu(cfg, card):
    """(b) One agile_loss value-and-grad on the card against the same
    machine's CPU, the same params, batch and labels."""
    params, ref = _system(cfg)
    data = SyntheticImages(ImageDatasetSpec(image_size=cfg.image_size, seed=0))
    images, _ = data.batch(TRAIN_LOSS_B, seed=5)
    cpu_params, cpu_ref = tree_to(params, "cpu"), tree_to(ref, "cpu")
    with torch.no_grad():     # right on the even rows, wrong on the odd ones
        pred = reference_nn_apply(cpu_ref, extract_features(cfg, cpu_params, images))
    pred = pred.argmax(-1).numpy()
    labels = np.where(np.arange(len(pred)) % 2 == 0, pred, (pred + 1) % cfg.n_classes)

    def run(p, r):
        return value_and_grad(
            lambda q: agile_loss(cfg, {**q, "mapping": p["mapping"]}, r, images,
                                 labels), _trainable(p))

    with fp32_math():
        run(params, ref)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (loss, metrics), grads = run(params, ref)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    (loss_c, metrics_c), grads_c = run(cpu_params, cpu_ref)
    cpu_s = time.perf_counter() - t0
    loss_err = abs(loss.item() - loss_c.item())
    check(math.isfinite(loss.item()) and loss_err <= TRAIN_GRAD_TOL * max(1.0, abs(loss_c.item())),
          f"agile_loss {loss.item()} on the card vs {loss_c.item()} on the CPU")
    for key in ("xai_valid_fraction", "accuracy"):
        check(metrics[key].item() == metrics_c[key].item(),
              f"{key} {metrics[key].item()} on the card vs {metrics_c[key].item()}")
    worst, worst_leaf = 0.0, 0
    leaves_card = tree_leaves(grads)
    for i, (gc, gp) in enumerate(zip(leaves_card, tree_leaves(grads_c))):
        scale = gp.abs().max().item()
        err = (gc.cpu() - gp).abs().max().item() / max(scale, 1e-30)
        if err > worst:
            worst, worst_leaf = err, i
        check(math.isfinite(err) and err <= TRAIN_GRAD_TOL,
              f"agile_loss gradient leaf {i} differs from the CPU by {err:.3e} of its scale")
    print(f"phase 11b: agile_loss at {cfg.image_size}^2, B={TRAIN_LOSS_B}, ig_steps "
          f"{cfg.agile.ig_steps}: {loss.item():.6f} on the card, {loss_c.item():.6f} on "
          f"the CPU (|d| {loss_err:.3e}); {len(leaves_card)} gradient leaves, worst "
          f"|card - CPU| {worst:.3e} of the leaf's largest |gradient| (leaf {worst_leaf}; "
          f"bar {TRAIN_GRAD_TOL}); valid fraction {metrics['xai_valid_fraction'].item()}; "
          f"{card_s * 1e3:.1f} ms on the card, {cpu_s:.2f} s on the CPU  [{card}]")
    return {"loss": loss.item(), "loss_cpu": loss_c.item(), "loss_abs_err": loss_err,
            "grad_worst_rel_err": worst, "valid_fraction": metrics["xai_valid_fraction"].item(),
            "card_ms": card_s * 1e3, "cpu_s": cpu_s}


def train_kernel_checks(cfg, params, images, what: str, *, fused: bool = False):
    """The kernels of the training path against their plain versions on
    the card, at the shapes that path hands them: the STE's hard half on
    the Remote-NN channels of ``params``' features of ``images``
    (``quantize_ste``'s input), and with ``fused`` the offload pass on
    the raw extractor rows (``evaluate``'s deployment forward), each
    bitwise.  Returns {kernel: {"rows": N, "max_abs_err": 0.0}}."""
    k, C = cfg.agile.k, cfg.extractor_channels
    centers = params["quant"]["centers"].detach()
    with torch.no_grad(), fp32_math():
        remote = extract_features(cfg, params, images)[..., k:].contiguous()
        out = {"quantize": {"rows": remote.numel() // (C - k), "max_abs_err": max_err(
            quantize_op(remote, centers), quantize_ref(remote, centers))}}
        if fused:
            raw = extractor_apply(params["extractor"], images)
            out["offload_fused"] = {"rows": raw.numel() // C, "max_abs_err": max_err(
                fused_offload(raw, centers, perm=params["mapping"], k=k),
                [t.contiguous() for t in offload_fused_ref(raw, centers,
                                                           params["mapping"], k)])}
    print(f"phase 11{what}: on the training path's own inputs "
          f"({tuple(images.shape)} images), each kernel bit-exact with its plain "
          f"version: {out}")
    return out


def kernel_split(prof) -> tuple[dict, int]:
    """Device us of one profiled joint step by the profiler ranges the
    port opens: the IG passes (``xai.integrated_gradients``), the outer
    backward (``value_and_grad.backward`` inside ``joint_step.agile_loss``)
    and the rest.  A kernel counts where the op that launched it started
    on the host (the autograd thread's ops run while the main thread waits
    inside its range).  Returns (split, kernels)."""
    events = prof.events()
    ranges = {}
    for e in events:
        if (e.device_type == torch.autograd.DeviceType.CPU and e.name in
                ("xai.integrated_gradients", "value_and_grad.backward",
                 "joint_step.agile_loss")):
            ranges.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))

    def inside(t, name):
        return any(a <= t <= b for a, b in ranges.get(name, ()))

    split, n = {"ig_passes": 0.0, "outer_backward": 0.0, "rest": 0.0}, 0
    for e in events:
        if not e.kernels:
            continue
        t = e.time_range.start
        key = ("ig_passes" if inside(t, "xai.integrated_gradients") else
               "outer_backward" if (inside(t, "value_and_grad.backward")
                                    and inside(t, "joint_step.agile_loss")) else "rest")
        split[key] += sum(k.duration for k in e.kernels)
        n += len(e.kernels)
    return split, n


def train_step_96(cfg, card):
    """(c) Joint steps at 96^2, full widths, ig_steps 16, at the largest
    B in TRAIN_BATCHES that fits the card (from the peaks of B = 4 and 8);
    median step, images/s, peak memory and the profiler split."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import cnn

    params, ref = _system(cfg)
    mapping = params["mapping"]
    data = SyntheticImages(ImageDatasetSpec(image_size=cfg.image_size, seed=0))
    state = {"p": _trainable(params), "r": ref}
    state["o"], state["ro"] = sgd_init(state["p"]), sgd_init(ref)

    def batch(B, i):
        images, labels = data.batch(B, seed=i)
        return (torch.as_tensor(images, device=TRAIN_DEVICE),
                torch.as_tensor(labels, device=TRAIN_DEVICE).long())

    def step(x, y, keep=True):
        with fp32_math():
            p, o, r, ro, loss, metrics = joint_step(
                cfg, state["p"], state["o"], state["r"], state["ro"], x, y,
                mapping=mapping, lr=0.02)
        if keep:
            state.update(p=p, o=o, r=r, ro=ro)
        return loss

    total = torch.cuda.get_device_properties(0).total_memory
    peaks = {}
    for B in (4, 8):
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step(*batch(B, 0), keep=False)
        torch.cuda.synchronize()
        peaks[B] = torch.cuda.max_memory_allocated() - base
    per_image = (peaks[8] - peaks[4]) / 4
    fixed = peaks[4] - 4 * per_image
    predicted = {B: base + fixed + B * per_image for B in TRAIN_BATCHES}
    fits = [B for B in TRAIN_BATCHES if predicted[B] <= TRAIN_MEM_FRACTION * total]
    check(fits, f"no batch of {TRAIN_BATCHES} fits: {predicted}")
    B = max(fits)
    print(f"phase 11c: joint step at {cfg.image_size}^2: peak {peaks[4] / 2**30:.2f} / "
          f"{peaks[8] / 2**30:.2f} GiB at B = 4 / 8, so {per_image / 2**20:.0f} MiB per "
          f"image ({per_image / cfg.agile.ig_steps / 2**20:.1f} MiB per image per IG "
          f"step); predicted GiB {({b: round(v / 2**30, 1) for b, v in predicted.items()})} "
          f"of {total / 2**30:.1f}: B = {B}")
    torch.cuda.empty_cache()
    step(*batch(B, 1))
    # the timed steps' batches are drawn and on the card before the clock
    timed = [batch(B, 2 + i) for i in range(TRAIN_TIMED_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for x, y in timed:
        t0 = time.perf_counter()
        loss = step(x, y)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    check(math.isfinite(loss.item()), f"joint step loss {loss.item()}")
    kernel_checks = train_kernel_checks(cfg, {**state["p"], "mapping": mapping},
                                        timed[-1][0], "c")
    profiled = batch(B, 10)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(*profiled)
        torch.cuda.synchronize()
    split, n_kernels = kernel_split(prof)
    busy_us = sum(split.values())
    if not busy_us:
        print("phase 11c: torch.profiler recorded no device time: the split is "
              "not measured")
    # GroupNorm's kernels: the same step with every GroupNorm the identity
    saved = cnn.groupnorm
    cnn.groupnorm = lambda params, x, *, groups: x
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof_ng:
            step(*profiled, keep=False)
            torch.cuda.synchronize()
    finally:
        cnn.groupnorm = saved
    ng = profiled_kernels(prof_ng).values()
    busy_ng, n_ng = sum(us for us, _ in ng), sum(n for _, n in ng)
    med = statistics.median(times)
    out = {"image_size": cfg.image_size, "batch": B, "ig_steps": cfg.agile.ig_steps,
           "step_s": times, "median_ms": med * 1e3, "images_per_s": B / med,
           "peak_bytes": peak, "probe_peak_bytes": peaks, "per_image_bytes": per_image,
           "predicted_bytes": predicted, "kernel_us": busy_us, "kernels": n_kernels,
           "split_us": split, "busy_share": busy_us / 1e6 / med,
           "groupnorm_us": busy_us - busy_ng, "no_groupnorm_kernels": n_ng,
           "groupnorm_share": (busy_us - busy_ng) / busy_us if busy_us else None,
           "kernel_checks": kernel_checks}
    print(f"phase 11c: joint step at {cfg.image_size}^2, B = {B}, ig_steps "
          f"{cfg.agile.ig_steps}: median {med * 1e3:.1f} ms of {[round(t * 1e3, 1) for t in times]} "
          f"(host clock, batches already on the card), {B / med:.1f} images/s, peak {peak / 2**30:.2f} GiB "
          f"(max_memory_allocated); torch.profiler: {n_kernels} kernels, "
          f"{busy_us / 1e3:.1f} ms (busy {out['busy_share']:.1%}): IG passes "
          f"{split['ig_passes'] / 1e3:.1f} ms, outer backward "
          f"{split['outer_backward'] / 1e3:.1f} ms, rest {split['rest'] / 1e3:.1f} ms; "
          f"GroupNorm (the step's kernels minus those of the step with GroupNorm the "
          f"identity, {n_ng} kernels) {out['groupnorm_us'] / 1e3:.1f} ms = "
          f"{out['groupnorm_share'] or 0:.1%}  [{card}]")
    return out


def train_pipeline(cfg, card):
    """(d) ``run_full_pipeline`` through its entry point, launch counts
    from 0; the report, and the predictions across
    ``finalize_for_deployment``."""
    captured = {}
    finalize = agile_pipeline.finalize_for_deployment

    def spy(c, params):
        captured["before"] = params
        return finalize(c, params)

    for kern in _build.KERNELS.values():
        kern.launches = 0
    agile_pipeline.finalize_for_deployment = spy
    try:
        t0 = time.perf_counter()
        params, ref, report, history, data = run_full_pipeline(
            cfg, seed=0, pretrain_steps=PIPE_PRETRAIN, joint_steps=PIPE_JOINT,
            batch_size=PIPE_BATCH)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        agile_pipeline.finalize_for_deployment = finalize
    launches = {n: _build.KERNELS[n].launches for n in TRAIN_KERNELS}
    expected = {"topk_split": 3 * PIPE_JOINT, "quantize": PIPE_JOINT, "offload_fused": 4}
    print(f"phase 11d: launches on the training path: {launches} (expected {expected}: "
          f"per joint step the permute forward and backward and the reference "
          f"tracking's forward, the STE's hard half; one fused pass per evaluate batch)")
    check(launches == expected, f"training-path launches {launches}, expected {expected}")
    check(all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in report.values()),
          f"report {report}")
    check(all(math.isfinite(r["loss"]) for r in history), "non-finite joint loss")
    # a stage-C batch through the trained params' STE input, and evaluate's
    # first batch (128 images) through the deployed and the trained params
    joint_x = agile_pipeline._batch(data, PIPE_BATCH, 20_000 + PIPE_JOINT - 1,
                                    TRAIN_DEVICE)[0]
    eval_x = agile_pipeline._batch(data, 128, 900_000, TRAIN_DEVICE)[0]
    kernel_checks = {"joint": train_kernel_checks(cfg, captured["before"], joint_x, "d"),
                     "evaluate": train_kernel_checks(cfg, params, eval_x, "d", fused=True),
                     "evaluate_trained_mapping": train_kernel_checks(
                         cfg, captured["before"], eval_x, "d", fused=True)}
    images, _ = data.batch(PIPE_BATCH, seed=777)
    with torch.no_grad(), fp32_math():
        before, _ = agile_forward(cfg, captured["before"], images)
        after, _ = agile_forward(cfg, params, images)
    delta = (before - after).abs().max().item()
    same_pred = torch.equal(before.argmax(-1), after.argmax(-1))
    check(same_pred and delta <= GATEWAY_BATCH_TOL,
          f"finalize_for_deployment moved the logits by {delta} (predictions equal: {same_pred})")
    print(f"phase 11d: run_full_pipeline at {cfg.image_size}^2, B = {PIPE_BATCH}, "
          f"{PIPE_PRETRAIN} pretrain + {PIPE_JOINT} joint steps: {wall_s:.1f} s; report "
          f"{report}; joint loss {history[0]['loss']:.4f} -> {history[-1]['loss']:.4f}; "
          f"finalize_for_deployment: predictions equal, logits |d| {delta:.3e}  [{card}]")
    return launches, {"wall_s": wall_s, "report": report, "launches": launches,
                      "loss_first": history[0]["loss"], "loss_last": history[-1]["loss"],
                      "finalize_logit_delta": delta, "kernel_checks": kernel_checks}


def phase_train(card):
    """Phase 11: the training path (a)-(d); returns (launches, numbers)."""
    t0 = time.perf_counter()
    cfg96 = TRAIN_CFG_96
    params96, _ = _system(cfg96)
    images = torch.as_tensor(SyntheticImages(ImageDatasetSpec(
        image_size=cfg96.image_size, seed=0)).batch(32, seed=1)[0], device=TRAIN_DEVICE)
    numbers = {"permute": train_permute_check(cfg96, params96, images)}
    del params96, images
    parts = {"a": time.perf_counter() - t0}
    numbers["loss_vs_cpu"] = train_loss_vs_cpu(TRAIN_CFG, card)
    parts["b"] = time.perf_counter() - t0 - sum(parts.values())
    numbers["step_96"] = train_step_96(cfg96, card)
    torch.cuda.empty_cache()
    parts["c"] = time.perf_counter() - t0 - sum(parts.values())
    launches, numbers["pipeline"] = train_pipeline(TRAIN_CFG, card)
    parts["d"] = time.perf_counter() - t0 - sum(parts.values())
    numbers["phase_s"], numbers["part_s"] = time.perf_counter() - t0, parts
    print(f"phase 11: {numbers['phase_s']:.1f} s, by part "
          f"{ {k: round(v, 1) for k, v in parts.items()} }")
    return launches, numbers


def sched_queue(cfg, temps=None):
    """The phase's 48 requests: lengths, budgets and tokens from one seed."""
    rng = np.random.RandomState(SCHED_SEED)
    lens = rng.randint(16, 513, SCHED_REQS)
    new = rng.randint(8, 65, SCHED_REQS)
    temps = temps or [0.0] * SCHED_REQS
    return [Request(tokens=rng.randint(0, cfg.vocab, L), max_new_tokens=int(n),
                    temperature=t) for L, n, t in zip(lens, new, temps)]


class FakeClock:
    """A clock that advances one second at every read."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 1.0
        return self.t


def sched_kernel_checks(cfg):
    """The three kernels at the scheduler's shapes against their plain
    versions on the card: flash at a staged segment (B = 1, T = 128 at
    every q_offset a 256- or 512-slot bucket stages) and a bucketed group
    prefill (B = 4, ragged kv_valid_len, a dummy row of 1); decode
    attention on the pool (16 rows, depths spread over the splits, one
    at 1); RMSNorm at the rows each forward normalises (16 for the pool's
    decode, 128 for a segment, 4 x 64 and 4 x 128 for a group)."""
    gen = torch.Generator(device="cuda").manual_seed(12)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    seg, S_pool = SCHED_CFG.prefill_segment, 1024
    errs, cases = {"flash_attention": 0.0, "decode_attention": 0.0,
                   "rmsnorm": 0.0}, 0
    for S in (256, 512):
        for off in range(0, S, seg):
            q, k, v = (randn(1, seg, Hq, D), randn(1, S, Hkv, D),
                       randn(1, S, Hkv, D))
            errs["flash_attention"] = max(errs["flash_attention"], close_err(
                flash_attention_cuda(q, k, v, q_offset=off),
                flash_attention_ref(q, k, v, q_offset=off), LLM_KERNEL_TOL,
                f"flash_attention staged segment S={S} q_offset={off}"))
            cases += 1
    for T, valid in ((128, [128, 70, 1, 100]), (64, [64, 33, 17, 1])):
        q, k, v = randn(4, T, Hq, D), randn(4, T, Hkv, D), randn(4, T, Hkv, D)
        vl = torch.tensor(valid, device="cuda")
        errs["flash_attention"] = max(errs["flash_attention"], close_err(
            flash_attention_cuda(q, k, v, kv_valid_len=vl),
            flash_attention_ref(q, k, v, kv_valid_len=vl), LLM_KERNEL_TOL,
            f"flash_attention group prefill T={T} kv_valid_len={valid}"))
        cases += 1
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    split = split_slots(SCHED_CFG.max_slots, S_pool, Hkv, sms)
    depths = [1] + [min(S_pool, 17 + i * (S_pool - 17) // 14) for i in range(15)]
    depths[5], depths[9] = split, split + 1
    rows = torch.tensor(depths, dtype=torch.int32, device="cuda")
    q = randn(SCHED_CFG.max_slots, 1, Hq, D)
    kc, vc = (randn(SCHED_CFG.max_slots, S_pool, Hkv, D) for _ in range(2))
    errs["decode_attention"] = close_err(
        decode_attention_cuda(q, kc, vc, rows, page_size=auto_page_size(S_pool)),
        decode_attention_ref(q, kc, vc, rows), LLM_KERNEL_TOL,
        f"decode_attention pool depths {depths}")
    norm_rows = (SCHED_CFG.max_slots, seg, 4 * 64, 4 * 128)
    for N in norm_rows:
        x, sc = randn(N, cfg.d_model) * 3, 1 + 0.1 * randn(cfg.d_model)
        errs["rmsnorm"] = max(errs["rmsnorm"], close_err(
            rmsnorm_cuda(x, sc), rmsnorm_ref(x, sc), LLM_KERNEL_TOL,
            f"rmsnorm N={N} d={cfg.d_model}"))
    print(f"phase 12a: {cases} flash cases, the pool's decode (depths "
          f"{depths}, {split}-slot splits) and RMSNorm at {norm_rows} rows of "
          f"{cfg.d_model} against the plain versions within "
          f"{LLM_KERNEL_TOL} abs + rel: max |err| {errs}")
    return errs


def count_forwards():
    """Wrap the backbone's three forwards with call counters; returns the
    counts and a function that unwraps them."""
    calls = {"prefill": 0, "prefill_chunk": 0, "decode_step": 0}
    real = {n: getattr(bb, n) for n in calls}

    def wrap(name):
        def counted(*a, **kw):
            calls[name] += 1
            return real[name](*a, **kw)
        return counted

    for n in calls:
        setattr(bb, n, wrap(n))
    return calls, lambda: [setattr(bb, n, f) for n, f in real.items()]


def phase_sched(cfg, params, card):
    """Phase 12: the continuous scheduler at full width; returns (launches,
    numbers)."""
    from torch.profiler import ProfilerActivity, profile
    t_phase = time.perf_counter()
    errs = sched_kernel_checks(cfg)
    L = cfg.n_layers
    reqs = sched_queue(cfg)

    # (b) the queue through the entry point, launch counts from 0, no
    # profiler: its wall time gives tokens/s; each round's wall time is kept
    tel = Telemetry(enabled=True)
    eng = ServeEngine(cfg, params, max_len=LLM_MAX_LEN, scheduler=SCHED_CFG,
                      telemetry=tel)
    sched = eng.scheduler
    round_s = []

    def timed_step(step=sched.step):
        t = time.perf_counter()
        out = step()
        round_s.append(time.perf_counter() - t)
        return out

    sched.step = timed_step
    calls, unwrap = count_forwards()
    for kern in _build.KERNELS.values():
        kern.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    unwrap()
    launches = {n: _build.KERNELS[n].launches for n in LLM_KERNELS}
    del sched.step
    steps, live = sched.steps_run, sched.steps_live()
    forwards = calls["prefill"] + calls["prefill_chunk"] + calls["decode_step"]
    expect = {"rmsnorm": (2 * L + 1) * forwards,
              "flash_attention": L * (calls["prefill"] + calls["prefill_chunk"]),
              "decode_attention": L * calls["decode_step"]}
    print(f"phase 12b: launches on the scheduler path: {launches} (expected "
          f"{expect}: {calls['prefill']} group prefills, {calls['prefill_chunk']} "
          f"staged segments, {calls['decode_step']} decode steps)")
    check(launches == expect, f"scheduler launches {launches}, expected {expect}")
    check(calls["decode_step"] == steps, f"{calls['decode_step']} decode steps, "
          f"the scheduler counts {steps}")
    for n, c in launches.items():
        check(c > 0, f"kernel {n} was not launched on the scheduler path")
    check(calls["prefill_chunk"] > 0, "no admission staged")
    tokens = [c.tokens.tolist() for c in outs]
    for r, c in zip(reqs, outs):
        check(len(c.tokens) == r.max_new_tokens and not c.timed_out
              and min(c.tokens) >= 0 and max(c.tokens) < cfg.vocab,
              f"completion of {len(c.tokens)} tokens for a budget of "
              f"{r.max_new_tokens}")
    generated = sum(len(t) for t in tokens)
    spans = {}
    for sp in tel.trace.by_track("scheduler"):
        spans[sp.name] = spans.get(sp.name, 0.0) + sp.dur
    counters = {f"{c.name}{dict(c.labels) or ''}": c.value
                for c in tel.metrics.instruments() if c.name.startswith("sched.")}
    print(f"phase 12b: {cfg.name} at full width: ServeEngine.generate of "
          f"{SCHED_REQS} requests (prompts {min(len(r.tokens) for r in reqs)}-"
          f"{max(len(r.tokens) for r in reqs)}, budgets "
          f"{min(r.max_new_tokens for r in reqs)}-{max(r.max_new_tokens for r in reqs)}) "
          f"in {run_s:.3f} s, no profiler, {generated} tokens, "
          f"{generated / run_s:.1f} tokens/s; "
          f"{sched._round} rounds, {steps} decode steps run, {live} with a live "
          f"row; host s by span {{{', '.join(f'{k}: {v:.3f}' for k, v in spans.items())}}}; "
          f"counters {counters}  [{card}]")

    # the card's busy share: a second run of the queue, its rounds
    # SCHED_PROF_FROM + 1 .. + SCHED_PROF_ROUNDS under torch.profiler
    # (device activity only), the card drained before and after them, the
    # kernels' time against the window's own wall time; the run stops there
    prof_sched = ContinuousScheduler(cfg, params, sched=SCHED_CFG,
                                     max_len=LLM_MAX_LEN)
    for r in reqs:
        prof_sched.submit(r)
    for _ in range(SCHED_PROF_FROM):
        prof_sched.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(SCHED_PROF_ROUNDS):
            prof_sched.step()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    del prof_sched
    kernels = profiled_kernels(prof)
    busy_s = sum(us for us, _ in kernels.values()) / 1e6
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    check(busy_s > 0, "torch.profiler recorded no device time over the window")
    rounds = [SCHED_PROF_FROM + 1, SCHED_PROF_FROM + SCHED_PROF_ROUNDS]
    busy = {"rounds": rounds, "kernel_s": busy_s, "window_s": window_s,
            "share": busy_s / window_s,
            "same_rounds_untraced_s": sum(round_s[rounds[0] - 1:rounds[1]]),
            "launches": sum(n for _, n in kernels.values()),
            "top_us": {k[:60]: [us, n] for k, (us, n) in top}}
    print(f"phase 12b: a second run, rounds {rounds[0]}-{rounds[1]} under "
          f"torch.profiler: kernels {busy_s:.3f} s in the window's "
          f"{window_s:.3f} s, busy {busy['share']:.1%} (the same rounds took "
          f"{busy['same_rounds_untraced_s']:.3f} s in the untraced run); "
          f"{busy['launches']} kernels, the largest (us, launches): "
          f"{busy['top_us']}  [{card}]")
    del prof

    # one decode step alone at the pool's shape: host time around
    # synchronised calls, and its kernels by torch.profiler
    dev = params["embed"]["table"].device
    cache = bb.init_cache(cfg, SCHED_CFG.max_slots, LLM_MAX_LEN, device=dev)
    step_tok = torch.as_tensor(np.random.RandomState(SCHED_SEED).randint(
        0, cfg.vocab, (SCHED_CFG.max_slots, 1)), device=dev)
    depth = torch.tensor(SCHED_STEP_DEPTHS, device=dev)

    def pool_step():
        return bb.decode_step(cfg, params, step_tok, cache, depth)

    host = []
    for _ in range(11):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pool_step()
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
    step_kernels = device_kernels(pool_step, reps=5)
    del cache
    pool = {"depths": list(SCHED_STEP_DEPTHS),
            "host_ms": statistics.median(host[1:]) * 1e3,
            "kernel_ms": sum(us for us, _ in step_kernels.values()) / 1e3,
            "launches": sum(n for _, n in step_kernels.values())}
    check(pool["kernel_ms"] > 0, "torch.profiler recorded no device time for "
          "the pool's decode step")
    print(f"phase 12b: one decode step at the pool's shape ({SCHED_CFG.max_slots} "
          f"rows, depths {SCHED_STEP_DEPTHS[0]}-{SCHED_STEP_DEPTHS[-1]}): "
          f"{pool['host_ms']:.3f} ms on the host (median of 10 synchronised "
          f"calls) against {pool['kernel_ms']:.3f} ms of kernels by "
          f"torch.profiler ({pool['launches']:.0f} launches); in generate a "
          f"decode step costs {spans.get('decode_chunk', 0.0) / steps * 1e3:.3f} "
          f"ms of host  [{card}]")

    # (c) overlap off: the same tokens exactly
    t0 = time.perf_counter()
    serial = ServeEngine(cfg, params, max_len=LLM_MAX_LEN,
                         scheduler=dataclasses.replace(SCHED_CFG, overlap=False)
                         ).generate(reqs)
    torch.cuda.synchronize()
    serial_s = time.perf_counter() - t0
    check([c.tokens.tolist() for c in serial] == tokens,
          "overlap=False gave other tokens than overlap=True")
    # every 4th request alone through the equal-length path
    alone_eng = ServeEngine(cfg, params, max_len=LLM_MAX_LEN)
    diverged = {}
    for i in range(0, SCHED_REQS, 4):
        ref = alone_eng.generate([reqs[i]])[0].tokens
        step = near_tie(cfg, params, reqs[i].tokens, ref, tokens[i],
                        f"phase 12c: request {i} alone", max_len=LLM_MAX_LEN)
        if step is not None:
            diverged[i] = step
    print(f"phase 12c: overlap=False ({serial_s:.3f} s) gives the same tokens "
          f"exactly; {SCHED_REQS // 4} requests decoded alone through the "
          f"equal-length path equal the scheduler's except at near-ties "
          f"{diverged}")
    # a fake clock: one request evicted mid-decode, one neighbour untouched
    sch = ContinuousScheduler(cfg, params, sched=SCHED_CFG, max_len=LLM_MAX_LEN,
                              clock=FakeClock())
    long_i = next(i for i, r in enumerate(reqs)
                  if r.max_new_tokens >= 40 and len(r.tokens) <= 128)
    late = sch.submit(dataclasses.replace(reqs[long_i], deadline_s=3.5))
    keep = sch.submit(reqs[long_i + 1])
    res = sch.run()
    cut = res[late].tokens.tolist()
    check(res[late].timed_out and 0 < len(cut) < reqs[long_i].max_new_tokens,
          f"the deadline did not evict mid-decode: {len(cut)} tokens, "
          f"timed_out {res[late].timed_out}")
    near_tie(cfg, params, reqs[long_i].tokens, tokens[long_i], cut,
             "phase 12c: deadline-evicted request", max_len=LLM_MAX_LEN)
    near_tie(cfg, params, reqs[long_i + 1].tokens, tokens[long_i + 1],
             res[keep].tokens.tolist(), "phase 12c: its neighbour",
             max_len=LLM_MAX_LEN)
    check(not res[keep].timed_out, "the neighbour timed out")
    # suspend after two rounds, resume, finish
    sch = ContinuousScheduler(cfg, params, sched=SCHED_CFG, max_len=LLM_MAX_LEN)
    rid = sch.submit(reqs[long_i])
    sch.step()
    sch.step()
    sus = sch.suspend(rid)
    check(sus is not None and 0 < len(sus.generated) < reqs[long_i].max_new_tokens,
          "the suspended request had finished")
    resumed = sch.submit_suspended(sus)
    res = sch.run()
    near_tie(cfg, params, reqs[long_i].tokens, tokens[long_i],
             res[resumed].tokens.tolist(), "phase 12c: suspended and resumed",
             max_len=LLM_MAX_LEN)
    check(len(res[resumed].tokens) == reqs[long_i].max_new_tokens,
          "the resumed request did not finish its budget")
    print(f"phase 12c: request {long_i} evicted by its deadline after "
          f"{len(cut)} of {reqs[long_i].max_new_tokens} tokens (a prefix of its "
          f"run), its neighbour untouched; suspended after "
          f"{len(sus.generated)} tokens and resumed to its run's tokens")
    # the card against the port's CPU
    cpu = tree_to(params, "cpu")
    cpu_cfg = dataclasses.replace(SCHED_CFG, prefill_segment=SCHED_CPU_SEGMENT)
    rng = np.random.RandomState(SCHED_SEED + 1)
    small = [Request(tokens=rng.randint(0, cfg.vocab, n), max_new_tokens=SCHED_CPU_NEW)
             for n in SCHED_CPU_LENS]
    on_card = ServeEngine(cfg, params, max_len=LLM_MAX_LEN,
                          scheduler=cpu_cfg).generate(small)
    t0 = time.perf_counter()
    on_cpu = ServeEngine(cfg, cpu, max_len=LLM_MAX_LEN, scheduler=cpu_cfg,
                         device="cpu").generate(small)
    cpu_s = time.perf_counter() - t0
    same = 0
    for i, (c, h) in enumerate(zip(on_card, on_cpu)):
        same += near_tie(cfg, cpu, small[i].tokens, h.tokens, c.tokens,
                         f"phase 12c: card vs CPU, request {i}") is None
    del cpu
    print(f"phase 12c: {len(small)} requests ({SCHED_CPU_LENS} tokens, "
          f"{SCHED_CPU_NEW} new, {SCHED_CPU_SEGMENT}-token segments): the card's "
          f"greedy tokens equal the port's CPU's ({cpu_s:.1f} s) on {same}")
    # the queue's first SCHED_SAMPLED requests, temperature 0.8 on every
    # other one, twice with one seed
    temps = [0.8 if i % 2 else 0.0 for i in range(SCHED_REQS)]
    sampled = [[c.tokens.tolist() for c in ServeEngine(
        cfg, params, max_len=LLM_MAX_LEN, scheduler=SCHED_CFG, seed=7).generate(
            sched_queue(cfg, temps)[:SCHED_SAMPLED])] for _ in range(2)]
    check(sampled[0] == sampled[1], "a sampled queue does not repeat under one seed")
    differ = sum(a != b for a, b in zip(sampled[0][1::2], tokens[1::2]))
    check(differ > 0, "sampling at temperature 0.8 gave the greedy tokens")
    print(f"phase 12c: the first {SCHED_SAMPLED} requests with temperature 0.8 on "
          f"every other one repeat themselves under one seed; {differ} of "
          f"{SCHED_SAMPLED // 2} sampled rows differ from greedy")
    numbers = {"run_s": run_s, "tokens": generated, "tokens_per_s": generated / run_s,
               "rounds": sched._round, "steps_run": steps, "steps_live": live,
               "forwards": calls, "span_host_s": spans, "counters": counters,
               "busy": busy, "pool_step": pool, "serial_run_s": serial_s,
               "alone_near_ties": diverged, "deadline_tokens": len(cut),
               "cpu_equal_rows": same, "cpu_s": cpu_s, "kernel_errs": errs,
               "phase_s": time.perf_counter() - t_phase}
    print(f"phase 12: {numbers['phase_s']:.1f} s")
    return launches, numbers


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

    t_start = time.perf_counter()
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
    gw_launches, gw = phase_gateway(cfg, params, card)
    train_launches, train = phase_train(card)
    sched_launches, sched = phase_sched(llm_cfg, llm_params, card)
    for row in rows:               # the kernels' launches over every path
        row["launches"] += (gw_launches[row["name"]]
                            + train_launches.get(row["name"], 0)
                            + sched_launches.get(row["name"], 0))
        row["max_abs_err"] = max(row["max_abs_err"],
                                 sched["kernel_errs"].get(row["name"], 0.0))

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
                               "timing": llm_timing},
                       "gateway": {"clients": GATEWAY_CLIENTS,
                                   "requests_per_client": GATEWAY_REQS,
                                   "width": GATEWAY_WIDTH, **gw},
                       "train": train, "scheduler": sched},
                      f, indent=1)
    print(f"chip_smoke: phases 1-12 in {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
