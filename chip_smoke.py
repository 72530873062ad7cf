#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Phases, each of which raises on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from ``src/repro_torch/csrc`` with nvcc, all
     sources at once; print registers and spills, and check that flash
     attention's SASS and its backward's hold tensor-core products (HMMA)
     and asynchronous copies (LDGSTS), flash's bf16 half and its bf16
     backward warpgroup products (HGMMA) and LDGSTS (the backward no HMMA
     and no ldmatrix, LDSM), that RMSNorm and its backward load and store
     16 bytes at a time, and that the permute, the fused offload pass and
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
     ``ServeEngine(max_len=1024, scheduler=SCHED_CFG).generate`` on 24
     requests (prompts 16-512, budgets 8-64, greedy), launch counts from
     0 and checked exactly against the forwards the run made (the
     backbone's prefill / prefill_chunk / decode_step wrapped with
     counters), its wall time and tokens/s (no profiler), rounds, decode
     steps run and live, host time by telemetry span; the card's busy
     share over eight rounds of a second run under torch.profiler, against
     that window's own wall time; one decode step alone at the pool's
     shape, host ms against its kernels' ms; (c) overlap off giving exactly
     the same tokens, every 8th request against its decode alone, a
     deadline eviction under a fake clock (a prefix of its run), a
     suspend/resume, 3 requests on the card against the port's CPU, and
     a sampled queue repeating itself under one seed.  Token checks pass
     equal or at a near-tie (phase 8's rule).
  the shared-prefix page cache, the streaming frontend and recovery (slice 8):
 13. (a) the quantize kernel at L = 256 (the cold tier's codebook) bitwise
     against its plain version on a real full-width K page, on the
     256-grid's midpoints and at a ragged length; flash at a prefix wave's
     shape (B = 4, T = 32, q_offset 32 / 64 / 96, S = 128, ragged
     kv_valid_len) within 2e-5; (b) qwen2-0.5b at full width through
     ``ServeEngine(max_len=1024, scheduler=PREFIX_CFG).generate`` on 48
     requests behind two headers, sharing off and then on, launch counts
     from 0 and checked exactly against the forwards: the same tokens (the
     near-tie rule), a hit rate above 0 and fewer tokens prefilled; the
     ``prefix.*`` stats, rounds, forwards and ``sched.*`` counters equal the
     reduced model's CPU rehearsal of the same queue; wall time, tokens/s,
     tokens prefilled and prefill host time of both runs; (c) the cold tier
     (two waves under a 2-page hot budget): demotions and promotions, two
     quantize launches per page compressed, 196,608 cold bytes per page,
     promoted pages within half a codebook step, one page's compression and
     decompression times; (d) the pinned stampede of
     benchmarks/stream_slo.py through ``StreamingFrontend`` on a virtual
     clock, its five ``stream.*`` rows equal to the port's CPU run of the
     same simulations on the reduced model; a pass-through frontend giving its
     scheduler's tokens; the crash of benchmarks/recovery.py recovered with
     no request lost, one Finish per rid, and the crash-free run's tokens;
     its preemption scenario, every interactive stream started.  In (c)
     and (d) the first call of each serving kernel in every forward keeps
     a copy of its inputs, and after the run each is held against the
     plain version within 2e-5, on those inputs and on normal draws of the
     same shapes, lengths and offsets (phase 12a and (a) cover (b)'s).
  LM training, AgileNN on tokens and the baselines (slice 9):
 14. (a) the flash-attention backward kernel against float64 autograd of
     dense attention and against its plain version (each of dQ, dK, dV
     within 1e-4 of float64's largest magnitude) at qwen2-0.5b's training
     microbatch (q (4, 4096, 14, 64), causal), at D = 128 (qwen2-1.5b's
     12 / 2 heads), a 1024 window, T = 4000, two non-causal T != S cases,
     a q_offset of 1024, ragged kv_valid_len with a row at 0 (whose dq
     must be 0), and q_offset with a window and ragged rows at D = 128
     and not causal; two calls bitwise equal; the
     forward's output with its log-sum-exp bitwise equal to the output
     without it, the log-sum-exp within 1e-5 of float64's; the RMSNorm
     backward at (16,384, 896) within 1e-5 of scale of float64, two calls
     bitwise; (b) qwen2-0.5b at full width and depth, fp32, seed-0
     weights, through ``make_train_step`` at train_4k's T = 4096 with its
     global batch cut from 256 to 8 (two microbatches of 4): 3 steps on
     uniform random tokens, launch counts from 0 checked exactly against
     the rehearsed formula (remat runs each layer's forward twice), every
     gradient leaf finite and nonzero, step time, tokens/s, peak memory,
     the busy share and each kernel's device ms over a profiled step;
     (c) ``forward_loss`` and every gradient leaf on the card against the
     port's CPU run on a 2 x 128 batch (1e-4 relative, 1e-3 of scale);
     (d) AgileNN on tokens over that backbone (C = 32, k = 6, ig_steps 16),
     B = 16, T = 128 of ``SyntheticTokens``: 3 AdamW steps, launches
     exact, one step's loss and gradients against the CPU, the payload
     bits equal, the quantize kernel bitwise on its input; (e) the
     baselines at 96^2: forwards of 256 images; of 128 of them, at most
     1e-4 of the transmitted indices flip card vs CPU (cuDNN and the CPU's
     convs round apart), and on the images with no flip the payload bytes
     and every ``InferenceCost`` field equal the CPU run's; 3
     ``train_baseline`` steps of each at B = 32, quantize launches exact
     and the kernel bitwise on DeepCOD's code and SPINN's features; then
     the two backward kernels' times beside their plain versions', their
     library calls' backward (SDPA ``is_causal`` with heads expanded,
     ``F.rms_norm``; yardsticks only) and their bounds; each alone by
     torch.profiler (measured after (a), before the profiled train step,
     in a fresh child process of this script: ``--lm-alone JSON``), the
     flash backward's three kernels each against its own bound and their
     sum against the 3xTF32 bound; the flash backward at D = 128
     (qwen2-1.5b's heads) against SDPA's backward.
  internvl2-1b, whisper-tiny and long_context (slice 11), full width,
  fp32, TF32 off, seed-0 weights:
 15. (a) flash and its backward at whisper-tiny's encoder shape (q, k, v
     (8, 1500, 6, 64)) and cross shape (q (8, 448, 6, 64) against k/v
     (8, 1500, 6, 64)), not causal, decode attention at the cross shape
     (attend_len 1,500, G = 1) and on a full 8,192-slot ring of
     qwen2-0.5b's heads, against their plain versions (2e-5; the backward
     within 1e-4 of float64's scale), with times, bounds and the library
     calls' (SDPA, not causal / with a mask); (b) internvl2-1b through
     ``ServeEngine(max_len=1024).generate``: 8 requests of 256 patches and
     256 tokens, 32 greedy tokens, launches from 0 and exact, tokens/s and
     peak; then 2 requests of 64 tokens on the card against the port's
     CPU (logits 1e-3, tokens by phase 8's near-tie rule); (c) its
     ``make_train_step`` at T = 4,096 (256 patches + 3,840 tokens), one
     microbatch of 2, 2 steps: launches exact, every gradient leaf finite
     and nonzero, step time, tokens/s, peak; (d) whisper-tiny: 8 requests
     of 1,500 frames and 4 tokens, 64 greedy tokens, launches exact; 2 of
     them against the CPU; ``make_train_step`` at B = 16 x (1,500 frames,
     448 tokens), 3 steps; (e) qwen2-0.5b's prefill of 12,288 tokens with
     ``long_context`` (window and ring 8,192), 64 decode steps past the
     wrap, launches exact, each forward's first kernel calls (layer 0's
     windowed flash among them) held against their plain versions on
     their inputs; a 512-token prompt decoding the same greedy tokens with
     and without ``long_context``.

  moonshot-v1-16b-a3b in bf16 and the MoE archs (slices 12-13), in a
  fresh child process (``--moe-alone JSON``):
 16. (a) the bf16 halves of flash attention (q = k/v (8, 256, 16, 128)
     and, a 4,096-token prompt, (1, 4096, 16, 128), causal), decode
     attention (the 288-slot cache at attend 257 and 287) and RMSNorm
     ((2048, 2048) and (8, 2048)), each within the JAX package's bf16 bars
     of its plain version (3e-2, 3e-2, 2e-2); decode attention bitwise the
     fp32 kernel on the widened inputs, rounded to bf16; flash (on the
     bf16 tensor cores by wgmma since slice 13) and RMSNorm (16-byte rows
     held in registers) at most 2x the library call's error against
     float64 and two calls bitwise equal; each timed beside the fp32
     kernel on the widened inputs, the plain version, the library call
     (SDPA, ``F.rms_norm``, bf16) and the bound (bytes at 2 B an element,
     or the bf16 tensor-core rate); flash's contract swept on the card (D
     64 / 128, G 1 / 7, window, q_offset with T != S, kv_valid_len with a
     row at 0, ragged T and S, not causal; the log-sum-exp within 1e-4 and
     -inf on rows with no live key) and RMSNorm's at N in {1, 8, 2048,
     4097} x d in {896, 2048, 8192}, a d off 8 and a view off 16 bytes;
     (b) moonshot-v1-16b-a3b at full width and
     depth in bf16 (28.89 B params, 53.8 GiB, drawn on the card from seed
     0) through ``ServeEngine(max_len=288).generate``: 8 prompts of 256
     tokens, 32 greedy tokens, launches from 0 and exact (48 flash a
     prefill, 48 decode attention a step, 97 RMSNorm a forward); weights,
     peak, tokens/s, the dropped fraction of the prefill and of each
     decode step; a second generate's picked kernel calls replayed against
     the plain versions and to the bars of (a); the prefill
     alone, each decode step's host time and its kernels' device time by
     torch.profiler; (c) reduced moonshot, mixtral (its window cut to 32)
     and arctic in fp32, the card against the port's CPU: prefill and 4
     decode steps, logits within 1e-4.
  MoE training in bf16 (slice 14), in a fresh child process
  (``--moe-train-alone JSON``), started after phase 16's has ended:
 17. (a) the bf16 backward kernels: flash at moonshot's training
     microbatch (q = k/v (2, 4096, 16, 128), causal) and over its contract
     (D 64 with G = 7, a window, q_offset with T != S, ragged kv_valid_len
     with a row at 0, not causal with T != S, T and S off the tile): dq,
     dk and dv each within 3e-2 of the plain version's scale, at most 2x
     SDPA's bf16 backward's error against float64 (heads expanded), two
     calls bitwise, a row with no live key and a key no row sees exactly
     0; RMSNorm at (8192, 2048) and N in {1, 8, 4097} x d in {896, 2048,
     8192}, bitwise the fp32 kernel on the widened inputs, rounded, two
     calls bitwise; each timed beside the fp32 kernel on the widened
     inputs, the plain version, the library call's bf16 backward and the
     bound, the flash backward's three kernels by torch.profiler, each
     against its own bound, and the RMSNorm backward's two kernels (bf16
     here, fp32 at phase 14's (16,384, 896)); phase 2 checks the flash
     backward's SASS holds HGMMA and LDGSTS and no HMMA or LDSM, and the
     RMSNorm backward's 16-byte loads and stores; (b) moonshot at full
     width, its depth cut to MOE_TRAIN_LAYERS of 48, bf16, seed-0 weights
     drawn on the card, through ``make_train_step`` at T = 4,096, the
     global batch cut from 256 to 4 (two microbatches of 2): 3 steps, step
     1 again from the same state bitwise, launches from 0 and exact (remat
     runs each layer's flash and RMSNorm forwards twice), every gradient
     leaf finite, the router's and every expert's that took a slot
     nonzero, the dropped fraction at the training capacity (480 slots an
     expert), step s, tokens/s, peak, and a profiled step's busy share and
     device ms by kernel; (c) one value-and-grad of reduced moonshot,
     mixtral and arctic in fp32 on the card against the port's CPU (loss
     1e-4 relative, gradients 1e-3 of scale), reduced moonshot in bf16
     (loss within 3e-2; its top-2 routes can flip on an ulp, so its leaves
     are reported) and the same model routing to all 4 experts (every leaf
     within 3e-2 of scale).
  xlstm-350m served and trained (slice 16), fp32, TF32 off, seed-0 weights
  drawn on the card, in a fresh child process (``--xlstm-alone JSON``)
  after phase 17's:
 18. (a) the mLSTM and sLSTM (plain torch: the reference has no kernel for
     them) at its heads, B 2, T 200 (off the 64-token chunk), H 4, D 256:
     the chunked mLSTM against the sequential one on a seeded cell's own
     gates within 2e-4, each cell's full sequence against its one-token
     decode steps (5e-4 mLSTM, 5e-5 sLSTM), the reference's bars; RMSNorm
     and its backward at the training rows (8192, 1024) against the plain
     version and float64, two backward calls bitwise, each timed beside its
     plain version, ``F.rms_norm`` and its bound; (b) the full-size model
     (24 layers, 0.217 B params) through ``ServeEngine(max_len=544)
     .generate``: 8 prompts of 512 tokens, 32 greedy tokens, launches from
     0 and exact (25 RMSNorm a forward, no attention kernel), a second
     generate's tokens equal and its layer-0 and final RMSNorm calls
     replayed against the plain version; weights, peak, tokens/s, the
     prefill alone, each decode step's host ms and, by torch.profiler, its
     kernels' device ms and count; (c) 2 prompts of 64 tokens, 8 tokens,
     against the port's CPU run of the same weights (phase 8's bars); (d)
     ``make_train_step`` at T = 512 (train_4k's 4,096 cut: the sLSTM's
     time loop is host-bound, 44.6 s a step at 4,096), the global batch
     cut from 256 to 2 (one microbatch): 3 steps, step 1 again from the
     same state bitwise, launches exact (RMSNorm 49 a step: remat runs the
     24 pre-norms twice and the final norm once; its backward 25), every
     gradient leaf finite and nonzero, step s, tokens/s, peak, and the
     third step profiled: its busy share, device ms by kernel and the
     shares of its launches, host time and device time in the sLSTM time
     loop and in the mLSTM cells (read from the raw trace, ``raw_profile``).
  jamba-1.5-large-398b, the Mamba hybrid (slice 17), in a fresh child
  process (``--jamba-alone JSON``) after phase 18's:
 19. (a) one Mamba block at full width (d 8,192, d_inner 16,384), fp32,
     TF32 off, plain torch (the reference has no kernel for the scan), B
     2, T 200 (off the 128-token chunk): the chunked scan against the
     sequential oracle within 2e-4, the prefill's state then 3 decode
     steps against it within 3e-4, both paths timed (host ms, and device
     ms and launches by torch.profiler); (b) the three bf16 kernels at the
     served model's shapes, a GQA group of 8: flash at q (8, 256, 64,
     128), k/v (8, 256, 8, 128), causal; decode attention on the 288-slot
     cache (8, 288, 8, 128); RMSNorm at (2048, 8192) and (8, 8192), the
     kernel's widest row; phase 16a's checks and bars, each timed beside
     the fp32 kernel, the plain version, the library call and the bound;
     (c) the model at full width cut to one card (one superblock of 8
     layers, 12 of its 16 experts, top-2; 35.6 B params, 66.3 GiB in bf16,
     drawn on the card) through ``ServeEngine(max_len=288).generate``: 8
     prompts of 256 tokens, 32 greedy tokens, launches from 0 and exact (1
     flash a prefill, 1 decode attention a step, 17 RMSNorm a forward); a
     second generate's tokens equal, its attention layer's and final
     norm's kernel calls replayed against the plain versions; weights,
     peak, tokens/s, the dropped fractions, the prefill alone, each decode
     step's host ms, and by torch.profiler (read raw) a prefill's and a
     decode step's kernels and the Mamba mixers' shares of their launches,
     host time and device time; (d) reduced Jamba in fp32 on the card
     against the port's CPU: prefill logits and greedy tokens (phase 8's
     bars); one ``make_train_step`` (loss within 1e-4 relative, every
     gradient leaf within 1e-3 of scale) of the same model routing to all
     4 experts, and of the top-2 config with its leaves' distance
     reported; each step again from the same state bitwise, its launches
     exact.
  the launchers, the roofline and the examples (slice 18), in this
  process after phase 19's child has ended:
 20. each launcher's ``main(argv)``: (a) ``launch.serve --arch qwen2-0.5b
     --tokens 32`` at full width, launches from 0 and exact, its greedy
     tokens against ``ServeEngine.generate`` on the same weights and
     prompt (phase 8's near-tie rule); (b) ``--queue 16 --lengths
     64,256,512 --tokens 16 --prefix-cache --kv-tier-mb 8`` with
     ``--metrics-json`` and ``--trace-out``, the prefix cache's hot budget
     cut to 8 pages so that its cold tier runs: launches exact against the
     forwards and the K / V pages compressed (one quantize launch at L =
     256 each), the same tokens as the same SchedulerConfig driven
     directly, the JAX launcher's gauge names in the dump, a Chrome trace
     with spans; (c) ``--queue 16 --stream --max-queue 8 --priority mixed
     --preempt --journal J``: served + shed + rejected account for all 16,
     the journal recovered into a fresh frontend with none lost; (d) the
     gateway's SLO run and chaos run: every request on the ladder, one
     offload_fused launch a fleet build; (e) ``launch.train --local
     --steps 3`` for qwen2-0.5b, whisper-tiny and internvl2-1b: finite
     losses, launches counted (exact for the RMSNorm decoders); (f)
     ``roofline.analysis.analyze_step`` of a prefill of 8 x 512, one
     decode step of 8 rows at depth 544 and phase 14's train step at full
     width, each counted in a run of its own, then timed by CUDA events
     (median of 5): flops, bytes, the bound and what bounds it, the share
     of the bound, the analytic estimate at ``MeshSpec(1, 1, 1)`` beside
     the count; on reduced qwen2-0.5b the card's count equal to the
     port's CPU's, exactly; (g) each ``examples/torch_*.py``'s ``main``
     with small arguments, each launching its path's kernels.
  mesh sharding (slice 19), in this process after phase 20:
 21. (a) 20b's argv with ``--mesh 1,1``: the queue served by one NCCL rank
     on a (1, 1) mesh (params and the slot pool DTensors), its tokens
     bitwise 20b's and its launches of every kernel exactly 20b's, one
     pool gather a round, each a trace span; (b) 20f's decode step with
     its params, tokens and cache distributed on a (1, 1) NCCL mesh:
     ``analyze_step`` counts 20f's flops and bytes exactly and no
     collective, its kernels launch; then the meshed and the mesh-less
     step timed in turns, host ms and card ms; (c) ``python -m
     repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k`` on the
     256-rank mesh and ``--shape decode_32k --multi-pod`` on the 512-rank
     one, each a child process (meta tensors over torch's fake process
     group, no card; started before (a) and waited for after it): each
     exits 0 with its record (per-rank argument and output bytes, the
     roofline terms, the collectives by kind).

Prints the card line, a {"kernels": [...]} line, and last
{"ok": true, "device": {...}}.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import record_function  # noqa: E402

from repro_torch import (  # noqa: E402
    fp32_math,
    tree_leaves,
    tree_map,
    tree_to,
    value_and_grad,
)
from repro_torch.compress.quantize import dequantize, hard_indices, linspace_f32  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.agilenn_cifar import AgileNNConfig  # noqa: E402
from repro_torch.configs.base import AgileSpec, InputShape  # noqa: E402
from repro_torch.core.agile import (  # noqa: E402
    agile_forward,
    agile_loss,
    cross_entropy,
    device_forward_fn,
    extract_features,
    init_agile_params,
    offload_payload_arrays,
    remote_forward,
)
from repro_torch.core.agile_lm import (  # noqa: E402
    agile_lm_loss,
    extract_token_features,
    init_agile_lm_params,
    offload_payload_bits,
)
from repro_torch.core.baselines import (  # noqa: E402
    deepcod_code,
    deepcod_cost,
    deepcod_forward,
    deepcod_init,
    deepcod_loss,
    edge_only_cost,
    mcunet_apply,
    mcunet_cost,
    mcunet_init,
    spinn_cost,
    spinn_forward,
    spinn_init,
    spinn_loss,
    train_baseline,
)
from repro_torch.data.synthetic import (  # noqa: E402
    ImageDatasetSpec,
    SyntheticImages,
    SyntheticTokens,
    TokenDatasetSpec,
)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.attention import ops as attention_ops  # noqa: E402
from repro_torch.kernels.attention.kernel import (  # noqa: E402
    flash_attention_backward_cuda,
    flash_attention_cuda,
)
from repro_torch.kernels.attention.ref import (  # noqa: E402
    flash_attention_backward_ref,
    flash_attention_ref,
)
from repro_torch.kernels.common import auto_page_size  # noqa: E402
from repro_torch.kernels.decode_attention.kernel import (  # noqa: E402
    decode_attention_cuda,
    split_slots,
)
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ops import DEFAULT_PAGE  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro_torch.kernels.offload_fused.kernel import offload_fused_cuda  # noqa: E402
from repro_torch.kernels.offload_fused.ops import fused_offload  # noqa: E402
from repro_torch.kernels.offload_fused.ref import offload_fused_ref  # noqa: E402
from repro_torch.kernels.quantize.kernel import quantize_cuda  # noqa: E402
from repro_torch.kernels.quantize.ops import quantize_op  # noqa: E402
from repro_torch.kernels.quantize.ref import quantize_ref  # noqa: E402
from repro_torch.kernels.rmsnorm.kernel import rmsnorm_backward_cuda, rmsnorm_cuda  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_backward_ref, rmsnorm_ref  # noqa: E402
from repro_torch.kernels.topk_split.kernel import channel_permute_cuda  # noqa: E402
from repro_torch.kernels.topk_split.ops import channel_permute_op  # noqa: E402
from repro_torch.kernels.topk_split.ref import channel_permute_ref  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    make_prefill_step,
    make_serve_step,
    make_train_step,
    n_microbatches,
    opt_init,
)
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
from repro_torch.nn.module import param_count  # noqa: E402
from repro_torch.nn.moe import _pick_group_size, moe_routing  # noqa: E402
from repro_torch.nn.norm import groupnorm, rmsnorm  # noqa: E402
from repro_torch.nn import ssm as ssm_nn  # noqa: E402
from repro_torch.nn import xlstm as xlstm_nn  # noqa: E402
from repro_torch.nn.rope import apply_rope  # noqa: E402
from repro_torch.optim.adamw import adamw_init, adamw_update  # noqa: E402
from repro_torch.optim.sgd import sgd_init  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.faults import (  # noqa: E402
    ArrivalBurst,
    Blackout,
    BurstLoss,
    EngineCrash,
    EngineCrashError,
    FaultInjector,
    GatewayStall,
    PayloadCorruption,
)
from repro_torch.serve.frontend import (  # noqa: E402
    Finish,
    FirstToken,
    FrontendConfig,
    Priority,
    SimClient,
    StreamingFrontend,
    VirtualClock,
    drive_closed_loop,
)
from repro_torch.serve.gateway import (  # noqa: E402
    Fleet,
    GatewayConfig,
    OffloadGateway,
    mixed_fleet,
)
from repro_torch.serve.gateway import gateway as gateway_mod  # noqa: E402
from repro_torch.serve.offload import measure_payload, run_offload_inference  # noqa: E402
from repro_torch.serve.prefix_cache import PrefixCache  # noqa: E402
from repro_torch.serve.recovery import RequestJournal, recover  # noqa: E402
from repro_torch.serve.scheduler import ContinuousScheduler, SchedulerConfig  # noqa: E402
from repro_torch.serve.telemetry import Histogram, Telemetry  # noqa: E402
from repro_torch.roofline import analysis as roof  # noqa: E402
from repro_torch.roofline import analytic as roof_analytic  # noqa: E402
from repro_torch.train import agile_pipeline  # noqa: E402
from repro_torch.train.agile_pipeline import joint_step, run_full_pipeline  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth and
# fp32 outside the tensor cores, the type these kernels compute in.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BATCH = 256
TIMING_REPS = 30
PROFILE_SESSIONS = 3
# phase 14's backward kernels timed alone by torch.profiler, in a child
# process, with more tries than elsewhere; each session must keep every
# event (late in this long process sessions have kept 0-0.55 events a
# call; a fresh child process has kept them all)
LM_PROFILE_SESSIONS = 6
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
# from the peaks at B = 4 and 8, fits TRAIN_MEM_FRACTION of the card; 2
# timed steps (3 until slice 19: phase 11c took 56 s)
TRAIN_BATCHES, TRAIN_MEM_FRACTION, TRAIN_TIMED_STEPS = (64, 32, 16, 8), 0.9, 2
# run_full_pipeline at 32^2, B = 64, its 300 + 400 steps cut to the phase's time
PIPE_BATCH, PIPE_PRETRAIN, PIPE_JOINT = 64, 40, 12

# the continuous scheduler: qwen2-0.5b at full width through
# ServeEngine(max_len=1024, scheduler=SCHED_CFG); 24 requests, prompt
# lengths in [16, 512] and budgets in [8, 64], all greedy (48 until slice
# 18, whose phase 20 took the time: the queue ran five times, 217-261 s);
# every SCHED_ALONE_EVERY-th request is decoded alone as well
SCHED_CFG = SchedulerConfig(buckets=(64, 128, 256, 512), max_slots=16,
                            prefill_group=4, chunk=8, page_size=32,
                            prefill_segment=128)
SCHED_REQS, SCHED_SEED, SCHED_ALONE_EVERY = 24, 3, 8
# the sampled rerun takes the queue's first 8 (its rounds run twice; 16
# until slice 19, whose script took 800-1,085 s on three hosts)
SCHED_SAMPLED = 8
# a second run of the queue, its rounds SCHED_PROF_FROM + 1 .. +
# SCHED_PROF_ROUNDS traced by torch.profiler (the card's busy share), of
# the queue's 74 rounds (a CPU rehearsal; rounds do not depend on weights)
SCHED_PROF_FROM, SCHED_PROF_ROUNDS = 30, 8
# the decode step timed alone at the pool's shape: 16 rows at these depths
SCHED_STEP_DEPTHS = tuple(range(16, 577, 37))
# the same scheduler on the card and on the CPU: 3 requests of 16-200
# tokens, 8 new tokens each, 64-token segments (6 requests of 12 tokens,
# 25.1 s, until slice 19 cut it to make room for phase 21)
SCHED_CPU_LENS, SCHED_CPU_NEW, SCHED_CPU_SEGMENT = (16, 100, 200), 8, 64

# the shared-prefix page cache: qwen2-0.5b at full width through
# ServeEngine(max_len=1024, scheduler=PREFIX_CFG), sharing off then on;
# 48 greedy requests, 32 opening with a 96-token header A (tails 1-31:
# bucket 128, prefix waves) and 16 with a 320-token header B (tails 8-159:
# bucket 512, staged and seeded in whole segments), budgets 8-32
PREFIX_CFG = SchedulerConfig(buckets=(128, 512), max_slots=16, prefill_group=4,
                             chunk=8, page_size=32, prefill_segment=128,
                             prefix_cache=True)
PREFIX_HEADERS, PREFIX_REQS = (96, 320), (32, 16)
PREFIX_TAILS, PREFIX_NEW, PREFIX_SEED = ((1, 31), (8, 159)), (8, 32), 8
# the cold tier: tests/test_prefix_cache.py's two waves of 3 requests (a
# 96-token header, 6-token tails, 2 new tokens) at full width, pages of 32
COLD_CFG = SchedulerConfig(buckets=(128,), max_slots=2, prefill_group=2, chunk=4,
                           page_size=32, prefill_segment=128, prefix_cache=True,
                           prefix_hot_pages=2, kv_tier_mb=8.0)
COLD_SEED, COLD_HEADER, COLD_TAIL, COLD_WAVE, COLD_NEW = 8, 96, 6, 3, 2
# the streaming frontend and recovery: the pinned runs of
# benchmarks/stream_slo.py and benchmarks/recovery.py, whose prompts are
# drawn from the reduced model's 512-token vocabulary (valid tokens at
# full width too); one scheduling round is 10 ms of virtual time
STREAM_SCHED = SchedulerConfig(buckets=(8, 16), max_slots=4, prefill_group=2, chunk=2)
STREAM_PER_CLASS, STREAM_REQS, ROUND_S, CRASH_ROUND, BENCH_VOCAB = 4, 4, 0.01, 8, 512
# LM training (slice 9): qwen2-0.5b at train_4k's sequence length, its
# global batch of 256 cut to 8 (two microbatches of 4 x 4096)
LM_KERNELS = ("flash_attention", "flash_attention_backward", "rmsnorm",
              "rmsnorm_backward")
LM_SEQ, LM_GLOBAL_BATCH, LM_MICRO, LM_STEPS = 4096, 8, 2, 3
LM_MICRO_B = LM_GLOBAL_BATCH // LM_MICRO
# (B, T, S, Hq, Hkv, D, causal, window, q_offset, kv_valid_len) of the
# flash backward's checks
LM_FLASH_CASES = (
    (4, 4096, 4096, 14, 2, 64, True, 0, 0, None),   # qwen2-0.5b's training microbatch
    (2, 2048, 2048, 12, 2, 128, True, 0, 0, None),  # qwen2-1.5b's heads, D = 128
    (1, 4096, 4096, 14, 2, 64, True, 1024, 0, None),   # a sliding window
    (1, 4000, 4000, 14, 2, 64, True, 0, 0, None),   # T off the tiles
    (2, 700, 777, 4, 2, 64, False, 0, 0, None),     # not causal, T != S
    (2, 700, 777, 4, 2, 128, False, 100, 0, None),  # not causal with a window, D = 128
    (2, 512, 1536, 14, 2, 64, True, 0, 1024, None),    # a staged segment's q_offset
    (3, 777, 777, 14, 2, 64, True, 0, 0, (777, 0, 300)),   # ragged rows, one at 0
    (2, 600, 1650, 12, 2, 128, True, 256, 1000, (1650, 1203)),  # D = 128: q_offset,
    #                                                    a window, ragged rows
    (2, 300, 1000, 4, 2, 64, False, 128, 500, (1000, 0)),  # not causal: all four
)
# the flash backward timed at D = 128 too: (B, T = S, Hq, Hkv) of
# qwen2-1.5b's heads, causal
LM_FLASH_D128 = (2, 2048, 12, 2)
# backward kernels against float64: each gradient within LM_GRAD_TOL of its
# largest magnitude, the log-sum-exp within LM_LSE_TOL; card against CPU
# as phase 11 (the loss relative, each gradient leaf of its scale)
LM_GRAD_TOL, LM_LSE_TOL, LM_RMS_TOL, LM_RMS_ROWS = 1e-4, 1e-5, 1e-5, (16384, 896)
LM_CPU_LOSS_TOL, LM_CPU_GRAD_TOL = 1e-4, 1e-3
# phase 14's backward kernels timed alone by torch.profiler run in a child
# process of this script (python3 chip_smoke.py --lm-alone JSON), which
# writes its numbers there
LM_ALONE_TIMEOUT_S = 600
# AgileNN on tokens: SyntheticTokens over the first 512 token ids
AGILE_LM_VOCAB, AGILE_LM_B, AGILE_LM_T, AGILE_LM_STEPS, AGILE_LM_CPU_B = 512, 16, 128, 3, 4
# the baselines at 96^2; the server side's MACs are a fixed stand-in, the
# same for every baseline
BASELINE_B, BASELINE_STEPS, BASELINE_COST_B, BASELINE_REMOTE_MACS = 32, 3, 128, 1.0e8
# at most this share of the transmitted indices may flip card vs CPU
BASELINE_FLIP_TOL = 1e-4
# slice 11, full width, fp32, seed-0 weights: internvl2-1b (256 stubbed
# patch embeddings of 1024 in front of the dense LM) served through
# ServeEngine(max_len=1024) on 8 requests of 256 text tokens, 32 greedy
# tokens, and on 2 requests of 64 tokens against the CPU (8 tokens), then
# trained at T = 4096 (256 patches + 3,840 tokens), one microbatch of 2
VLM_ARCH = "internvl2-1b"
VLM_BATCH, VLM_TEXT, VLM_NEW, VLM_MAX_LEN = 8, 256, 32, 1024
VLM_CPU_B, VLM_CPU_TEXT, VLM_CPU_NEW, VLM_CPU_MAX_LEN = 2, 64, 8, 512
VLM_TRAIN_B, VLM_TRAIN_TEXT, VLM_TRAIN_STEPS = 2, 3840, 2
# whisper-tiny: 1,500 stubbed frame embeddings (30 s of audio) a request,
# 4-token prompts, 64 greedy tokens, the decoder's 448-token context;
# trained at B = 16 x (1,500 frames, 448 tokens)
ASR_ARCH = "whisper-tiny"
ASR_BATCH, ASR_PROMPT, ASR_NEW, ASR_MAX_LEN, ASR_CPU_B = 8, 4, 64, 448, 2
ASR_TRAIN_B, ASR_TRAIN_T, ASR_TRAIN_STEPS = 16, 448, 3
# long_context on qwen2-0.5b: a 12,288-token prompt (window and ring of
# long_context_window = 8,192), 64 decode steps past the wrap; a 512-token
# prompt decoded 16 tokens with and without long_context
LONG_PROMPT, LONG_DECODE, LONG_SHORT, LONG_SHORT_NEW = 12288, 64, 512, 16
# one train step of internvl2-1b and of whisper-tiny (its full patches or
# frames) card vs CPU as phase 14c: 2 rows of 32 tokens
TRAIN_CPU_B, TRAIN_CPU_T = 2, 32
# slice 12: moonshot-v1-16b-a3b at full width and depth in bf16 (28.89 B
# parameters, 53.8 GiB, drawn on the card from seed 0) through
# ServeEngine(max_len=288).generate: 8 prompts of 256 tokens, 32 greedy
# tokens; in a fresh child process (python3 chip_smoke.py --moe-alone JSON)
MOE_ARCH = "moonshot-v1-16b-a3b"
MOE_BATCH, MOE_PROMPT, MOE_NEW = 8, 256, 32
MOE_MAX_LEN = MOE_PROMPT + MOE_NEW
MOE_ALONE_TIMEOUT_S = 600
# decode steps traced by torch.profiler (their kernels' device time)
MOE_PROFILE_STEPS = 4
# the bf16 kernels against their plain versions: the JAX package's bf16
# bars (tests/test_kernels.py, tests/test_decode_attention.py); decode
# attention's against its fp32 kernel on the widened inputs, rounded to
# bf16: bitwise
BF16_TOL = {"flash_attention": 3e-2, "decode_attention": 3e-2, "rmsnorm": 2e-2}
# the bf16 flash and RMSNorm (their own kernels since slice 13) against
# float64 on the widened inputs: at most this many times the library
# call's error in bf16 on the same inputs (both round their outputs to
# bf16; the flash kernel also rounds P to bf16, as SDPA does); the
# log-sum-exp within BF16_LSE_TOL of the plain version's (fp32 sums of
# exact bf16 products, in another order)
BF16_LIB_FACTOR = 2.0
BF16_LSE_TOL = 1e-4
# a 4,096-token moonshot prompt, timed in phase 16a: q = k/v (1, 4096, 16, 128)
MOE_LONG_PROMPT = (1, 4096)
# bf16 on the tensor cores, dense (NVIDIA data sheet, 700 W): the least
# time of a bf16 kernel's operations
BF16_OPS_PER_S = 989e12
# reduced moonshot, mixtral and arctic in fp32 (TF32 off), seed-0 weights,
# the card against the port's CPU: prefill and MOE_CPU_DECODE greedy steps
# of MOE_CPU_B x MOE_CPU_T tokens, logits within MOE_CPU_TOL abs + rel
# (fp32 sums in another order through 2 layers); mixtral's 4,096 window
# cut to MOE_CPU_WINDOW so that the prompt and its ring cross it
MOE_REDUCED = ("moonshot-v1-16b-a3b", "mixtral-8x7b", "arctic-480b")
MOE_CPU_B, MOE_CPU_T, MOE_CPU_DECODE, MOE_CPU_WINDOW, MOE_CPU_TOL = 2, 64, 4, 32, 1e-4
# slice 14: moonshot-v1-16b-a3b trained in bf16 at full width through
# make_train_step at train_4k's T = 4,096, the global batch cut from 256 to
# 4 (two microbatches of 2 x 4,096) and the depth from 48 layers to
# MOE_TRAIN_LAYERS (its optimizer state at 48 layers does not fit one
# card: a step holds about 12 B a parameter; at 4 layers step 1 peaked at
# 36.97 GiB of 79.2 on an H100, more than half free, so 6); MOE_TRAIN_STEPS
# steps on uniform tokens, in a fresh child process (python3
# chip_smoke.py --moe-train-alone JSON)
MOE_TRAIN_LAYERS, MOE_TRAIN_SEQ, MOE_TRAIN_BATCH, MOE_TRAIN_STEPS = 6, 4096, 4, 3
MOE_TRAIN_ALONE_TIMEOUT_S = 600
# the bf16 backward kernels at the training microbatch: flash at q = k/v
# (2, 4096, 16, 128), causal; RMSNorm at its (8192, 2048) rows
MOE_TRAIN_FLASH = (2, 4096, 16, 16, 128)
MOE_TRAIN_RMS = (8192, 2048)
# the flash backward bf16's contract on the card: (B, T, S, Hq, Hkv, D,
# causal, window, q_offset, kv_valid_len)
MOE_TRAIN_FLASH_SWEEP = (
    (2, 1000, 1000, 14, 2, 64, True, 0, 0, None),      # D 64, G 7, T off the tile
    (2, 1000, 1000, 16, 16, 128, True, 256, 0, None),  # a window
    (2, 300, 1000, 16, 16, 128, True, 0, 700, None),   # q_offset, T != S
    (3, 777, 777, 8, 8, 128, True, 0, 0, (777, 0, 300)),   # ragged rows, one at 0
    (2, 500, 777, 14, 2, 64, False, 0, 0, None),       # not causal, T != S
    (2, 130, 190, 14, 2, 64, False, 32, 60, (190, 0)),     # all four, D 64
)
MOE_TRAIN_RMS_SWEEP = tuple((N, d) for N in (1, 8, 4097) for d in (896, 2048, 8192))
# reduced moonshot in bf16, the card against the port's CPU: the bf16 bar
MOE_TRAIN_BF16_CPU_TOL = 3e-2
# slice 16: xlstm-350m at full size (24 layers of d 1,024, 4 heads of 256:
# 21 mLSTM and 3 sLSTM cells, no FFN, an untied readout; 0.217 B params in
# fp32, drawn on the card from seed 0), in a fresh child process (python3
# chip_smoke.py --xlstm-alone JSON) after phase 17's
XLSTM_ARCH = "xlstm-350m"
XLSTM_ALONE_TIMEOUT_S = 600
# (a) the cells at its heads: B 2, T 200 (off the 64-token chunk), H 4, D
# 256, held to the reference's bars (tests/test_recurrent.py): the chunked
# mLSTM against the sequential one, each cell's full sequence against its
# one-token decode steps
XLSTM_CELL_B, XLSTM_CELL_T = 2, 200
XLSTM_CHUNK_TOL, XLSTM_MLSTM_DECODE_TOL, XLSTM_SLSTM_DECODE_TOL = 2e-4, 5e-4, 5e-5
XLSTM_CELLS = {
    "mlstm": (xlstm_nn.mlstm_init, xlstm_nn.mlstm_apply, xlstm_nn.mlstm_decode_apply,
              lambda B, d, H: xlstm_nn.mlstm_decode_init_state(B, H, d // H, device="cuda")),
    "slstm": (xlstm_nn.slstm_init, xlstm_nn.slstm_apply, xlstm_nn.slstm_decode_apply,
              lambda B, d, H: xlstm_nn.slstm_decode_init_state(B, d, device="cuda")),
}
# (b) serving: 8 prompts of 512 tokens, 32 greedy tokens; decode steps
# traced by torch.profiler
XLSTM_BATCH, XLSTM_PROMPT, XLSTM_NEW = 8, 512, 32
XLSTM_MAX_LEN = XLSTM_PROMPT + XLSTM_NEW
XLSTM_PROFILE_STEPS = 4
# (c) the card against the port's CPU: 2 prompts of 64 tokens, 8 tokens each
XLSTM_CPU_B, XLSTM_CPU_T, XLSTM_CPU_NEW = 2, 64, 8
# (d) training at train_4k's shape, cut: its global batch of 256 to 2 (one
# microbatch at d 1,024) and T from 4,096 to 512, since the sLSTM's time
# loop is host-bound (a step at 4,096 took 44.6 s on an H100; at 1,024,
# 9.0-14.1 s, phase 18 took 159 s and the script 951 s of its 1,200); 3
# steps, the third profiled
XLSTM_TRAIN_SEQ, XLSTM_TRAIN_BATCH, XLSTM_TRAIN_STEPS = 512, 2, 3
# slice 17: jamba-1.5-large-398b, the Mamba hybrid (superblocks of 8 layers:
# attention at index 0 and 7 Mamba blocks; MoE FFNs at the odd layers, 16
# experts top-2, dense SwiGLU at the even), in a fresh child process
# (python3 chip_smoke.py --jamba-alone JSON) after phase 18's
JAMBA_ARCH = "jamba-1.5-large-398b"
JAMBA_ALONE_TIMEOUT_S = 600
# (a) one Mamba block at full width (d 8,192, d_inner 16,384, d_state 16),
# fp32: B 2, T 200 (off the 128-token chunk), then 3 decode steps; the
# reference's bars (tests/test_recurrent.py): chunked vs sequential 2e-4,
# prefill state then decode vs sequential 3e-4
JAMBA_BLOCK_B, JAMBA_BLOCK_T, JAMBA_BLOCK_DECODE = 2, 200, 3
JAMBA_CHUNK_TOL, JAMBA_DECODE_TOL = 2e-4, 3e-4
# (c) served at full width in bf16, cut to fit one card: its 72 layers weigh
# 742 GiB, and even one superblock (the least depth that keeps the 1:7
# interleave) with its 16 experts is 45.2 B params, 84.2 GiB; one
# superblock with 12 of the 16 experts (top-2 kept), the most that fits
# beside the serving transients (about 6 GiB), is 35.6 B, 66.3 GiB.
# ServeEngine(max_len=288).generate of 8 prompts of 256 tokens, 32 greedy
# tokens; decode steps traced by torch.profiler
JAMBA_LAYERS, JAMBA_EXPERTS = 8, 12
JAMBA_BATCH, JAMBA_PROMPT, JAMBA_NEW = 8, 256, 32
JAMBA_MAX_LEN = JAMBA_PROMPT + JAMBA_NEW
JAMBA_PROFILE_STEPS = 4
# (d) reduced (one superblock, d 256, 4 experts top-2), fp32, the card
# against the port's CPU: 2 prompts of 64 tokens, 8 tokens each (phase 8's
# bars); one make_train_step on 2 x 128 tokens (phase 14c's bars)
JAMBA_CPU_B, JAMBA_CPU_T, JAMBA_CPU_NEW = 2, 64, 8
JAMBA_TRAIN_B, JAMBA_TRAIN_T = 2, 128
# slice 18: the launchers, the roofline and the examples, driven in this
# process (phase 20).  (a) the plain mode at full width, 32 tokens
LAUNCH_TOKENS = 32
LAUNCH_PLAIN_ARGV = ["--arch", LLM_ARCH, "--tokens", str(LAUNCH_TOKENS)]
# (b) a shared-prefix queue with a cold-tier budget; the prefix cache's
# hot budget cut from its default 512 pages (which this queue's 134 pages
# never fill) so that pages demote and the cold tier quantizes them; the
# gauges the JAX launcher's dump carries
LAUNCH_QUEUE_ARGV = ["--arch", LLM_ARCH, "--queue", "16", "--lengths", "64,256,512",
                     "--tokens", "16", "--prefix-cache", "--kv-tier-mb", "8"]
LAUNCH_HOT_PAGES = 8
LAUNCH_QUEUE_GAUGES = ("serve.requests", "serve.tokens", "serve.wall_s",
                       "serve.tokens_per_s", "sched.pool_occupancy", "sched.backlog",
                       "sched.staging", "prefix.page_lookups", "prefix.page_hits",
                       "prefix.inserts", "prefix.demotions", "prefix.promotions",
                       "prefix.hot_drops", "prefix.cold_drops", "prefix.hit_rate",
                       "prefix.hot_pages", "prefix.cold_pages", "prefix.cold_used_bytes")
# (c) the streaming frontend, (d) the gateway's two runs, (e) training
LAUNCH_STREAM_REQS = 16
LAUNCH_STREAM_ARGV = ["--arch", LLM_ARCH, "--queue", str(LAUNCH_STREAM_REQS), "--stream",
                      "--max-queue", "8", "--priority", "mixed", "--preempt"]
LAUNCH_GATEWAY_ARGVS = (
    ["--gateway", "32", "--requests", "4", "--slo-ms", "30"],
    ["--gateway", "16", "--deadline-ms", "150", "--faults",
     "blackout:0.05:0.2;burst;corrupt:0:1:0.3", "--fault-seed", "7"])
LAUNCH_TRAIN_ARCHS, LAUNCH_TRAIN_STEPS = ("qwen2-0.5b", "whisper-tiny", "internvl2-1b"), 3
# (f) the roofline records at full width: a prefill of 8 x 512, one decode
# step of 8 rows at depth 544, phase 14's train step (2 x (4, 4096)), each
# timed by CUDA events (median of ROOF_REPS); and the same three at small
# shapes on reduced qwen2-0.5b, counted on the card and on the CPU
ROOF_SIZES = ((8, 512), (8, 544), (LM_GLOBAL_BATCH, LM_SEQ, LM_MICRO))
ROOF_SMALL = ((2, 64), (2, 80), (4, 128, 2))
ROOF_REPS = 5
# slice 19: mesh sharding (phase 21).  (a) 20b's queue again on a one-rank
# (1, 1) NCCL mesh; (b) 20f's decode step on that mesh, counted, and timed
# against the mesh-less step in turns (MESH_STEP_REPS calls each); (c) the
# dry-run (meta tensors over the fake process group, no card) of train_4k
# on the 256-rank mesh and one 512-rank --multi-pod pair (decode_32k: the
# multi-pod train_4k runs far longer in DTensor's redistribution planner),
# each a child process under DRYRUN_TIMEOUT_S
MESH_ARGV = ["--mesh", "1,1"]
MESH_STEP_REPS = 5
DRYRUN_ARGVS = (["--arch", LLM_ARCH, "--shape", "train_4k"],
                ["--arch", LLM_ARCH, "--shape", "decode_32k", "--multi-pod"])
DRYRUN_TIMEOUT_S = 400
# (g) each example's argv (TMP: a temporary directory) and the kernels it
# must launch
EXAMPLES = {
    "torch_serve_split": (["--tokens", "4", "--batch", "2", "--prompt-len", "8"],
                          ("rmsnorm", "flash_attention", "decode_attention")),
    "torch_gateway_demo": (["--clients", "4", "--requests", "2"], ("offload_fused",)),
    "torch_quickstart": (["--steps", "2", "--pretrain-steps", "2"],
                         ("topk_split", "quantize", "offload_fused")),
    "torch_train_backbone": (["--steps", "3", "--batch", "2", "--seq", "16", "--ckpt",
                              "TMP/ckpt.npz", "--ckpt-every", "2"],
                             ("flash_attention_backward", "rmsnorm_backward")),
    "torch_agile_lm_demo": (["--steps", "2"], ("quantize", "flash_attention_backward")),
}


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


def device_kernels(fn, reps: int = 20, match: str = "", flush: bool = False,
                   per_call: float | None = None,
                   sessions: int = PROFILE_SESSIONS) -> dict:
    """{kernel name: (device us per call, launches per call)} of the
    kernels of ``fn`` whose names hold ``match``, over ``reps`` calls, from
    torch.profiler's device events ({} if it records none): the kernels'
    own durations, without the gaps between them.  ``flush`` clears the
    L2 before each call, as ``time_ms`` does (the fill kernel's name holds
    no kernel name of the port).  The profiler on the card has come back
    with no matching event for kernels that ran, and with some of a
    session's events dropped; a session with no matching event, or (given
    ``per_call``, the launches of each kernel in one call) one in which a
    kernel kept fewer than 0.9 x ``per_call`` events a call or more than
    ``per_call``, is repeated, ``sessions`` times at most.  With
    ``per_call`` the last such session fails the script."""
    from torch.profiler import ProfilerActivity, profile
    buf = torch.empty(64 << 20, dtype=torch.int32, device="cuda") if flush else None
    fn()
    torch.cuda.synchronize()
    partial = {}
    for session in range(1, sessions + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if buf is not None:
                    buf.zero_()
                fn()
            torch.cuda.synchronize()
        found = {key: (us / reps, n / reps)
                 for key, (us, n) in profiled_kernels(prof, match).items()}
        partial = {key[:60]: n for key, (_, n) in found.items()
                   if per_call is not None and not 0.9 * per_call <= n <= per_call}
        if found and not partial:
            return found
        print(f"torch.profiler session {session}: "
              + (f"events a call {partial}" if found else
                 f"no device event named {match!r}"), file=sys.stderr)
    check(per_call is None, f"torch.profiler kept {partial or 'no'} events a call "
          f"of {match!r} in each of {sessions} sessions")
    return found


def profiled_kernels(prof, match: str = "") -> dict:
    """{kernel name: (device us, launches)} of a finished torch.profiler
    run, for the kernels whose names hold ``match``.  A profiler range
    (``record_function``: ``value_and_grad.backward``, ``ranged``) also
    leaves a span on the device's timeline over the kernels it launched;
    those spans are not kernels and are left out."""
    out = {}
    for evt in prof.key_averages():
        if (getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False) or match not in evt.key):
            continue
        total = getattr(evt, "device_time_total", None)
        total = total if total is not None else evt.cuda_time_total
        out[evt.key] = (total, evt.count)
    return out


def profiled_share(fn, match: str, bound_ms: float,
                   sessions: int = PROFILE_SESSIONS) -> dict:
    """The torch.profiler duration of one call of ``fn``'s kernels named
    ``match``, each of which launches once a call (L2 flushed before each
    call, without the CUDA events' floor), and the share of ``bound_ms``
    it reaches.  Only a session that kept 0.9 to 1 events a call of each
    kernel counts (``device_kernels``); each kernel's time is the mean
    over the events kept."""
    kernels = device_kernels(fn, match=match, flush=True, per_call=1,
                             sessions=sessions)
    us = sum(t / n for t, n in kernels.values())
    check(us > 0, f"torch.profiler recorded no device time for {match}")
    return {"us": us, "bound_share": bound_ms * 1e3 / us,
            "events_per_call": {k[:60]: n for k, (_, n) in kernels.items()}}


# what the redesigned kernels must issue: tensor-core products (HMMA) and
# asynchronous copies (LDGSTS) in flash attention and its backward,
# warpgroup products (HGMMA) in flash's bf16 half and its bf16 backward,
# 16-byte loads and stores in RMSNorm's bf16 half and in its backward,
# asynchronous 16-byte copies and 16-byte stores in the permute, the fused
# offload pass and decode attention (its partials and its output)
SASS_EXPECT = {"flash_attention": ("HMMA", "LDGSTS"),
               "flash_attention_bf16": ("HGMMA", "LDGSTS", "STG.E.128"),
               "rmsnorm": ("LDG.E.128", "STG.E.128"),
               "rmsnorm_backward": ("LDG.E.128", "STG.E.128"),
               "flash_attention_backward": ("HMMA", "LDGSTS"),
               "flash_attention_backward_bf16": ("HGMMA", "LDGSTS"),
               "topk_split": ("LDGSTS", "STG.E.128"),
               "offload_fused": ("LDGSTS", "STG.E.128"),
               "decode_attention": ("LDGSTS", "STG.E.128")}
# and what they must not: the bf16 backward runs every product by wgmma,
# with no mma.sync (HMMA) and no ldmatrix (LDSM) left
SASS_ABSENT = {"flash_attention_backward_bf16": ("HMMA", "LDSM")}


def sass_counts(libs) -> dict:
    """Count the expected (and the absent) instructions in each built
    library's SASS."""
    cuobjdump = os.path.join(os.path.dirname(os.path.realpath(_build.find_nvcc())),
                             "cuobjdump")
    counts = {}
    for name, ops in SASS_EXPECT.items():
        sass = subprocess.run([cuobjdump, "-sass", str(libs[name])], check=True,
                              capture_output=True, text=True, timeout=120).stdout
        counts[name] = {op: sass.count(op) for op in ops + SASS_ABSENT.get(name, ())}
        check(all(counts[name][op] for op in ops), f"{name}: SASS lacks {counts[name]}")
        check(not any(counts[name][op] for op in SASS_ABSENT.get(name, ())),
              f"{name}: SASS holds {counts[name]}")
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
              f"of its bound (events a call "
              f"{min(kernel_us[name]['events_per_call'].values()):.2f})  [{card}]")
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


def live_mask(B: int, T: int, S: int, *, causal: bool, window: int, q_offset: int,
              kv_valid_len=None, device="cuda"):
    """The flash kernels' live (query, key) pairs, (B, T, S)."""
    qp = torch.arange(T, device=device)[:, None] + q_offset
    kp = torch.arange(S, device=device)[None, :]
    live = torch.ones(T, S, dtype=torch.bool, device=device)
    if causal:
        live = live & (kp <= qp)
    if window > 0:
        live = live & (kp > qp - window)
    live = live.expand(B, T, S)
    if kv_valid_len is not None:
        live = live & (kp[None] < kv_valid_len.to(device).view(-1, 1, 1))
    return live


def attention64(q, k, v, *, causal: bool = True, window: int = 0, q_offset: int = 0,
                kv_valid_len=None):
    """Dense attention in float64 on the widened inputs under flash's whole
    contract (keys at or past S masked); returns the output (B, T, Hq, D),
    0 on a row with no live key, and the live mask (B, T, S)."""
    T, S, G = q.shape[1], k.shape[1], q.shape[2] // k.shape[2]
    q64 = q.double()
    k64, v64 = (t.double().repeat_interleave(G, 2) for t in (k, v))
    live = live_mask(q.shape[0], T, S, causal=causal, window=window, q_offset=q_offset,
                     kv_valid_len=kv_valid_len, device=q.device)
    s = torch.einsum("bthd,bshd->bhts", q64, k64) / q.shape[-1] ** 0.5
    p = torch.softmax(s.masked_fill(~live[:, None], -float("inf")), dim=-1)
    return torch.einsum("bhts,bshd->bthd", p.nan_to_num(0.0), v64), live


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
        exact, _ = attention64(q, k, v)
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


def top2_margin(cfg, params, prompt, tokens, step: int, max_len: int = CPU_MAX_LEN,
                extras=None):
    """The top-2 logit margin at decode position ``step`` of one row, fed
    its own greedy ``tokens`` on the params' device (the card or the CPU),
    and the top logit's size.  ``extras``: the row's patches / frames."""
    dev = params["embed"]["table"].device
    batch = {"tokens": torch.as_tensor(prompt[None], device=dev)}
    batch.update({k: torch.as_tensor(v[None], device=dev)
                  for k, v in (extras or {}).items()})
    logits, cache, T = bb.prefill(cfg, params, batch, max_len=max_len)
    for i in range(step):
        logits, cache = bb.decode_step(
            cfg, params, torch.tensor([[int(tokens[i])]], device=dev), cache, T + i)
    top = logits[0].topk(2).values
    return (top[0] - top[1]).item(), top[0].abs().item()


def near_tie(cfg, params, prompt, ref, got, what: str, max_len: int = CPU_MAX_LEN,
             extras=None):
    """``got`` equals the greedy tokens ``ref`` (decoded from ``params``) up
    to its length, or the first divergence sits on a near-tie of ``ref``'s
    run: a top-2 margin within what LLM_LOGIT_TOL of difference can swap.
    Returns the step of the divergence, None when there is none."""
    n = min(len(ref), len(got))
    split = np.flatnonzero(np.asarray(ref[:n]) != np.asarray(got[:n]))
    if split.size == 0:
        return None
    i = int(split[0])
    margin, top = top2_margin(cfg, params, prompt, ref, i, max_len, extras)
    bar = 2 * (LLM_LOGIT_TOL + LLM_LOGIT_TOL * top)
    print(f"{what}: greedy tokens diverge at step {i}; the top-2 margin of "
          f"the reference there is {margin:.3e} (a swap needs < {bar:.3e})")
    check(margin <= bar, f"{what}: diverges at step {i} with a top-2 margin "
          f"of {margin}, beyond the logit tolerance")
    return i


def phase_llm_vs_cpu(cfg, params):
    """The same params and prompts on the card and on the CPU (B =
    CPU_BATCH, T = CPU_PROMPT, CPU_NEW tokens): ``card_vs_cpu``."""
    prompts = np.random.RandomState(3).randint(0, cfg.vocab, (CPU_BATCH, CPU_PROMPT))
    return card_vs_cpu(cfg, params, [Request(tokens=p, max_new_tokens=CPU_NEW)
                                     for p in prompts], CPU_MAX_LEN, "phase 8")


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
              f"{kernel_us[name]['bound_share']:.1%} of its bound (events a call "
              f"{min(kernel_us[name]['events_per_call'].values()):.2f})  [{card}]")
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
    """The phase's SCHED_REQS requests: lengths, budgets and tokens from
    one seed."""
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
    """Wrap the backbone's three forwards with call counters, the host
    time spent inside the two prefills and the token positions a segment
    prefills (its rows x width); returns the counts and a function that
    unwraps them."""
    calls = {"prefill": 0, "prefill_chunk": 0, "decode_step": 0,
             "prefill_tokens": 0, "prefill_host_s": 0.0}
    real = {n: getattr(bb, n) for n in ("prefill", "prefill_chunk", "decode_step")}

    def wrap(name):
        def counted(*a, **kw):
            calls[name] += 1
            if name == "decode_step":
                return real[name](*a, **kw)
            t0 = time.perf_counter()
            out = real[name](*a, **kw)
            calls["prefill_host_s"] += time.perf_counter() - t0
            if name == "prefill_chunk":
                calls["prefill_tokens"] += a[2].shape[0] * a[2].shape[1]
            return out
        return counted

    for n in real:
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
    # every SCHED_ALONE_EVERY-th request alone through the equal-length path
    alone_eng = ServeEngine(cfg, params, max_len=LLM_MAX_LEN)
    diverged = {}
    for i in range(0, SCHED_REQS, SCHED_ALONE_EVERY):
        ref = alone_eng.generate([reqs[i]])[0].tokens
        step = near_tie(cfg, params, reqs[i].tokens, ref, tokens[i],
                        f"phase 12c: request {i} alone", max_len=LLM_MAX_LEN)
        if step is not None:
            diverged[i] = step
    print(f"phase 12c: overlap=False ({serial_s:.3f} s) gives the same tokens "
          f"exactly; {len(range(0, SCHED_REQS, SCHED_ALONE_EVERY))} requests decoded "
          f"alone through the equal-length path equal the scheduler's except at "
          f"near-ties {diverged}")
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


def prefix_queue(vocab: int):
    """Phase 13b's 48 greedy requests: PREFIX_REQS[0] open with header A
    and PREFIX_REQS[1] with header B, in a shuffled order, each with its
    own tail; lengths, budgets and tokens from PREFIX_SEED."""
    rng = np.random.RandomState(PREFIX_SEED)
    heads = [rng.randint(0, vocab, n) for n in PREFIX_HEADERS]
    kinds = rng.permutation([0] * PREFIX_REQS[0] + [1] * PREFIX_REQS[1])
    reqs = []
    for k in kinds:
        lo, hi = PREFIX_TAILS[k]
        tail = rng.randint(0, vocab, rng.randint(lo, hi + 1))
        reqs.append(Request(tokens=np.concatenate([heads[k], tail]),
                            max_new_tokens=int(rng.randint(PREFIX_NEW[0],
                                                           PREFIX_NEW[1] + 1))))
    return reqs


def count_prefill(sched):
    """``count_forwards`` plus a group's prompt lengths, read on the host
    at the scheduler's group launch: tokens prefilled as
    tests/test_prefix_cache.py counts them (a group's lengths, a segment's
    rows x width)."""
    calls, unwrap_fw = count_forwards()
    launch = sched._launch_group

    def group(g):
        calls["prefill_tokens"] += int(g["lengths"].sum())
        return launch(g)

    sched._launch_group = group

    def unwrap():
        unwrap_fw()
        del sched._launch_group
    return calls, unwrap


def prefix_run(cfg, params, reqs, sched_cfg, device=None):
    """One ServeEngine.generate of the queue under ``sched_cfg``, launch
    counts from 0 and read just after; returns (tokens, record)."""
    tel = Telemetry(enabled=True)
    eng = ServeEngine(cfg, params, max_len=LLM_MAX_LEN, scheduler=sched_cfg,
                      telemetry=tel, device=device)
    sched = eng.scheduler
    calls, unwrap = count_prefill(sched)
    for kern in _build.KERNELS.values():
        kern.launches = 0
    sync(device)
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    sync(device)
    run_s = time.perf_counter() - t0
    launches = {n: k.launches for n, k in _build.KERNELS.items()}
    unwrap()
    tokens = [c.tokens.tolist() for c in outs]
    for r, c in zip(reqs, outs):
        check(len(c.tokens) == r.max_new_tokens and not c.timed_out,
              f"completion of {len(c.tokens)} tokens for {r.max_new_tokens}")
    pc = sched.prefix
    rec = {"run_s": run_s, "tokens": sum(map(len, tokens)),
           "rounds": sched._round, "forwards": calls, "launches": launches,
           "counters": {f"{c.name}{dict(c.labels) or ''}": float(c.value)
                        for c in tel.metrics.instruments()
                        if c.name.startswith("sched.")},
           "span_host_s": {}}
    for sp in tel.trace.by_track("scheduler"):
        rec["span_host_s"][sp.name] = rec["span_host_s"].get(sp.name, 0.0) + sp.dur
    rec["tokens_per_s"] = rec["tokens"] / run_s
    if pc is not None:
        check(all(e.refs == 0 for e in pc._index.values()) and not pc._slot_keys,
              "a prefix page is still referenced after the run")
        rec.update(stats={k: int(v) for k, v in pc.stats.items()},
                   hit_rate=float(pc.hit_rate), hot_pages=int(pc.n_hot),
                   cold_pages=int(pc.n_cold), cold_used_bytes=int(pc.cold_used_bytes))
    return tokens, rec, sched


def sync(device=None):
    if device is None:
        torch.cuda.synchronize()


def expected_launches(cfg, calls) -> dict:
    """Every kernel's launches over ``calls`` forwards of the fp32 serving
    path: 0 for the backward kernels (serving takes no gradient) and the
    bf16 halves."""
    L = cfg.n_layers
    forwards = calls["prefill"] + calls["prefill_chunk"] + calls["decode_step"]
    return dict.fromkeys(_build.KERNELS, 0) | {
        "rmsnorm": (2 * L + 1) * forwards,
        "flash_attention": L * (calls["prefill"] + calls["prefill_chunk"]),
        "decode_attention": L * calls["decode_step"]}


def prefix_kernel_checks(cfg, page):
    """Phase 13a: the quantize kernel at L = 256, bitwise, over a real
    full-width K page (its own codebook), over inputs on the 256-grid's
    midpoints and at a ragged length; flash at a prefix wave's shape (B =
    prefill_group, T = page_size, every q_offset a 128-token bucket seeds,
    attending at 128, with and without a ragged kv_valid_len)."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    errs = {"quantize": 0.0, "flash_attention": 0.0}
    x = page.contiguous()
    lo, hi = (float(v) for v in torch.aminmax(x))
    cases = [(x, torch.from_numpy(linspace_f32(256, lo, hi)).cuda())]
    cases.append(tie_inputs(768, 128, 256))
    y = torch.randn(page.numel() + 37, generator=gen, device="cuda") * 4
    cases.append((y, torch.from_numpy(linspace_f32(256, -9.0, 7.5)).cuda()))
    for xi, c in cases:
        errs["quantize"] = max(errs["quantize"],
                               max_err(quantize_cuda(xi, c), quantize_ref(xi, c)))
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    G, T, W = PREFIX_CFG.prefill_group, PREFIX_CFG.page_size, PREFIX_CFG.buckets[0]
    offsets = list(range(T, W, T))
    for off in offsets:
        for valid in (None, [W, 110, off + 1, 33]):
            q = torch.randn(G, T, Hq, D, generator=gen, device="cuda")
            k, v = (torch.randn(G, W, Hkv, D, generator=gen, device="cuda")
                    for _ in range(2))
            vl = None if valid is None else torch.tensor(valid, device="cuda")
            errs["flash_attention"] = max(errs["flash_attention"], close_err(
                flash_attention_cuda(q, k, v, q_offset=off, kv_valid_len=vl),
                flash_attention_ref(q, k, v, q_offset=off, kv_valid_len=vl),
                LLM_KERNEL_TOL, f"flash_attention prefix wave q_offset={off} "
                f"kv_valid_len={valid}"))
    print(f"phase 13a: quantize at L = 256 bitwise on a full-width K page "
          f"{tuple(page.shape)}, 768 x 128 inputs on the grid's midpoints and "
          f"{page.numel() + 37} ragged; flash at B = {G}, T = {T}, q_offset "
          f"{offsets}, S = {W} within {LLM_KERNEL_TOL}: max |err| {errs}")
    return errs


# the serving path's kernels: the module whose op calls each CUDA wrapper,
# the wrapper's name there, and the plain version it is held against
PATH_KERNELS = {"flash_attention": (attention_ops, "flash_attention_cuda",
                                    flash_attention_ref),
                "decode_attention": (decode_ops, "decode_attention_cuda",
                                     decode_attention_ref),
                "rmsnorm": (rmsnorm_ops, "rmsnorm_cuda", rmsnorm_ref)}


def kernel_picks(cfg) -> dict:
    """Which calls of each serving kernel ``capture_kernel_calls`` keeps:
    {kernel: (its calls in one forward, the indices kept among them)}.  A
    dense forward: the first call of each.  An enc-dec forward (whisper):
    the encoder's first flash call and decoder layer 0's self and cross
    flash in the prefill, layer 0's self and cross decode attention in
    each step; its LayerNorm is plain torch, so it has no RMSNorm.  An
    xLSTM forward: layer 0's pre-norm and the final norm.  A hybrid
    forward: the first attention layer's flash or decode attention, its
    pre-norm (layer 0's) and the final norm."""
    L = cfg.n_layers
    if cfg.xlstm is not None:       # no attention; a pre-norm a layer, the final norm
        return {"rmsnorm": (L + 1, {0, L})}
    if cfg.hybrid is not None:      # one attention layer a superblock
        n_attn = cfg.n_superblocks
        return {"flash_attention": (n_attn, {0}), "decode_attention": (n_attn, {0}),
                "rmsnorm": (2 * L + 1, {0, 2 * L})}
    if cfg.encdec is None:
        return {"flash_attention": (L, {0}), "decode_attention": (L, {0}),
                "rmsnorm": (2 * L + 1, {0})}
    Le = cfg.encdec.n_encoder_layers
    return {"flash_attention": (Le + 2 * L, {0, Le, Le + 1}),
            "decode_attention": (2 * L, {0, 1})}


def capture_kernel_calls(cfg):
    """Wrap the serving kernels' CUDA wrappers where their ops call them
    and keep a copy of the inputs of the calls ``kernel_picks`` names in
    each forward: the shapes, offsets, valid lengths and depths the path
    gives them.  The wrappers launch as before and count their own
    launches.  Returns the kept calls and a function that unwraps them."""
    picks = kernel_picks(cfg)
    kept = {n: [] for n in picks}
    seen = dict.fromkeys(picks, 0)
    real = {n: getattr(PATH_KERNELS[n][0], PATH_KERNELS[n][1]) for n in picks}

    def copy(x):
        return x.clone() if isinstance(x, torch.Tensor) else x

    def wrap(name):
        stride, keep_at = picks[name]

        def keep(*a, **kw):
            if seen[name] % stride in keep_at:
                kept[name].append(([copy(x) for x in a],
                                   {k: copy(v) for k, v in kw.items()}))
            seen[name] += 1
            return real[name](*a, **kw)
        return keep

    for n in picks:
        setattr(PATH_KERNELS[n][0], PATH_KERNELS[n][1], wrap(n))
    return kept, lambda: [setattr(PATH_KERNELS[n][0], PATH_KERNELS[n][1], f)
                          for n, f in real.items()]


def replay_kernel_calls(kept, what: str, tol=LLM_KERNEL_TOL):
    """Each kept call again through its CUDA wrapper and its plain version,
    on the kept inputs and on normal draws of the same shapes and dtypes
    (the same offsets, valid lengths and depths), within ``tol`` (a float,
    or one per kernel); returns the largest |err| per kernel and the
    distinct shapes held."""
    gen = torch.Generator().manual_seed(131)
    errs, shapes = {}, {}
    for name, calls in kept.items():
        mod, attr, ref = PATH_KERNELS[name]
        kernel = getattr(mod, attr)
        errs[name] = 0.0
        for a, kw in calls:
            sig = (tuple(tuple(x.shape) for x in a if isinstance(x, torch.Tensor))
                   + tuple(f"{k}={v}" for k, v in sorted(kw.items())
                           if not isinstance(v, torch.Tensor)))
            shapes.setdefault(name, set()).add(sig)
            drawn = [torch.randn(x.shape, generator=gen).to(x.device, x.dtype)
                     if isinstance(x, torch.Tensor) and x.is_floating_point() else x
                     for x in a]
            ref_kw = {k: v for k, v in kw.items() if k != "page_size"}
            for args in (a, drawn):
                lens = [x.tolist() for x in [*args, *kw.values()]
                        if isinstance(x, torch.Tensor) and not x.is_floating_point()]
                errs[name] = max(errs[name], close_err(
                    kernel(*args, **kw), ref(*args, **ref_kw),
                    tol[name] if isinstance(tol, dict) else tol,
                    f"{what}: {name} at {sig}, lengths {lens}"))
    counts = {n: len(c) for n, c in kept.items()}
    check(all(counts.values()), f"{what}: a serving kernel was never called: {counts}")
    print(f"{what}: the calls kernel_picks names in each forward ({counts} "
          f"calls) again on its own inputs and on normal draws, against the "
          f"plain versions within {tol}: shapes "
          f"{ {n: sorted(s) for n, s in shapes.items()} }, max |err| {errs}")
    return errs


def cold_tier(cfg, params, card):
    """Phase 13c: tests/test_prefix_cache.py's two waves at full width
    under a 2-page hot budget and an 8 MiB cold tier; each forward's
    kernel calls replayed against the plain versions."""
    sched = ContinuousScheduler(cfg, params, sched=COLD_CFG, max_len=LLM_MAX_LEN)
    pc = sched.prefix
    blobs, promoted = {}, []
    compress, decompress = pc._compress, pc._decompress

    def kept_compress(page):
        blob = compress(page)
        blobs[id(blob)] = (blob, page.clone())
        return blob

    def checked_decompress(blob):
        x = decompress(blob)
        _, page = blobs[id(blob)]
        promoted.append(((x - page).abs().max().item(), (blob[2] - blob[1]) / 255))
        return x

    pc._compress, pc._decompress = kept_compress, checked_decompress
    rng = np.random.RandomState(COLD_SEED)
    head = rng.randint(0, cfg.vocab, COLD_HEADER)
    calls, unwrap = count_forwards()
    kept, release = capture_kernel_calls(cfg)
    for kern in _build.KERNELS.values():
        kern.launches = 0
    after = []
    for _ in range(2):
        reqs = [Request(tokens=np.concatenate([head, rng.randint(0, cfg.vocab, COLD_TAIL)]),
                        max_new_tokens=COLD_NEW) for _ in range(COLD_WAVE)]
        rids = [sched.submit(r) for r in reqs]
        outs = sched.run()
        check(all(len(outs[r].tokens) == COLD_NEW for r in rids),
              "a cold-tier wave did not finish its budgets")
        after.append({k: int(v) for k, v in pc.stats.items()})
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in _build.KERNELS.items()}
    unwrap()
    release()
    pc._compress, pc._decompress = compress, decompress
    compressed = len(blobs) // 2
    page_bytes = 2 * int(np.prod(pc._page_shape))        # K and V, 8 bits each
    check(after[0]["demotions"] > 0, "wave A demoted no page")
    check(after[1]["promotions"] > 0, "wave B promoted no page")
    check(launches["quantize"] == 2 * compressed == len(blobs),
          f"{launches['quantize']} quantize launches for {compressed} pages")
    check(pc.cold_used_bytes == page_bytes * pc.n_cold
          and pc.n_cold == compressed - pc.stats["cold_drops"],
          f"cold tier holds {pc.cold_used_bytes} B in {pc.n_cold} pages")
    check(all(e.refs == 0 for e in pc._index.values()), "a page is still pinned")
    check(promoted and all(err <= step / 2 * (1 + 1e-4) for err, step in promoted),
          f"a promoted page is off by more than half a step: {promoted}")
    check(launches == expected_launches(cfg, calls) | {"quantize": len(blobs)}
          | {n: 0 for n in OFFLOAD_KERNELS if n != "quantize"},
          f"cold-tier launches {launches}, forwards {calls}")
    page = next(e.hot["k"] for e in pc._index.values() if e.hot is not None)
    host = {"compress": [], "decompress": []}
    for _ in range(11):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob = compress(page)
        host["compress"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        decompress(blob)
        torch.cuda.synchronize()
        host["decompress"].append(time.perf_counter() - t0)
    lo, hi = blob[1], blob[2]
    centers = torch.from_numpy(linspace_f32(256, lo, hi)).cuda()
    x = page.contiguous()
    kern_ms = time_ms(lambda: quantize_cuda(x, centers))
    b_ms, b_by = bound(x.numel() * 12, x.numel() * 256 * 3)
    rec = {"stats": {k: int(v) for k, v in pc.stats.items()}, "after_wave_a": after[0],
           "pages_compressed": compressed, "cold_pages": int(pc.n_cold),
           "cold_used_bytes": int(pc.cold_used_bytes), "page_blob_bytes": page_bytes,
           "promoted_max_err_over_half_step": max(e / (s / 2) for e, s in promoted),
           "launches": launches,
           "compress_ms": statistics.median(host["compress"][1:]) * 1e3,
           "decompress_ms": statistics.median(host["decompress"][1:]) * 1e3,
           "quantize_page_ms": kern_ms, "quantize_page_bound_ms": b_ms,
           "quantize_page_bound_by": b_by}
    print(f"phase 13c: cold tier at full width, two waves of {COLD_WAVE}: stats "
          f"{rec['stats']}, {compressed} pages compressed in {len(blobs)} quantize "
          f"launches, {pc.n_cold} cold pages in {pc.cold_used_bytes} B "
          f"({page_bytes} B a page); promoted pages within "
          f"{rec['promoted_max_err_over_half_step']:.4f} of half a step; one "
          f"page's compression {rec['compress_ms']:.3f} ms, decompression "
          f"{rec['decompress_ms']:.3f} ms on the host clock; the quantize kernel "
          f"on it {kern_ms:.4f} ms (bound {b_ms:.4f} ms, {b_by})  [{card}]")
    rec["kernel_errs"] = replay_kernel_calls(kept, "phase 13c")
    return launches, rec


def pctl(values, q: float) -> float:
    """benchmarks/common.py's exact percentile, through the port's
    telemetry histogram."""
    h = Histogram.exact()
    for v in np.asarray(values, np.float64).ravel():
        h.observe(float(v))
    return h.percentile(q)


def stream_stampede(cfg, params, device=None):
    """benchmarks/stream_slo.py's pinned stampede (12 closed-loop clients x
    4 requests, 10x ArrivalBurst, max_queue 6, SLO 250 ms, one round =
    10 ms of virtual time): its five rows and records."""
    rng = np.random.RandomState(0)
    clients = []
    for c in range(3 * STREAM_PER_CLASS):
        reqs = tuple(Request(tokens=rng.randint(0, BENCH_VOCAB, int(rng.choice((4, 8, 12)))),
                             max_new_tokens=int(6 + rng.randint(0, 5)))
                     for _ in range(STREAM_REQS))
        clients.append(SimClient(requests=reqs, priority=Priority(c % 3),
                                 start_s=0.1 * c, think_s=0.02))
    clock = VirtualClock()
    fe = StreamingFrontend(cfg, params, frontend=FrontendConfig(
        max_queue=6, slo_ms=250.0, class_deadline_ms=(400.0, None, None)),
        sched=STREAM_SCHED, max_len=32, seed=0, clock=clock, device=device)
    rep = drive_closed_loop(fe, clients, clock=clock, round_s=ROUND_S,
                            faults=FaultInjector((ArrivalBurst(factor=10.0),), seed=7))
    check(all(r.status in ("served", "shed", "rejected") for r in rep.records),
          "a stampede request left the ladder")
    inter = rep.ttft_ms(Priority.INTERACTIVE)
    rows = {"stream.ttft_p50_ms": pctl(inter, 50), "stream.ttft_p99_ms": pctl(inter, 99),
            "stream.itl_p99_ms": pctl(rep.itl_ms(), 99),
            "stream.reject_rate": float(rep.reject_rate),
            "stream.goodput_rps": float(rep.goodput_rps)}
    records = [(r.client, int(r.priority), r.t_submit, r.status, r.t_first, r.t_done,
                r.n_tokens, r.retry_after_s) for r in rep.records]
    return rows, records, fe.sched._round


def drain(fe, clock):
    while fe.has_work():
        clock.now += ROUND_S
        fe.step()
    out, fe._results = fe._results, {}
    return out


def crash_replay(cfg, params, device=None):
    """benchmarks/recovery.py's crash scenario: a 12-request burst (three
    classes, journal attached) loses its engine at round CRASH_ROUND and
    is recovered into a fresh frontend; and the same burst crash-free."""
    rng = np.random.RandomState(0)
    reqs = [Request(tokens=rng.randint(0, BENCH_VOCAB, int(rng.choice((4, 8, 12)))),
                    max_new_tokens=int(4 + rng.randint(0, 4))) for _ in range(12)]

    def frontend(clock, **kw):
        return StreamingFrontend(cfg, params, frontend=FrontendConfig(), sched=STREAM_SCHED,
                                 max_len=32, seed=0, clock=clock, device=device, **kw)

    clock = VirtualClock()
    fe = frontend(clock)
    for i, r in enumerate(reqs):
        fe.submit(r, Priority(i % 3))
    free = drain(fe, clock)
    journal, clock = RequestJournal(), VirtualClock()
    fe = frontend(clock, journal=journal, faults=FaultInjector((EngineCrash(CRASH_ROUND),)))
    for i, r in enumerate(reqs):
        fe.submit(r, Priority(i % 3))
    try:
        drain(fe, clock)
        check(False, "the scripted crash never fired")
    except EngineCrashError:
        pass
    pre = [ev.rid for ev in fe.events if isinstance(ev, Finish)]
    clock2 = VirtualClock(clock.now)
    fe2 = frontend(clock2)
    merged = recover(fe2, journal, drive=lambda: drain(fe2, clock2))
    post = [ev.rid for ev in fe2.events if isinstance(ev, Finish)]
    submitted = {rec["rid"] for rec in journal.events if rec["ev"] == "submit"}
    lost = len(submitted - set(merged))
    check(lost == 0, f"recovery lost {lost} journaled requests")
    check(sorted(pre + post) == sorted(submitted),
          f"Finish events before {pre} and after {post} the crash")
    return {"reqs": reqs, "free": free, "merged": merged, "pre": len(pre),
            "post": len(post), "lost": lost,
            "replay_ms": fe2.sched._round * ROUND_S * 1e3}


def preempt_ttft(cfg, params, device=None):
    """benchmarks/recovery.py's preemption scenario: BEST_EFFORT hogs hold
    both slots, INTERACTIVE arrivals suspend them; their TTFTs."""
    rng = np.random.RandomState(1)
    hogs = [Request(tokens=rng.randint(0, BENCH_VOCAB, 8), max_new_tokens=12)
            for _ in range(2)]
    inters = [Request(tokens=rng.randint(0, BENCH_VOCAB, 8), max_new_tokens=4)
              for _ in range(4)]
    clock = VirtualClock()
    fe = StreamingFrontend(
        cfg, params, frontend=FrontendConfig(max_queue=8, feed_depth=1, preempt_wait_ms=0.0),
        sched=SchedulerConfig(buckets=(8, 16), max_slots=2, prefill_group=1, chunk=2,
                              preempt=True),
        max_len=32, seed=0, clock=clock, device=device)
    for h in hogs:
        fe.submit(h, Priority.BEST_EFFORT)
    while fe.sched._free_slots() and fe.has_work():
        clock.now += ROUND_S
        fe.step()
    born = {fe.submit(q, Priority.INTERACTIVE): clock.now for q in inters}
    drain(fe, clock)
    ttft = [(ev.t - born[ev.rid]) * 1e3 for ev in fe.events
            if isinstance(ev, FirstToken) and ev.rid in born]
    check(len(ttft) == len(inters), "an interactive stream never started")
    return pctl(ttft, 99)


def frontend_runs(cfg, params, small, small_params, card):
    """Phase 13d: the streaming frontend and recovery at full width, launch
    counts from 0 and checked against the forwards, and each forward's
    kernel calls replayed against the plain versions; the schedule-only
    rows against the port's CPU run of the same simulations and configs
    on the reduced model."""
    calls, unwrap = count_forwards()
    kept, release = capture_kernel_calls(cfg)
    for kern in _build.KERNELS.values():
        kern.launches = 0
    t0 = time.perf_counter()
    rows, records, rounds = stream_stampede(cfg, params)
    stampede_s = time.perf_counter() - t0
    reqs = [Request(tokens=np.random.RandomState(i).randint(0, BENCH_VOCAB, n),
                    max_new_tokens=6) for i, n in enumerate((4, 8, 12, 8, 4, 12))]
    fe = StreamingFrontend(cfg, params, sched=STREAM_SCHED, max_len=32, seed=0,
                           clock=VirtualClock())
    fids = [fe.submit(r) for r in reqs]
    through = fe.run()
    crash = crash_replay(cfg, params)
    p99 = preempt_ttft(cfg, params)
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in _build.KERNELS.items()}
    unwrap()
    release()
    check(launches == expected_launches(cfg, calls)
          | {n: 0 for n in OFFLOAD_KERNELS}, f"frontend launches {launches}, forwards {calls}")
    kernel_errs = replay_kernel_calls(kept, "phase 13d")
    ref = ContinuousScheduler(cfg, params, sched=STREAM_SCHED, max_len=32, seed=0)
    rids = [ref.submit(r) for r in reqs]
    want = ref.run()
    check([(through[f][0], through[f][1].tolist()) for f in fids]
          == [("served", want[r].tokens.tolist()) for r in rids],
          "the pass-through frontend gave other tokens than its scheduler")
    for rid, (status, toks) in crash["merged"].items():
        f_status, f_toks = crash["free"][rid]
        check(status == f_status == "served", f"rid {rid}: {status} / {f_status}")
        near_tie(cfg, params, crash["reqs"][rid].tokens, f_toks.tolist(), toks.tolist(),
                 f"phase 13d: recovered rid {rid}", max_len=32)
    t0 = time.perf_counter()
    cpu_rows, cpu_records, cpu_rounds = stream_stampede(small, small_params, "cpu")
    cpu_crash = crash_replay(small, small_params, "cpu")
    cpu_p99 = preempt_ttft(small, small_params, "cpu")
    cpu_s = time.perf_counter() - t0
    check(rows == cpu_rows and records == cpu_records and rounds == cpu_rounds,
          f"the stampede's rows {rows} differ from the CPU's {cpu_rows}")
    check(crash["replay_ms"] == cpu_crash["replay_ms"] and p99 == cpu_p99,
          f"replay {crash['replay_ms']} / {cpu_crash['replay_ms']} ms, preempt p99 "
          f"{p99} / {cpu_p99} ms on the card / the CPU")
    rec = {"rows": rows, "stampede_rounds": rounds, "stampede_s": stampede_s,
           "recovery.replay_ms": crash["replay_ms"],
           "recovery.lost_requests": crash["lost"],
           "finish_before_after_crash": [crash["pre"], crash["post"]],
           "stream.preempt_ttft_p99_ms": p99, "launches": launches,
           "forwards": calls, "cpu_s": cpu_s, "kernel_errs": kernel_errs}
    print(f"phase 13d: {cfg.name} at full width: the stampede of "
          f"benchmarks/stream_slo.py in {rounds} rounds ({stampede_s:.2f} s): "
          f"{rows}, equal to the port's CPU run of the reduced model; a "
          f"pass-through frontend gives its scheduler's tokens; the crash at "
          f"round {CRASH_ROUND} loses {crash['lost']} requests ({crash['pre']} "
          f"finished before it, {crash['post']} after), replay "
          f"{crash['replay_ms']:.1f} ms, merged tokens equal the crash-free run's; "
          f"preemption TTFT p99 {p99:.1f} ms; launches {launches}  [{card}]")
    return launches, rec


def phase_prefix(cfg, params, card):
    """Phase 13: the shared-prefix page cache, the streaming frontend and
    crash recovery at full width; returns (launches, numbers)."""
    t_phase = time.perf_counter()
    reqs = prefix_queue(cfg.vocab)
    off_cfg = dataclasses.replace(PREFIX_CFG, prefix_cache=False)
    runs, toks = {}, {}
    for name, sc in (("off", off_cfg), ("on", PREFIX_CFG)):
        toks[name], runs[name], sched = prefix_run(cfg, params, reqs, sc)
        check(runs[name]["launches"] == expected_launches(cfg, runs[name]["forwards"])
              | {n: 0 for n in OFFLOAD_KERNELS},
              f"sharing {name}: launches {runs[name]['launches']}, forwards "
              f"{runs[name]['forwards']}")
    errs = prefix_kernel_checks(
        cfg, next(iter(sched.prefix._index.values())).hot["k"])
    del sched
    diverged = {}
    for i, r in enumerate(reqs):
        step = near_tie(cfg, params, r.tokens, toks["off"][i], toks["on"][i],
                        f"phase 13b: request {i} sharing on vs off", max_len=LLM_MAX_LEN)
        if step is not None:
            diverged[i] = step
    on, off = runs["on"], runs["off"]
    check(on["hit_rate"] > 0 and on["forwards"]["prefill_tokens"]
          < off["forwards"]["prefill_tokens"], "sharing saved no prefill work")
    check(on["counters"].get("sched.admitted{'path': 'prefix'}", 0) > 0,
          "no request admitted through a prefix wave")
    # the same queue's lengths on the reduced model on the CPU: the schedule
    # does not depend on the weights
    small = get_config(LLM_ARCH).reduced()
    small_params = bb.init_params(small, 0, device="cpu")
    small_reqs = [dataclasses.replace(r, tokens=r.tokens % small.vocab) for r in reqs]
    t0 = time.perf_counter()
    _, cpu, _ = prefix_run(small, small_params, small_reqs, PREFIX_CFG, device="cpu")
    cpu_s = time.perf_counter() - t0
    same = ("stats", "hit_rate", "rounds", "forwards", "counters")
    for k in same:
        a, b = on[k], cpu[k]
        if k == "forwards":
            a, b = ({n: v for n, v in x.items() if n != "prefill_host_s"} for x in (a, b))
        check(a == b, f"sharing on: {k} {a} on the card, {b} in the CPU rehearsal")
    for name, r in runs.items():
        print(f"phase 13b: sharing {name}: generate of {len(reqs)} requests in "
              f"{r['run_s']:.3f} s, {r['tokens']} tokens, {r['tokens_per_s']:.1f} "
              f"tokens/s; {r['forwards']['prefill_tokens']} tokens prefilled in "
              f"{r['forwards']['prefill']} group prefills and "
              f"{r['forwards']['prefill_chunk']} segments, "
              f"{r['forwards']['prefill_host_s']:.3f} s of prefill host time; "
              f"{r['rounds']} rounds, {r['forwards']['decode_step']} decode steps; "
              f"counters {r['counters']}  [{card}]")
    print(f"phase 13b: sharing on: prefix stats {on['stats']}, hit rate "
          f"{on['hit_rate']:.4f}, {on['hot_pages']} hot pages; equal to the "
          f"reduced model's CPU rehearsal ({cpu_s:.1f} s); tokens equal sharing "
          f"off's except at near-ties {diverged}")
    cold_launches, cold = cold_tier(cfg, params, card)
    fe_launches, fe = frontend_runs(cfg, params, small, small_params, card)
    launches = {n: on["launches"][n] + off["launches"][n] + cold_launches[n]
                + fe_launches[n] for n in _build.KERNELS}
    for part in (cold, fe):
        for n, e in part["kernel_errs"].items():
            errs[n] = max(errs.get(n, 0.0), e)
    numbers = {"queue": {"headers": PREFIX_HEADERS, "requests": PREFIX_REQS,
                         "tails": PREFIX_TAILS, "new": PREFIX_NEW},
               "off": off, "on": on, "near_ties": diverged, "cpu_rehearsal_s": cpu_s,
               "cold": cold, "frontend": fe, "kernel_errs": errs,
               "phase_s": time.perf_counter() - t_phase}
    print(f"phase 13: {numbers['phase_s']:.1f} s")
    return launches, numbers


# ----------------------------------------------- LM training (slice 9)
def lm_expected_launches(L: int, forwards: int) -> dict:
    """Launches of one value-and-grad of the backbone with remat: each
    checkpointed layer runs its forward twice (the first pass and the
    backward's recompute), so 2 flash and 4 RMSNorm forwards, then one
    flash and two RMSNorm backwards; the final norm once each way."""
    return {"flash_attention": 2 * L * forwards,
            "flash_attention_backward": L * forwards,
            "rmsnorm": (4 * L + 1) * forwards,
            "rmsnorm_backward": (2 * L + 1) * forwards}


def lm_counts() -> dict:
    return {n: _build.KERNELS[n].launches for n in LM_KERNELS + ("quantize",)}


def reset_counts() -> None:
    for kern in _build.KERNELS.values():
        kern.launches = 0


def exact_attention_grads(q, k, v, do, *, causal: bool, window: int,
                          q_offset: int = 0, kv_valid_len=None):
    """Dense attention in float64, one batch row at a time: (dq, dk, dv) of
    sum(out * do) by autograd, and each row's log-sum-exp of its scaled
    live scores (B, Hq, T), -inf for a row with no live key (whose output,
    and so each gradient through it, is 0)."""
    T, S, G = q.shape[1], k.shape[1], q.shape[2] // k.shape[2]
    qp = torch.arange(T, device=q.device)[:, None] + q_offset
    kp = torch.arange(S, device=q.device)[None, :]
    live = torch.ones(T, S, dtype=torch.bool, device=q.device)
    if causal:
        live &= kp <= qp
    if window > 0:
        live &= kp > qp - window
    grads, lses = [[], [], []], []
    for b in range(q.shape[0]):
        lb = live if kv_valid_len is None else live & (kp < int(kv_valid_len[b]))
        qb, kb, vb = (t[b:b + 1].double().requires_grad_() for t in (q, k, v))
        kr, vr = (t.repeat_interleave(G, 2) for t in (kb, vb))
        s = torch.einsum("bthd,bshd->bhts", qb, kr) / q.shape[-1] ** 0.5
        s = s.masked_fill(~lb, -float("inf"))
        lses.append(torch.logsumexp(s, dim=-1).detach())
        m = s.amax(dim=-1, keepdim=True).detach()
        e = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0)) * lb
        p = e / e.sum(dim=-1, keepdim=True).clamp(min=1e-300)
        out = torch.einsum("bhts,bshd->bthd", p, vr)
        for acc, g in zip(grads, torch.autograd.grad(out, (qb, kb, vb), do[b:b + 1].double())):
            acc.append(g)
        del s, e, p, out
    return [torch.cat(g) for g in grads], torch.cat(lses)


def rmsnorm_grads64(x, scale, g, eps: float = 1e-6):
    x64, s64 = (t.double().requires_grad_() for t in (x, scale))
    y = x64 * torch.rsqrt(torch.mean(x64 * x64, dim=-1, keepdim=True) + eps) * s64
    return torch.autograd.grad(y, (x64, s64), g.double())


def lm_kernel_checks() -> dict:
    """(a) The flash and RMSNorm backward kernels against float64 autograd
    of the dense functions and their plain versions, two calls bitwise,
    the forward's output with and without its log-sum-exp bitwise, the
    log-sum-exp against float64's.  Returns {kernel: max |err| over the
    cases}."""
    gen = torch.Generator(device="cuda").manual_seed(14)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    errs = {"flash_attention_backward": 0.0, "rmsnorm_backward": 0.0}
    report = []
    for (B, T, S, Hq, Hkv, D, causal, window, q_offset, valid) in LM_FLASH_CASES:
        q, k, v = randn(B, T, Hq, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D)
        do = randn(B, T, Hq, D)
        kw = dict(causal=causal, window=window, q_offset=q_offset,
                  kv_valid_len=None if valid is None else
                  torch.tensor(valid, dtype=torch.int32, device="cuda"))
        case = {"shape": (B, T, S, Hq, Hkv, D), "causal": causal, "window": window,
                "q_offset": q_offset, "kv_valid_len": valid}
        o_plain = flash_attention_cuda(q, k, v, **kw)
        o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
        check(torch.equal(o, o_plain), f"flash {case}: the output with the "
              "log-sum-exp differs from the output without it")
        got = flash_attention_backward_cuda(q, k, v, o, do, lse, **kw)
        again = flash_attention_backward_cuda(q, k, v, o, do, lse, **kw)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"flash backward {case}: two calls differ")
        plain = flash_attention_backward_ref(q, k, v, o, do, lse, **kw)
        ref, lse64 = exact_attention_grads(q, k, v, do, causal=causal, window=window,
                                           q_offset=q_offset, kv_valid_len=valid)
        for name, g, pl, r in zip(("dq", "dk", "dv"), got, plain, ref):
            check(bool(torch.isfinite(g).all()), f"flash backward {case}: {name} "
                  "not finite")
            err = (g.double() - r).abs().max().item()
            scale = r.abs().max().item()
            check(err <= LM_GRAD_TOL * scale, f"flash backward {case}: {name} off by "
                  f"{err:.3e}, over {LM_GRAD_TOL} of its scale {scale:.3e}")
            plain_err = (g.double() - pl.double()).abs().max().item()
            check(plain_err <= LM_GRAD_TOL * scale, f"flash backward {case}: {name} "
                  f"off its plain version by {plain_err:.3e}, over {LM_GRAD_TOL} of "
                  f"float64's scale {scale:.3e}")
            case[name] = err / scale
            case[f"{name}_vs_plain"] = plain_err / scale
            errs["flash_attention_backward"] = max(errs["flash_attention_backward"], err)
        if valid is not None and 0 in valid:       # a row with no live key
            b0 = valid.index(0)
            check(torch.equal(got[0][b0], torch.zeros_like(got[0][b0])),
                  f"flash backward {case}: dq of a row with no live key is not 0")
        fin = torch.isfinite(lse64)
        check(torch.equal(fin, torch.isfinite(lse)), f"flash {case}: rows without keys")
        lse_err = (lse.double() - lse64)[fin].abs().max().item()
        check(lse_err <= LM_LSE_TOL, f"flash {case}: log-sum-exp off by {lse_err:.3e}")
        case["lse"] = lse_err
        if q_offset or valid is not None:
            # the same gradient through the op a model calls: the forward
            # and backward kernels once each, bitwise the direct call's
            qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
            before = {n: _build.KERNELS[n].launches for n in LM_KERNELS[:2]}
            out = attention_ops.flash_attention_op(qg, kg, vg, **kw)
            via_op = torch.autograd.grad(out, (qg, kg, vg), do)
            torch.cuda.synchronize()
            ran = {n: _build.KERNELS[n].launches - before[n] for n in before}
            check(ran == {n: 1 for n in before}, f"flash {case}: a gradient through "
                  f"flash_attention_op launched {ran}")
            check(torch.equal(out, o) and all(torch.equal(a, b) for a, b in zip(via_op, got)),
                  f"flash {case}: the op's gradient differs from the kernels' own")
            case["through_op"] = True
            del qg, kg, vg, out, via_op
        report.append(case)
        del q, k, v, do, o, o_plain, lse, got, again, plain, ref, lse64
    N, d = LM_RMS_ROWS
    x, scale, g = randn(N, d), 1 + 0.1 * randn(d), randn(N, d)
    got = rmsnorm_backward_cuda(x, scale, g)
    again = rmsnorm_backward_cuda(x, scale, g)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "rmsnorm backward: two calls differ")
    rms = {}
    for name, gg, r in zip(("dx", "dscale"), got, rmsnorm_grads64(x, scale, g)):
        err, scl = (gg.double() - r).abs().max().item(), r.abs().max().item()
        check(err <= LM_RMS_TOL * scl, f"rmsnorm backward: {name} off by {err:.3e}, "
              f"over {LM_RMS_TOL} of its scale {scl:.3e}")
        rms[name] = err / scl
        errs["rmsnorm_backward"] = max(errs["rmsnorm_backward"], err)
    print(f"phase 14a: flash backward vs float64 autograd and vs its plain version "
          f"(error / float64's scale, bar {LM_GRAD_TOL}; log-sum-exp abs, bar "
          f"{LM_LSE_TOL}), two calls bitwise, "
          f"outputs with / without the log-sum-exp bitwise: {report}")
    print(f"phase 14a: rmsnorm backward at {LM_RMS_ROWS} vs float64 (error / scale, "
          f"bar {LM_RMS_TOL}), two calls bitwise: {rms}")
    return {"errs": errs, "flash_cases": report, "rmsnorm": rms}


def quantize_bitwise(x, centers, what: str) -> float:
    x = x.detach().contiguous()
    err = max_err(quantize_cuda(x, centers), quantize_ref(x, centers))
    print(f"phase 14{what}: quantize bitwise on {tuple(x.shape)}")
    return err


def flash_backward_bounds(B: int, T: int, Hq: int, D: int, elem: int = 4,
                          ops_per_s: float = TF32_OPS_PER_S / 3) -> dict:
    """Each flash backward kernel's least time (ms) at a causal T = S call:
    the dot kernel's bytes (o and dO read at ``elem`` bytes, dvec written
    at 4); the dK/dV kernel's 8 * D and the dQ kernel's 6 * D flops a live
    pair at ``ops_per_s``: by default as three TF32 products each on the
    tensor cores (3xTF32), for the bf16 kernels the bf16 rate."""
    pairs = B * Hq * T * (T + 1) // 2
    return {"flash_bwd_dot": (2 * B * T * Hq * D * elem + B * Hq * T * 4)
            / HBM_BYTES_PER_S * 1e3,
            "flash_bwd_dkdv": 8 * D * pairs / ops_per_s * 1e3,
            "flash_bwd_dq": 6 * D * pairs / ops_per_s * 1e3}


def lm_train(cfg, params, card) -> dict:
    """(b) make_train_step at train_4k's sequence length, two microbatches
    of 4 x 4096, full width and depth, the port's seed-0 weights."""
    from torch.profiler import ProfilerActivity, profile

    L = cfg.n_layers
    shape = InputShape("train_4k", LM_SEQ, LM_GLOBAL_BATCH, "train")
    step = make_train_step(cfg, shape, n_micro_override=LM_MICRO)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def batch():
        # uniform tokens and labels, as launch/train.py draws them
        return {k: torch.randint(0, cfg.vocab, (LM_GLOBAL_BATCH, LM_SEQ),
                                 generator=gen, device="cuda") for k in ("tokens", "labels")}

    batches = [batch() for _ in range(LM_STEPS + 2)]
    opt = opt_init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    p, opt, m = step(params, opt, batches[0])
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = lm_counts()
    expected = lm_expected_launches(L, LM_MICRO)
    check(all(launches[n] == expected[n] for n in expected) and launches["quantize"] == 0,
          f"launches of one train step {launches}, rehearsed {expected}")
    # the first step's momentum is its gradient (zero momentum, no decay)
    leaves = tree_leaves(opt["momentum"])
    bad = [i for i, t in enumerate(leaves)
           if not bool(torch.isfinite(t).all()) or float(t.abs().max()) == 0.0]
    check(not bad, f"gradient leaves not finite or all zero: {bad} of {len(leaves)}")
    losses, host = [float(m["loss"])], []
    for i in range(1, LM_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, opt, m = step(p, opt, batches[i])
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    peak = torch.cuda.max_memory_allocated()
    step_s = statistics.median(host)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        p, opt, m = step(p, opt, batches[LM_STEPS])
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    kernels = profiled_kernels(prof)
    busy_us = sum(us for us, _ in kernels.values())
    by = {}
    for key, (us, n) in kernels.items():
        for name, match in (("flash_bwd_dot", "flash_bwd_dot_kernel"),
                            ("flash_bwd_dkdv", "flash_bwd_dkdv_kernel"),
                            ("flash_bwd_dq", "flash_bwd_dq_kernel"),
                            ("rmsnorm_backward", "rmsnorm_backward_kernel"),
                            ("rmsnorm_dscale", "rmsnorm_dscale_kernel"),
                            ("flash_attention", "flash_attention_kernel"),
                            ("rmsnorm", "rmsnorm_kernel")):
            if match in key:
                cur = by.setdefault(name, [0.0, 0])
                cur[0] += us / 1e3
                cur[1] += n
                break
    # the flash backward's three kernels, each against its own bound at the
    # microbatch's shape, over the step's calls
    bwd_bounds = flash_backward_bounds(LM_MICRO_B, LM_SEQ, cfg.n_heads,
                                       cfg.resolved_head_dim)
    parts = [n for n in bwd_bounds if n in by]
    by["flash_attention_backward"] = [sum(by[n][0] for n in parts),
                                      sum(by[n][1] for n in parts)]
    bwd_share = {n: by[n][1] * bwd_bounds[n] / by[n][0] for n in parts}
    tokens = LM_GLOBAL_BATCH * LM_SEQ
    out = {"arch": cfg.name, "seq_len": LM_SEQ, "global_batch": LM_GLOBAL_BATCH,
           "n_micro": LM_MICRO, "first_step_s": first_s, "step_s": host,
           "step_s_median": step_s, "tokens_per_s": tokens / step_s,
           "peak_bytes": peak, "losses": losses, "launches_per_step": launches,
           "profiled_step_s": prof_s, "busy_share": busy_us / 1e6 / prof_s,
           "kernel_ms_by_name": by, "flash_backward_bound_share": bwd_share,
           "n_kernels": sum(n for _, n in kernels.values())}
    print(f"phase 14b: {cfg.name} at full width and depth ({L} layers, "
          f"{param_count(params)} params), train_4k's "
          f"T = {LM_SEQ}, global batch {LM_GLOBAL_BATCH} (cut from 256) in {LM_MICRO} "
          f"microbatches: step {step_s:.3f} s (median of {len(host)}; first "
          f"{first_s:.3f} s), {out['tokens_per_s']:.0f} tokens/s, peak "
          f"{peak / 2**30:.2f} GiB, losses {losses}; launches per step {launches} "
          f"(rehearsed {expected}); every one of {len(leaves)} gradient leaves "
          f"finite and nonzero; busy {out['busy_share']:.1%} of a profiled step "
          f"({prof_s:.3f} s, {out['n_kernels']} kernels); device ms (launches) by "
          f"kernel: {by}; the flash backward's kernels' shares of their own "
          f"bounds (dot: bytes; dK/dV 8 * D, dQ 6 * D flops a live pair in "
          f"3xTF32): {bwd_share}  [{card}]")
    return out


def lm_vs_cpu(cfg, params, batch=None, what: str = "phase 14c", *,
              loss_tol: float = LM_CPU_LOSS_TOL, grad_tol: float | None = LM_CPU_GRAD_TOL) -> dict:
    """forward_loss and every gradient leaf on the card against the port's
    CPU run of the same weights, on ``batch`` (numpy; by default a 2 x 128
    token batch): the loss within ``loss_tol`` relative, each leaf finite
    and within ``grad_tol`` of the CPU leaf's largest |value| (None: the
    distance is reported, not held)."""
    if batch is None:
        rng = np.random.RandomState(14)
        batch = {k: rng.randint(0, cfg.vocab, (2, 128)) for k in ("tokens", "labels")}
    res = {}
    for where, p in (("card", params), ("cpu", tree_to(params, "cpu"))):
        (loss, _), grads = value_and_grad(lambda pp: bb.forward_loss(cfg, pp, batch), p)
        res[where] = (loss.cpu(), [t.cpu() for t in tree_leaves(grads)])
    loss_err = abs(float(res["card"][0]) - float(res["cpu"][0])) / abs(float(res["cpu"][0]))
    check(loss_err <= loss_tol,
          f"{what}: forward_loss card vs CPU: {loss_err:.3e} relative")
    worst = 0.0
    for i, (a, b) in enumerate(zip(res["card"][1], res["cpu"][1])):
        e = (a.double() - b.double()).abs().max().item() / max(b.abs().max().item(), 1e-30)
        check(bool(torch.isfinite(a).all()) and (grad_tol is None or e <= grad_tol),
              f"{what}: gradient leaf {i} card vs CPU: {e:.3e} of scale")
        worst = max(worst, e)
    shapes = {k: tuple(v.shape) for k, v in batch.items()}
    print(f"{what}: forward_loss on {shapes} card vs CPU {loss_err:.3e} relative (bar "
          f"{loss_tol}); every one of {len(res['cpu'][1])} gradient leaves within "
          f"{worst:.3e} of its scale (bar {grad_tol or 'none: reported'})")
    return {"loss_rel_err": loss_err, "grad_err": worst}


def agile_lm_run(cfg, card) -> dict:
    """(d) AgileNN on tokens over the full-width backbone: AdamW steps on
    SyntheticTokens, one step's loss and gradients against the CPU, the
    quantize launches and the payload bits."""
    acfg = dataclasses.replace(cfg, agile=AgileSpec(
        enabled=True, extractor_channels=32, k=6, rho=0.7, lam=0.4))
    params = init_agile_lm_params(acfg, 0)
    data = SyntheticTokens(TokenDatasetSpec(vocab=AGILE_LM_VOCAB, seq_len=AGILE_LM_T + 1))
    toks = [torch.as_tensor(data.batch(AGILE_LM_B, seed=i), device="cuda")
            for i in range(AGILE_LM_STEPS)]

    def loss(p, t):
        return agile_lm_loss(acfg, p, t[:, :-1], t[:, -1])

    # one step on the card against the same machine's CPU, on AGILE_LM_CPU_B rows
    t_cpu = toks[0][:AGILE_LM_CPU_B]
    res = {}
    for where, p in (("card", params), ("cpu", tree_to(params, "cpu"))):
        tt = t_cpu if where == "card" else t_cpu.cpu()
        (val, _), grads = value_and_grad(lambda pp: loss(pp, tt), p)
        res[where] = (float(val), [t.cpu() for t in tree_leaves(grads)])
    worst = 0.0
    for i, (a, b) in enumerate(zip(res["card"][1], res["cpu"][1])):
        e = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
        check(e <= LM_CPU_GRAD_TOL, f"agile_lm gradient leaf {i} card vs CPU: {e:.3e}")
        worst = max(worst, e)
    loss_err = abs(res["card"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    check(loss_err <= LM_CPU_LOSS_TOL, f"agile_lm_loss card vs CPU: {loss_err:.3e}")
    bits = offload_payload_bits(acfg, params, toks[0][:, :-1])
    bits_cpu = offload_payload_bits(acfg, tree_to(params, "cpu"), toks[0][:, :-1].cpu())
    check(bits == bits_cpu == AGILE_LM_B * (32 - 6) * 3, f"payload bits {bits}, {bits_cpu}")
    opt = adamw_init(params)
    reset_counts()
    host, losses = [], []
    for t in toks:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (val, metrics), g = value_and_grad(lambda pp: loss(pp, t), params)
        params, opt = adamw_update(params, g, opt, lr=5e-3, weight_decay=0.0)
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
        losses.append(float(val))
    launches = lm_counts()
    expected = {**lm_expected_launches(cfg.n_layers, AGILE_LM_STEPS),
                "quantize": AGILE_LM_STEPS}
    check(launches == expected, f"agile_lm launches {launches}, rehearsed {expected}")
    check(all(math.isfinite(x) for x in losses), f"agile_lm losses {losses}")
    with torch.no_grad():
        feats = extract_token_features(params, toks[0][:, :-1])
    err = quantize_bitwise(feats[..., 6:], params["quant"]["centers"], "d")
    out = {"batch": AGILE_LM_B, "seq_len": AGILE_LM_T, "ig_steps": acfg.agile.ig_steps,
           "step_s": host, "losses": losses, "launches": launches,
           "cpu_loss_rel_err": loss_err, "cpu_grad_err": worst, "payload_bits": bits,
           "quantize_err": err}
    print(f"phase 14d: AgileNN on tokens over {cfg.name} (C = 32, k = 6, ig_steps "
          f"{acfg.agile.ig_steps}), B = {AGILE_LM_B}, T = {AGILE_LM_T}: {AGILE_LM_STEPS} "
          f"AdamW steps in {[round(s, 3) for s in host]} s, losses {losses}; launches "
          f"{launches} (rehearsed); card vs CPU on {AGILE_LM_CPU_B} rows: loss "
          f"{loss_err:.3e} relative, gradients within {worst:.3e} of scale; payload "
          f"{bits} bits on both  [{card}]")
    return out


def mcunet_loss(p, images, labels):
    """benchmarks/common.py's MCUNet loss."""
    logits = mcunet_apply(p, images)
    labels = torch.as_tensor(labels, device=logits.device).long()
    acc = torch.mean((torch.argmax(logits, -1) == labels).float())
    return cross_entropy(logits, labels), {"accuracy": acc}


def baseline_costs(cfg, params, images) -> dict:
    """Payload bytes and every InferenceCost field of each baseline."""
    macs = BASELINE_REMOTE_MACS
    return {"edge_only": dataclasses.asdict(edge_only_cost(cfg, images, remote_macs=macs)),
            "mcunet": dataclasses.asdict(mcunet_cost(cfg)),
            "deepcod": dataclasses.asdict(deepcod_cost(cfg, params["deepcod"], images,
                                                       remote_macs=macs)),
            "spinn": dataclasses.asdict(spinn_cost(cfg, params["spinn"], images,
                                                   remote_macs=macs))}


def baselines_run(card) -> dict:
    """(e) The four baselines at the paper's 96^2: forwards on a 256-image
    batch, train_baseline steps at B = 32, payloads and costs against the
    port's CPU run of the same weights."""
    cfg = AgileNNConfig(image_size=96)
    params = {"deepcod": deepcod_init(0, cfg), "spinn": spinn_init(1, cfg),
              "mcunet": mcunet_init(2, cfg)}
    data = SyntheticImages(ImageDatasetSpec(image_size=96))
    images, _ = data.batch(BATCH, seed=14)
    reset_counts()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = {"mcunet": mcunet_apply(params["mcunet"], images),
                "deepcod": deepcod_forward(params["deepcod"], images, train=False)[0],
                "spinn": spinn_forward(params["spinn"], images, train=False)[1]}
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
    fwd_launches = lm_counts()["quantize"]
    check(fwd_launches == 2, f"quantize launches of the forwards: {fwd_launches}")
    for name, o in outs.items():
        check(o.shape == (BATCH, cfg.n_classes) and bool(torch.isfinite(o).all()),
              f"{name} logits {tuple(o.shape)}")
    # the transmitted indices on the card and on the CPU: cuDNN and the
    # CPU's convs round apart, so a code that close to a codebook midpoint
    # flips; payloads and costs are held equal on the images with none
    sub = images[:BASELINE_COST_B]
    cpu = {k: tree_to(v, "cpu") for k, v in params.items()}
    flipped, n_idx = np.zeros(len(sub), bool), 0
    with torch.no_grad():
        for name, codes in (("deepcod", deepcod_code), ("spinn",
                            lambda p, x: extractor_apply(p["ex"], torch.as_tensor(
                                x, device=p["quant"]["centers"].device)))):
            card_idx, cpu_idx = (hard_indices(p[name]["quant"], codes(p[name], sub)).cpu()
                                 for p in (params, cpu))
            flipped |= (card_idx != cpu_idx).reshape(len(sub), -1).any(dim=1).numpy()
            n_flip = int((card_idx != cpu_idx).sum())
            n_idx += card_idx.numel()
            check(n_flip <= BASELINE_FLIP_TOL * card_idx.numel(),
                  f"{name}: {n_flip} of {card_idx.numel()} indices flip card vs CPU")
    clean = sub[~flipped]
    costs = baseline_costs(cfg, params, clean)
    costs_cpu = baseline_costs(cfg, cpu, clean)
    check(costs == costs_cpu, f"baseline costs card {costs} vs CPU {costs_cpu}")
    with torch.no_grad():
        code = deepcod_code(params["deepcod"], images)
        feats = extractor_apply(params["spinn"]["ex"], torch.as_tensor(images, device="cuda"))
    errs = [quantize_bitwise(code, params["deepcod"]["quant"]["centers"], "e"),
            quantize_bitwise(feats, params["spinn"]["quant"]["centers"], "e")]
    reset_counts()
    train = {}
    for name, loss_fn in (("deepcod", deepcod_loss), ("spinn", spinn_loss),
                          ("mcunet", mcunet_loss)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = train_baseline(loss_fn, params[name], data,
                                    steps=BASELINE_STEPS, batch_size=BASELINE_B)
        torch.cuda.synchronize()
        train[name] = {"s": time.perf_counter() - t0, "metrics": metrics}
        check(all(math.isfinite(v) for v in metrics.values()), f"{name}: {metrics}")
    launches = lm_counts()["quantize"]
    check(launches == 2 * BASELINE_STEPS, f"quantize launches of train_baseline: {launches}")
    print(f"phase 14e: baselines at 96^2: forwards of {BATCH} images in {fwd_s:.3f} s "
          f"({fwd_launches} quantize launches); of {BASELINE_COST_B} images "
          f"{int(flipped.sum())} hold an index that flips card vs CPU, and on the "
          f"other {len(clean)} payloads and costs equal the CPU run's: {costs}; "
          f"train_baseline {BASELINE_STEPS} steps at B = {BASELINE_B}: {train}, "
          f"{launches} quantize launches  [{card}]")
    return {"forward_s": fwd_s, "costs": costs, "flipped_images": int(flipped.sum()),
            "indices_compared": n_idx, "train": train,
            "quantize_launches": fwd_launches + launches, "quantize_err": max(errs)}


def lm_backward_inputs(gen):
    """The two backward kernels' inputs at the training path's shapes,
    drawn from ``gen`` in this order: the flash backward's q, k, v, dO (q
    (4, 4096, 14, 64), k/v (4, 4096, 2, 64)) with the forward's o and lse,
    then RMSNorm's x, scale and g at (16,384, 896); x and scale ask for
    gradients."""
    def randn(*shape, grad=False):
        return torch.randn(shape, generator=gen, device="cuda").requires_grad_(grad)

    B, T, Hq, Hkv, D = LM_MICRO_B, LM_SEQ, 14, 2, 64
    q, k, v, do = randn(B, T, Hq, D), randn(B, T, Hkv, D), randn(B, T, Hkv, D), randn(B, T, Hq, D)
    o, lse = flash_attention_cuda(q, k, v, return_lse=True)
    N, d = B * T, 896
    x, scale, g = randn(N, d, grad=True), (1 + 0.1 * randn(d)).requires_grad_(), randn(N, d)
    return (q, k, v, do, o, lse), (x, scale, g)


def lm_backward_work() -> dict:
    """(bytes, operations) of each backward kernel at those shapes: each
    input read once and each output written once; RMSNorm's 6 operations
    an element, the flash backward's 10 * D flops a live (causal) pair."""
    B, T, Hq, Hkv, D = LM_MICRO_B, LM_SEQ, 14, 2, 64
    N, d = B * T, 896
    pairs = B * Hq * T * (T + 1) // 2
    return {"rmsnorm_backward": ((3 * N * d + 2 * d) * 4, 6 * N * d),
            "flash_attention_backward": (
                (4 * B * T * Hq * D + 4 * B * T * Hkv * D + B * Hq * T) * 4, 10 * D * pairs)}


def lm_alone(card) -> dict:
    """Each backward kernel alone by torch.profiler at the training path's
    shapes: RMSNorm's two kernels against its bound; the flash backward's
    three each against its own, their sum against the 3xTF32 bound of the
    10 * D flops a live pair the gradient needs.  Runs in a fresh child
    process of this script (``lm_alone_child``), right after phase 14a."""
    flash_in, (x, scale, g) = lm_backward_inputs(torch.Generator(device="cuda").manual_seed(15))
    work = lm_backward_work()
    rms_bound_ms = bound(*work["rmsnorm_backward"])[0]
    flash_bound_ms = bound(*work["flash_attention_backward"])[0]
    alone = {"rmsnorm_backward": profiled_share(
        lambda: rmsnorm_backward_cuda(x.detach(), scale.detach(), g), "rmsnorm_",
        rms_bound_ms, sessions=LM_PROFILE_SESSIONS)}
    B, T, Hq, D = LM_MICRO_B, LM_SEQ, 14, 64
    pairs = B * Hq * T * (T + 1) // 2
    flash_tc_ms = 3 * 10 * D * pairs / TF32_OPS_PER_S * 1e3
    own = flash_backward_bounds(B, T, Hq, D)
    found = device_kernels(lambda: flash_attention_backward_cuda(*flash_in), reps=5,
                           match="flash_bwd_", flush=True, per_call=1,
                           sessions=LM_PROFILE_SESSIONS)
    split = {}
    for key, (us, n) in found.items():
        part = next(p for p in own if p + "_kernel" in key)
        split[part] = {"us": us, "events_per_call": n, "bound_ms": own[part],
                       "bound_share": own[part] * 1e3 / us}
    check(sorted(split) == sorted(own), f"flash backward kernels by torch.profiler: "
          f"{sorted(split)}")
    us = sum(p["us"] for p in split.values())
    alone["flash_attention_backward"] = {
        "us": us, "bound_share": flash_bound_ms * 1e3 / us,
        "tc_bound_ms": flash_tc_ms, "tc_bound_share": flash_tc_ms * 1e3 / us,
        "kernels": split}
    print(f"phase 14a: by torch.profiler alone: rmsnorm_backward "
          f"{alone['rmsnorm_backward']['us']:.2f} us, "
          f"{alone['rmsnorm_backward']['bound_share']:.1%} of its bound (events a call "
          f"{alone['rmsnorm_backward']['events_per_call']}); "
          f"flash_attention_backward {us:.2f} us, "
          f"{alone['flash_attention_backward']['bound_share']:.1%} of the fp32 "
          f"bound ({flash_bound_ms:.4f} ms), "
          f"{alone['flash_attention_backward']['tc_bound_share']:.1%} of the "
          f"3xTF32 bound ({flash_tc_ms:.4f} ms: 3 x 10 * D flops a live pair at "
          f"{TF32_OPS_PER_S / 1e12:.0f} TFLOP/s); by kernel {split}  [{card}]")
    return alone


def lm_alone_child(card) -> dict:
    """``lm_alone`` in a fresh child process of this script: the device
    events that torch.profiler has dropped late in this process (0-0.55
    events a call of a kernel, before the profiled train step too) follow
    the process, not the step.  The child prints its sessions' events a
    call and writes its numbers to a JSON file that this process reads."""
    sys.stdout.flush()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "lm_alone.json")
        t0 = time.perf_counter()
        subprocess.run([sys.executable, os.path.abspath(__file__), "--lm-alone", path],
                       check=True, timeout=LM_ALONE_TIMEOUT_S)
        child_s = time.perf_counter() - t0
        with open(path) as f:
            alone = json.load(f)
    kept = {"rmsnorm_backward": alone["rmsnorm_backward"]["events_per_call"],
            **{f"flash_backward.{n}": k["events_per_call"]
               for n, k in alone["flash_attention_backward"]["kernels"].items()}}
    alone["child_s"] = child_s
    print(f"phase 14a: the backward kernels alone, by torch.profiler in a child process "
          f"({child_s:.1f} s): events kept a call {kept}")
    return alone


def lm_rows(errs, launches, card) -> tuple:
    """The two backward kernels' rows of the kernels line: time at the
    training path's shapes, the plain version's, the library call's
    backward (timed as a yardstick only) and the bound; then the flash
    backward's time at D = 128 against the library's."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def sdpa_graph(q, k, v, do):
        """SDPA's graph on the same inputs (heads first, kv heads
        expanded) with its dO."""
        G = q.shape[2] // k.shape[2]
        qt = q.transpose(1, 2).contiguous().requires_grad_()
        kt = k.repeat_interleave(G, 2).transpose(1, 2).contiguous().requires_grad_()
        vt = v.repeat_interleave(G, 2).transpose(1, 2).contiguous().requires_grad_()
        ot = sdpa(qt, kt, vt, is_causal=True)
        return ot, (qt, kt, vt), do.transpose(1, 2).contiguous()

    (q, k, v, do, o, lse), (x, scale, g) = lm_backward_inputs(gen)
    ot, ins_t, dot = sdpa_graph(q, k, v, do)
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    ol = flash_attention_ref(ql, kl, vl)
    d = x.shape[1]
    y_lib = torch.nn.functional.rms_norm(x, (d,), scale, 1e-6)
    y_ref = rmsnorm_ref(x, scale)
    work = lm_backward_work()
    specs = [
        ("rmsnorm_backward", "src/repro_torch/csrc/rmsnorm_backward.cu",
         "src/repro/kernels/rmsnorm/kernel.py:25",
         lambda: rmsnorm_backward_cuda(x.detach(), scale.detach(), g),
         lambda: torch.autograd.grad(y_ref, (x, scale), g, retain_graph=True),
         lambda: torch.autograd.grad(y_lib, (x, scale), g, retain_graph=True),
         TIMING_REPS),
        ("flash_attention_backward", "src/repro_torch/csrc/flash_attention_backward.cu",
         "src/repro/kernels/attention/kernel.py:78",
         lambda: flash_attention_backward_cuda(q, k, v, o, do, lse),
         lambda: torch.autograd.grad(ol, (ql, kl, vl), do, retain_graph=True),
         lambda: torch.autograd.grad(ot, ins_t, dot, retain_graph=True), 5),
    ]
    rows = []
    for name, src, replaces, kern, plain, library, reps in specs:
        nbytes, ops = work[name]
        bound_ms, bound_by = bound(nbytes, ops)
        ms, plain_ms, library_ms = (time_ms(fn, reps=reps) for fn in (kern, plain, library))
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                     "launches": launches[name], "max_abs_err": errs[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": library_ms})
        print(f"phase 14: {name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"backward {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
              f"{nbytes} B, {ops} ops), {launches[name]} launches on the training "
              f"path  [{card}]")
    del q, k, v, do, o, lse, ot, ins_t, dot, ol, ql, kl, vl

    # the D = 128 instantiation at qwen2-1.5b's heads against SDPA's backward
    B2, T2, Hq2, Hkv2 = LM_FLASH_D128
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda") for shape in (
        (B2, T2, Hq2, 128), (B2, T2, Hkv2, 128), (B2, T2, Hkv2, 128), (B2, T2, Hq2, 128)))
    o, lse = flash_attention_cuda(q, k, v, return_lse=True)
    ot, ins_t, dot = sdpa_graph(q, k, v, do)
    pairs2 = B2 * Hq2 * T2 * (T2 + 1) // 2
    d128 = {"shape": (B2, T2, T2, Hq2, Hkv2, 128),
            "ms": time_ms(lambda: flash_attention_backward_cuda(q, k, v, o, do, lse), reps=10),
            "library_ms": time_ms(lambda: torch.autograd.grad(ot, ins_t, dot,
                                                              retain_graph=True), reps=10),
            "bound_ms": bound((4 * B2 * T2 * Hq2 * 128 + 4 * B2 * T2 * Hkv2 * 128
                               + B2 * Hq2 * T2) * 4, 10 * 128 * pairs2)[0],
            "tc_bound_ms": 3 * 10 * 128 * pairs2 / TF32_OPS_PER_S * 1e3}
    print(f"phase 14: flash_attention_backward at qwen2-1.5b's heads "
          f"{d128['shape']}, causal: {d128['ms']:.4f} ms, SDPA backward "
          f"{d128['library_ms']:.4f} ms, fp32 bound {d128['bound_ms']:.4f} ms, "
          f"3xTF32 bound {d128['tc_bound_ms']:.4f} ms  [{card}]")
    return rows, {"flash_d128": d128}


def phase_lm(cfg, params, card):
    """Phase 14: (a)-(e); returns (launches on the main paths by kernel,
    the rows of the two backward kernels, numbers)."""
    t_phase = time.perf_counter()
    parts = {}
    t0 = time.perf_counter()
    checks = lm_kernel_checks()
    alone = lm_alone_child(card)
    parts["a"] = time.perf_counter() - t0
    with fp32_math():
        t0 = time.perf_counter()
        train = lm_train(cfg, params, card)
        parts["b"] = time.perf_counter() - t0
        launches = dict(train["launches_per_step"])
        t0 = time.perf_counter()
        vs_cpu = lm_vs_cpu(cfg, params)
        parts["c"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        agile = agile_lm_run(cfg, card)
        parts["d"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        base = baselines_run(card)
        parts["e"] = time.perf_counter() - t0
    launches["quantize"] = agile["launches"]["quantize"] + base["quantize_launches"]
    for name in LM_KERNELS:
        launches[name] += agile["launches"][name]
    checks["errs"]["quantize"] = max(agile["quantize_err"], base["quantize_err"])
    rows, timing = lm_rows(checks["errs"], launches, card)
    timing["alone"] = alone
    numbers = {"checks": checks, "train": train, "vs_cpu": vs_cpu, "agile_lm": agile,
               "baselines": base, "timing": timing, "part_s": parts,
               "phase_s": time.perf_counter() - t_phase}
    print(f"phase 14: {numbers['phase_s']:.1f} s, by part "
          f"{ {k: round(v, 1) for k, v in parts.items()} }")
    return launches, rows, numbers


# ------------------------------------------------------------ slice 11 ---
def slice11_counts() -> dict:
    return {n: k.launches for n, k in _build.KERNELS.items()}


def check_launches(got: dict, expect: dict, what: str) -> None:
    """Every kernel's launches exactly ``expect``'s (0 for a kernel it
    does not name)."""
    full = {n: expect.get(n, 0) for n in got}
    check(got == full, f"{what}: launches {got}, expected {full}")


def flash_work(B: int, T: int, S: int, H: int, D: int, causal: bool) -> dict:
    """(bytes, operations) of the flash forward and backward at q (B, T,
    H, D), k/v (B, S, H, D), no window or offset: each input read and each
    output written once; 4 * D flops a live (query, key) pair forward, 10
    * D backward (dot: o and dO read, dvec written; the log-sum-exp
    read).  Causal, query t sees keys 0 .. t."""
    live = sum(min(t + 1, S) for t in range(T)) if causal else T * S
    pairs = B * H * live
    return {"forward": ((2 * B * T * H * D + 2 * B * S * H * D) * 4, 4 * D * pairs),
            "backward": ((4 * B * T * H * D + 4 * B * S * H * D + B * H * T) * 4,
                         10 * D * pairs),
            "pairs": pairs}


def slice11_kernels(card) -> dict:
    """Phase 15a: flash (forward and backward) at whisper-tiny's shapes:
    its encoder (T = S = 1,500, not causal), its cross-attention (448
    queries against 1,500 frames), its decoder's causal self-attention at
    the train shape (B = 16, T = 448) and at the serving prefill's (a
    4-token prompt), all at G = 1; decode attention at the cross shape
    (attend_len 1,500), at the decoder's self shape (a 448-slot cache at
    the first and last serving depth, G = 1) and on a full 8,192-slot
    long_context ring (qwen2-0.5b's heads); each against its plain
    version (the backward also against float64 autograd), with its time
    beside its bound and the library call's."""
    asr, llm = get_config(ASR_ARCH), get_config(LLM_ARCH)
    B, F, H, D = ASR_BATCH, asr.encdec.n_frames, asr.n_heads, asr.resolved_head_dim
    gen = torch.Generator(device="cuda").manual_seed(151)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def heads_first(t, rep=1):
        return t.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()

    errs = dict.fromkeys(("flash_attention", "flash_attention_backward",
                          "decode_attention"), 0.0)
    flash = {}
    for what, (Bf, T, S, causal) in (
            ("encoder", (B, F, F, False)), ("cross", (B, ASR_MAX_LEN, F, False)),
            ("decoder self, train", (ASR_TRAIN_B, ASR_TRAIN_T, ASR_TRAIN_T, True)),
            ("decoder self, prefill", (B, ASR_PROMPT, ASR_PROMPT, True))):
        q, k, v, do = randn(Bf, T, H, D), randn(Bf, S, H, D), randn(Bf, S, H, D), randn(Bf, T, H, D)
        o, lse = flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
        errs["flash_attention"] = max(errs["flash_attention"], close_err(
            o, flash_attention_ref(q, k, v, causal=causal), LLM_KERNEL_TOL,
            f"phase 15a: flash at the {what} shape"))
        got = flash_attention_backward_cuda(q, k, v, o, do, lse, causal=causal)
        plain = flash_attention_backward_ref(q, k, v, o, do, lse, causal=causal)
        ref, _ = exact_attention_grads(q, k, v, do, causal=causal, window=0)
        case = {"q": (Bf, T, H, D), "kv": (Bf, S, H, D), "causal": causal}
        for name, g, pl, r in zip(("dq", "dk", "dv"), got, plain, ref):
            check(bool(torch.isfinite(g).all()), f"phase 15a: {what} {name} not finite")
            err, scale = (g.double() - r).abs().max().item(), r.abs().max().item()
            plain_err = (g.double() - pl.double()).abs().max().item()
            check(err <= LM_GRAD_TOL * scale and plain_err <= LM_GRAD_TOL * scale,
                  f"phase 15a: flash backward at the {what} shape: {name} off float64 "
                  f"by {err:.3e}, off its plain version by {plain_err:.3e}, over "
                  f"{LM_GRAD_TOL} of float64's scale {scale:.3e}")
            case[name], case[f"{name}_vs_plain"] = err / scale, plain_err / scale
            errs["flash_attention_backward"] = max(errs["flash_attention_backward"], err)
        del plain, ref
        qt, kt, vt = (heads_first(t).requires_grad_() for t in (q, k, v))
        ot, dot = sdpa(qt, kt, vt, is_causal=causal), heads_first(do)
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        ol = flash_attention_ref(ql, kl, vl, causal=causal)
        work = flash_work(Bf, T, S, H, D, causal)
        (fb, fby), (bb_ms, bby) = bound(*work["forward"]), bound(*work["backward"])
        with torch.no_grad():
            case["forward"] = {
                "ms": time_ms(lambda: flash_attention_cuda(q, k, v, causal=causal)),
                "plain_ms": time_ms(lambda: flash_attention_ref(q, k, v, causal=causal),
                                    reps=10),
                "library_ms": time_ms(lambda: sdpa(qt, kt, vt, is_causal=causal)),
                "bound_ms": fb, "bound_by": fby,
                "tc_bound_ms": 3 * work["forward"][1] / TF32_OPS_PER_S * 1e3}
        case["backward"] = {
            "ms": time_ms(lambda: flash_attention_backward_cuda(q, k, v, o, do, lse,
                                                                causal=causal), reps=10),
            "plain_ms": time_ms(lambda: torch.autograd.grad(ol, (ql, kl, vl), do,
                                                            retain_graph=True), reps=5),
            "library_ms": time_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                                              retain_graph=True), reps=10),
            "bound_ms": bb_ms, "bound_by": bby,
            "tc_bound_ms": 3 * work["backward"][1] / TF32_OPS_PER_S * 1e3}
        flash[what] = case
        del q, k, v, do, o, lse, got, qt, kt, vt, ot, dot, ql, kl, vl, ol
    decode = {}
    ring = (1, llm.long_context_window, llm.n_heads, llm.n_kv_heads, llm.resolved_head_dim)
    for what, (Bd, S, Hq, Hkv, D), n in (
            ("cross", (B, F, H, H, D), F),
            ("self, first step", (B, ASR_MAX_LEN, H, H, D), ASR_PROMPT + 1),
            ("self, last step", (B, ASR_MAX_LEN, H, H, D), ASR_PROMPT + ASR_NEW - 1),
            ("ring", ring, ring[1])):
        page = auto_page_size(S) or DEFAULT_PAGE
        qd, kc, vc = randn(Bd, 1, Hq, D), randn(Bd, S, Hkv, D), randn(Bd, S, Hkv, D)
        errs["decode_attention"] = max(errs["decode_attention"], close_err(
            decode_attention_cuda(qd, kc, vc, n, page_size=page),
            decode_attention_ref(qd, kc, vc, n), LLM_KERNEL_TOL,
            f"phase 15a: decode attention at the {what} shape"))
        G = Hq // Hkv
        qdt, kct, vct = heads_first(qd), heads_first(kc, G), heads_first(vc, G)
        live = (torch.arange(S, device="cuda") < n).view(1, 1, 1, S)
        b_ms, b_by = bound((2 * Bd * Hq * D + 2 * Bd * n * Hkv * D) * 4,
                           4 * Bd * Hq * n * D)
        decode[what] = {
            "q": (Bd, 1, Hq, D), "cache": (Bd, S, Hkv, D), "attend_len": n,
            "ms": time_ms(lambda: decode_attention_cuda(qd, kc, vc, n, page_size=page)),
            "plain_ms": time_ms(lambda: decode_attention_ref(qd, kc, vc, n)),
            "library_ms": time_ms(lambda: sdpa(qdt, kct, vct, attn_mask=live)),
            "bound_ms": b_ms, "bound_by": b_by}
    torch.cuda.synchronize()
    print(f"phase 15a: whisper-tiny's shapes (G = 1) and the long_context ring, within "
          f"{LLM_KERNEL_TOL} of the plain versions (the backward within {LM_GRAD_TOL} of "
          f"float64's scale, error / scale): flash {flash}; decode attention {decode}; "
          f"max |err| {errs}  [{card}]")
    return {"errs": errs, "flash": flash, "decode": decode}


def vlm_requests(cfg, n: int, text: int, new: int, seed: int) -> list:
    """n requests of ``text`` uniform tokens behind n_patches normal patch
    embeddings (the stubbed InternViT's output), ``new`` greedy tokens."""
    rng = np.random.RandomState(seed)
    P, Vd = cfg.vlm.n_patches, cfg.vlm.vision_dim
    return [Request(tokens=rng.randint(0, cfg.vocab, text), max_new_tokens=new,
                    extras={"patches": rng.standard_normal((P, Vd)).astype(np.float32)})
            for _ in range(n)]


def asr_requests(cfg, n: int, seed: int) -> list:
    """n requests of ASR_PROMPT uniform tokens over n_frames normal frame
    embeddings (the stubbed conv frontend's output), ASR_NEW greedy
    tokens."""
    rng = np.random.RandomState(seed)
    F = cfg.encdec.n_frames
    return [Request(tokens=rng.randint(0, cfg.vocab, ASR_PROMPT), max_new_tokens=ASR_NEW,
                    extras={"frames": rng.standard_normal((F, cfg.d_model)).astype(np.float32)})
            for _ in range(n)]


def serve_extras(cfg, params, reqs, max_len: int, expect, what: str, card) -> dict:
    """``ServeEngine(max_len).generate`` of requests with extras, launch
    counts from 0 and checked exactly against ``expect(steps)``; wall s,
    tokens/s and peak memory; the calls ``kernel_picks`` names in each
    forward of a second generate, held against the plain versions; then
    the prefill alone."""
    eng = ServeEngine(cfg, params, max_len=max_len)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = slice11_counts()
    steps = outs[0].steps
    check_launches(launches, expect(steps), what)
    new = reqs[0].max_new_tokens
    for c in outs:
        check(c.steps == new and len(c.tokens) == new and c.tokens.min() >= 0
              and c.tokens.max() < cfg.vocab,
              f"{what}: a completion of {len(c.tokens)} tokens, {c.steps} steps")
    peak = torch.cuda.max_memory_allocated()
    kept, restore = capture_kernel_calls(cfg)
    try:
        eng.generate(reqs)
    finally:
        restore()
    kernel_errs = replay_kernel_calls(kept, what)
    del kept
    batch = {"tokens": torch.as_tensor(np.stack([r.tokens for r in reqs]), device="cuda"),
             **{k: torch.as_tensor(np.stack([r.extras[k] for r in reqs]), device="cuda")
                for k in reqs[0].extras}}
    host = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, total_T = bb.prefill(cfg, params, batch, max_len=max_len)
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
    out = {"requests": len(reqs), "context": total_T, "new_tokens": new,
           "generate_s": wall, "tokens_per_s": len(reqs) * new / wall,
           "peak_bytes": peak, "launches": launches, "kernel_errs": kernel_errs,
           "prefill_s": statistics.median(host),
           "greedy_tokens_row0": outs[0].tokens.tolist()}
    print(f"{what}: ServeEngine(max_len={max_len}).generate of {len(reqs)} requests, "
          f"context {total_T}, {new} greedy tokens each: {wall:.3f} s, "
          f"{out['tokens_per_s']:.1f} tokens/s, peak {out['peak_bytes'] / 2**30:.2f} GiB; "
          f"its prefill alone {out['prefill_s'] * 1e3:.1f} ms; launches "
          f"{ {n: c for n, c in launches.items() if c} } (exact)  [{card}]")
    return out


def card_vs_cpu(cfg, params, reqs, max_len: int, what: str) -> dict:
    """The same params and requests (their extras too) on the card and on
    the port's CPU: prefill logits within LLM_LOGIT_TOL, greedy tokens of
    ``ServeEngine(max_len).generate`` equal up to a near-tie."""
    cpu = tree_to(params, "cpu")
    extras = reqs[0].extras or {}
    batch = {"tokens": np.stack([r.tokens for r in reqs]),
             **{k: np.stack([r.extras[k] for r in reqs]) for k in extras}}
    lg, _, _ = bb.prefill(cfg, params, {k: torch.as_tensor(v, device="cuda")
                                        for k, v in batch.items()}, max_len=max_len)
    lc, _, _ = bb.prefill(cfg, cpu, {k: torch.as_tensor(v) for k, v in batch.items()},
                          max_len=max_len)
    diff = (lg.cpu() - lc).abs().max().item()
    check(torch.allclose(lg.cpu(), lc, atol=LLM_LOGIT_TOL, rtol=LLM_LOGIT_TOL),
          f"{what}: prefill logits differ from the CPU run by {diff}")
    card_out = ServeEngine(cfg, params, max_len=max_len).generate(reqs)
    host_out = ServeEngine(cfg, cpu, max_len=max_len, device="cpu").generate(reqs)
    same, splits = 0, []
    for b, (c, h) in enumerate(zip(card_out, host_out)):
        at = near_tie(cfg, cpu, reqs[b].tokens, h.tokens, c.tokens, f"{what}: row {b}",
                      max_len, reqs[b].extras)
        same += at is None
        splits.append(at)
    print(f"{what}: {len(reqs)} requests of {batch['tokens'].shape[1]} tokens"
          f"{' + ' + str(sorted(extras)) if extras else ''}: prefill logits |card - CPU| "
          f"max {diff:.3e} (bar {LLM_LOGIT_TOL} abs + rel); greedy tokens "
          f"({reqs[0].max_new_tokens} a row) equal on {same} of {len(reqs)} rows, "
          f"divergence steps {splits}")
    return {"prefill_logit_max_abs_diff_vs_cpu": diff, "greedy_rows_equal_vs_cpu": same,
            "divergence_steps": splits}


def train_extras(cfg, params, batches, expect, what: str, card) -> dict:
    """``make_train_step`` (one microbatch) over ``batches``: launch counts
    of the first step from 0 and checked exactly, every gradient leaf
    (its momentum, zero before it) finite and nonzero; host s a step,
    tokens (positions) / s and peak memory."""
    B, T = batches[0]["tokens"].shape
    if cfg.vlm is not None:
        T += batches[0]["patches"].shape[1]
    step = make_train_step(cfg, InputShape("train", T, B, "train"), n_micro_override=1)
    opt = opt_init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    p, host, losses = params, [], []
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, opt, m = step(p, opt, batch)
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        if i == 0:
            launches = slice11_counts()
            reset_counts()
            check_launches(launches, expect, f"{what}: one train step")
            leaves = tree_leaves(opt["momentum"])
            bad = [j for j, t in enumerate(leaves)
                   if not bool(torch.isfinite(t).all()) or float(t.abs().max()) == 0.0]
            check(not bad, f"{what}: gradient leaves not finite or all zero: {bad} of "
                  f"{len(leaves)}")
    later = slice11_counts()
    check(all(later[n] == launches[n] * (len(batches) - 1) for n in later),
          f"{what}: launches of the later steps {later}, one step's {launches}")
    check(all(math.isfinite(x) for x in losses), f"{what}: losses {losses}")
    step_s = statistics.median(host[1:])
    out = {"batch": B, "positions": T, "step_s": host, "step_s_median": step_s,
           "tokens_per_s": B * T / step_s, "peak_bytes": torch.cuda.max_memory_allocated(),
           "losses": losses, "launches_per_step": launches, "gradient_leaves": len(leaves)}
    print(f"{what}: make_train_step at B = {B} x T = {T}: steps {[round(s, 3) for s in host]} "
          f"s (the first left out of the rate), {out['tokens_per_s']:.0f} "
          f"positions/s after the first, peak {out['peak_bytes'] / 2**30:.2f} GiB, losses "
          f"{losses}; launches of one step { {n: c for n, c in launches.items() if c} } "
          f"(exact); every one of {len(leaves)} gradient leaves finite and nonzero  [{card}]")
    del p, opt
    return out


def vlm_run(card) -> tuple:
    """Phase 15b-c: internvl2-1b at full width, seed-0 weights: serving
    through the engine with patches, the card against the CPU, training
    at T = 4,096 (256 patches + 3,840 tokens)."""
    cfg = get_config(VLM_ARCH)
    t0 = time.perf_counter()
    params = bb.init_params(cfg, seed=0)
    init_s = time.perf_counter() - t0
    L = cfg.n_layers
    serve = serve_extras(
        cfg, params, vlm_requests(cfg, VLM_BATCH, VLM_TEXT, VLM_NEW, 150), VLM_MAX_LEN,
        lambda steps: {"rmsnorm": (2 * L + 1) * steps, "flash_attention": L,
                       "decode_attention": L * (steps - 1)},
        f"phase 15b: {VLM_ARCH}", card)
    launches = dict(serve["launches"])
    vs_cpu = card_vs_cpu(cfg, params, vlm_requests(cfg, VLM_CPU_B, VLM_CPU_TEXT,
                                                     VLM_CPU_NEW, 151),
                           VLM_CPU_MAX_LEN, f"phase 15b: {VLM_ARCH} card vs CPU")
    gen = torch.Generator(device="cuda").manual_seed(152)
    P, Vd = cfg.vlm.n_patches, cfg.vlm.vision_dim
    batches = [{"tokens": torch.randint(0, cfg.vocab, (VLM_TRAIN_B, VLM_TRAIN_TEXT),
                                        generator=gen, device="cuda"),
                "labels": torch.randint(0, cfg.vocab, (VLM_TRAIN_B, VLM_TRAIN_TEXT),
                                        generator=gen, device="cuda"),
                "patches": torch.randn((VLM_TRAIN_B, P, Vd), generator=gen, device="cuda")}
               for _ in range(VLM_TRAIN_STEPS)]
    train = train_extras(cfg, params, batches, lm_expected_launches(L, 1),
                         f"phase 15c: {VLM_ARCH}", card)
    for n, c in train["launches_per_step"].items():
        launches[n] += c * len(batches)
    rng = np.random.RandomState(154)
    train["vs_cpu"] = lm_vs_cpu(cfg, params, {
        "tokens": rng.randint(0, cfg.vocab, (TRAIN_CPU_B, TRAIN_CPU_T)),
        "labels": rng.randint(0, cfg.vocab, (TRAIN_CPU_B, TRAIN_CPU_T)),
        "patches": rng.standard_normal((TRAIN_CPU_B, P, Vd)).astype(np.float32)},
        f"phase 15c: {VLM_ARCH}")
    out = {"params": param_count(params), "init_s": init_s, "serve": serve,
           "vs_cpu": vs_cpu, "train": train}
    del params, batches
    torch.cuda.empty_cache()
    return launches, out


def asr_run(card) -> tuple:
    """Phase 15d: whisper-tiny at full width, seed-0 weights: serving with
    1,500 frames a request, the card against the CPU, training at B = 16
    x (1,500 frames, 448 tokens)."""
    cfg = get_config(ASR_ARCH)
    params = bb.init_params(cfg, seed=0)
    Le, Ld = cfg.encdec.n_encoder_layers, cfg.n_layers
    # the encoder's self-attention, each decoder layer's self and cross
    # attention in the prefill; self and cross decode attention a step
    serve = serve_extras(
        cfg, params, asr_requests(cfg, ASR_BATCH, 160), ASR_MAX_LEN,
        lambda steps: {"flash_attention": Le + 2 * Ld,
                       "decode_attention": 2 * Ld * (steps - 1)},
        f"phase 15d: {ASR_ARCH}", card)
    launches = dict(serve["launches"])
    vs_cpu = card_vs_cpu(cfg, params, asr_requests(cfg, ASR_CPU_B, 161), ASR_MAX_LEN,
                           f"phase 15d: {ASR_ARCH} card vs CPU")
    gen = torch.Generator(device="cuda").manual_seed(162)
    F = cfg.encdec.n_frames
    batches = [{"tokens": torch.randint(0, cfg.vocab, (ASR_TRAIN_B, ASR_TRAIN_T),
                                        generator=gen, device="cuda"),
                "labels": torch.randint(0, cfg.vocab, (ASR_TRAIN_B, ASR_TRAIN_T),
                                        generator=gen, device="cuda"),
                "frames": torch.randn((ASR_TRAIN_B, F, cfg.d_model), generator=gen,
                                      device="cuda")}
               for _ in range(ASR_TRAIN_STEPS)]
    # remat runs each layer's forward twice: 2 (Le + 2 Ld) flash forwards,
    # Le + 2 Ld backwards; LayerNorm is plain torch
    train = train_extras(cfg, params, batches,
                         {"flash_attention": 2 * (Le + 2 * Ld),
                          "flash_attention_backward": Le + 2 * Ld},
                         f"phase 15d: {ASR_ARCH}", card)
    for n, c in train["launches_per_step"].items():
        launches[n] += c * len(batches)
    rng = np.random.RandomState(164)
    train["vs_cpu"] = lm_vs_cpu(cfg, params, {
        "tokens": rng.randint(0, cfg.vocab, (TRAIN_CPU_B, TRAIN_CPU_T)),
        "labels": rng.randint(0, cfg.vocab, (TRAIN_CPU_B, TRAIN_CPU_T)),
        "frames": rng.standard_normal((TRAIN_CPU_B, F, cfg.d_model)).astype(np.float32)},
        f"phase 15d: {ASR_ARCH}")
    out = {"params": param_count(params), "serve": serve, "vs_cpu": vs_cpu,
           "train": train}
    del params, batches
    torch.cuda.empty_cache()
    return launches, out


def long_context_run(cfg, params, card) -> tuple:
    """Phase 15e: qwen2-0.5b's prefill of a LONG_PROMPT-token prompt with
    long_context (a window of long_context_window tokens and a ring of as
    many slots), timed with its peak memory; again with LONG_DECODE greedy
    decode steps past the ring's wrap, launch counts exact; the first call
    of each kernel in every forward held against its plain version on its
    own inputs (layer 0's windowed flash among them); a LONG_SHORT-token
    prompt giving the same greedy tokens with long_context as without."""
    W, L = cfg.long_context_window, cfg.n_layers
    tokens = torch.as_tensor(np.random.RandomState(153).randint(0, cfg.vocab, (1, LONG_PROMPT)),
                             device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bb.prefill(cfg, params, {"tokens": tokens}, long_context=True)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    kept, restore = capture_kernel_calls(cfg)
    reset_counts()
    try:
        logits, cache, T = bb.prefill(cfg, params, {"tokens": tokens}, long_context=True)
        check(cache["k"].shape[2] == W and T == LONG_PROMPT,
              f"phase 15e: a ring of {cache['k'].shape[2]} slots after {T} tokens")
        host, seq = [], []
        tok = torch.argmax(logits, -1)
        for i in range(LONG_DECODE):
            seq.append(int(tok))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = bb.decode_step(cfg, params, tok[:, None], cache, T + i)
            torch.cuda.synchronize()
            host.append(time.perf_counter() - t0)
            check(bool(torch.isfinite(logits).all()), f"phase 15e: decode step {i} logits")
            tok = torch.argmax(logits, -1)
    finally:
        restore()
    launches = slice11_counts()
    check_launches(launches, {"rmsnorm": (2 * L + 1) * (1 + LONG_DECODE),
                              "flash_attention": L, "decode_attention": L * LONG_DECODE},
                   "phase 15e")
    check([kw.get("window") for _, kw in kept["flash_attention"]] == [W],
          f"phase 15e: layer 0's flash call took {kept['flash_attention'][0][1]}")
    errs = replay_kernel_calls(kept, "phase 15e")
    del kept, cache
    short = tokens[:, :LONG_SHORT]
    runs = {}
    for lc in (True, False):
        logits, cache, T = bb.prefill(cfg, params, {"tokens": short}, long_context=lc)
        first, toks = logits, []
        for i in range(LONG_SHORT_NEW):
            tok = torch.argmax(logits, -1)
            toks.append(int(tok))
            logits, cache = bb.decode_step(cfg, params, tok[:, None], cache, T + i)
        runs[lc] = (first, toks)
    check(runs[True][1] == runs[False][1], f"phase 15e: a {LONG_SHORT}-token prompt "
          f"decodes {runs[True][1]} with long_context, {runs[False][1]} without")
    short_diff = (runs[True][0] - runs[False][0]).abs().max().item()
    out = {"prompt": LONG_PROMPT, "window": W, "prefill_s": prefill_s,
           "prefill_tokens_per_s": LONG_PROMPT / prefill_s, "prefill_peak_bytes": peak,
           "decode_step_s": host,
           "decode_step_ms_median": statistics.median(host) * 1e3, "launches": launches,
           "kernel_errs": errs, "greedy_tokens": seq, "short_prompt": LONG_SHORT,
           "short_logit_max_abs_diff": short_diff}
    print(f"phase 15e: {cfg.name} long_context: prefill of {LONG_PROMPT} tokens at B = 1, "
          f"window {W}, in {prefill_s:.3f} s ({out['prefill_tokens_per_s']:.0f} tokens/s), "
          f"peak {peak / 2**30:.2f} GiB, a ring of {W} slots; {LONG_DECODE} decode steps past the wrap, median "
          f"{out['decode_step_ms_median']:.2f} ms host; launches "
          f"{ {n: c for n, c in launches.items() if c} } (exact); a {LONG_SHORT}-token "
          f"prompt gives the same {LONG_SHORT_NEW} greedy tokens with long_context and "
          f"without (prefill logits |diff| {short_diff:.3e})  [{card}]")
    return launches, out


def phase_slice11(llm_cfg, llm_params, card) -> tuple:
    """Phase 15: (a)-(e); returns (launches on the paths by kernel, the
    largest kernel error by kernel, numbers)."""
    t_phase = time.perf_counter()
    parts = {}
    with fp32_math():
        t0 = time.perf_counter()
        kernels = slice11_kernels(card)
        parts["a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        vlm_launches, vlm = vlm_run(card)
        parts["b-c"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        asr_launches, asr = asr_run(card)
        parts["d"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        long_launches, long = long_context_run(llm_cfg, llm_params, card)
        parts["e"] = time.perf_counter() - t0
    launches = {n: vlm_launches[n] + asr_launches[n] + long_launches[n] for n in vlm_launches}
    errs = dict(kernels["errs"])
    for kept in (vlm["serve"]["kernel_errs"], asr["serve"]["kernel_errs"],
                 long["kernel_errs"]):
        for n, e in kept.items():
            errs[n] = max(errs.get(n, 0.0), e)
    numbers = {"kernels": kernels, "vlm": vlm, "asr": asr, "long_context": long,
               "launches": launches, "part_s": parts,
               "phase_s": time.perf_counter() - t_phase}
    print(f"phase 15: {numbers['phase_s']:.1f} s, by part "
          f"{ {k: round(v, 1) for k, v in parts.items()} }; launches on its paths "
          f"{ {n: c for n, c in launches.items() if c} }")
    return launches, errs, numbers


# ------------------------------------------------------------ slice 12 ---
def bf16_bound(nbytes: int, ops: int) -> tuple[float, str]:
    """The least time of a bf16 kernel: its bytes over HBM's rate, its
    operations over the bf16 tensor-core rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def widened(args):
    return [a.float() if isinstance(a, torch.Tensor) and a.is_floating_point() else a
            for a in args]


def bf16_bitwise(kernel, args, kw, what: str):
    """``kernel`` on bf16 ``args`` against the same wrapper on the args
    widened to float32 (the fp32 kernel), rounded to bf16: bit for bit.
    Returns the bf16 output."""
    got = kernel(*args, **kw)
    wide = kernel(*widened(args), **kw)
    check(got.dtype == torch.bfloat16 and torch.equal(got, wide.to(torch.bfloat16)),
          f"{what}: the bf16 kernel is not bitwise the fp32 kernel on the widened "
          f"inputs, rounded (max |diff| "
          f"{(got.float() - wide.to(torch.bfloat16).float()).abs().max().item()})")
    return got


def sdpa_bf16(q, k, v, live, plain_causal: bool):
    """SDPA in q's dtype on the same inputs (heads first, kv heads
    expanded): ``is_causal`` where the mask is plain causal, else the live
    mask; (B, T, Hq, D).  A row with no live key comes back NaN."""
    G = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt, vt = (t.repeat_interleave(G, 2).transpose(1, 2) for t in (k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = (sdpa(qt, kt, vt, is_causal=True) if plain_causal
           else sdpa(qt, kt, vt, attn_mask=live[:, None]))
    return out.transpose(1, 2)


def rmsnorm64(x, scale, eps: float = 1e-6):
    x64 = x.double()
    return x64 * torch.rsqrt((x64 * x64).mean(-1, keepdim=True) + eps) * scale.double()


def bf16_bars(name: str, kernel, args, kw, what: str) -> dict:
    """The bars of the bf16 flash attention and RMSNorm (slice 13: their own
    kernels, not the fp32 arithmetic): within BF16_TOL of the plain
    version; a max |error| against float64 on the widened inputs at most
    BF16_LIB_FACTOR x the library call's in bf16 on the same inputs (SDPA,
    ``F.rms_norm``; rows with a live key); two calls bitwise equal; a row
    with no live key exactly 0.  Returns the errors."""
    got = kernel(*args, **kw)
    check(torch.equal(got, kernel(*args, **kw)), f"{what}: two calls differ")
    check(got.dtype == torch.bfloat16, f"{what}: {got.dtype} out")
    if name == "flash_attention":
        q, k, v = args
        opts = {"causal": kw.get("causal", True), "window": kw.get("window", 0),
                "q_offset": kw.get("q_offset", 0), "kv_valid_len": kw.get("kv_valid_len")}
        plain = flash_attention_ref(q, k, v, **opts)
        exact, live = attention64(q, k, v, **opts)
        plain_causal = (opts["causal"] and not opts["window"] and not opts["q_offset"]
                        and opts["kv_valid_len"] is None and q.shape[1] == k.shape[1])
        lib = sdpa_bf16(q, k, v, live, plain_causal)
        rows = live.any(-1)                              # (B, T)
        check(not got[~rows].any(), f"{what}: a row with no live key is not 0")
        got_e, lib_e, exact_e = got[rows], lib[rows], exact[rows]
    else:
        x, scale = args
        eps = kw.get("eps", 1e-6)
        plain = rmsnorm_ref(x, scale, eps=eps)
        exact_e = rmsnorm64(x, scale, eps)
        got_e, lib_e = got, torch.nn.functional.rms_norm(x, x.shape[-1:], scale, eps)
    err = close_err(got, plain, BF16_TOL[name], what)
    e64 = (got_e.double() - exact_e).abs().max().item() if got_e.numel() else 0.0
    lib64 = (lib_e.double() - exact_e).abs().max().item() if lib_e.numel() else 0.0
    check(e64 <= BF16_LIB_FACTOR * lib64,
          f"{what}: {e64} from float64, the library call in bf16 {lib64}")
    return {"max_abs_err": err, "err_float64": e64, "library_err_float64": lib64}


def flash_sweep(gen) -> list:
    """Phase 16a: the bf16 flash kernel's contract on the card against the
    plain version (bf16_bars), with its log-sum-exp within
    BF16_LSE_TOL of the plain version's and -inf on every row with no
    live key: D 64 and 128, G 1 and 7, a window, q_offset with T != S,
    kv_valid_len with a row at 0, T and S off the 64-row tile, not
    causal."""
    cases = [  # (B, T, S, Hq, Hkv, D, causal, window, q_offset, kv_valid_len)
        (2, 100, 100, 14, 2, 64, True, 0, 0, None),
        (2, 100, 100, 14, 2, 128, True, 32, 0, None),
        (2, 100, 100, 16, 16, 128, True, 32, 0, None),
        (2, 37, 137, 14, 2, 128, True, 0, 100, None),
        (2, 200, 264, 16, 16, 128, True, 0, 64, None),
        (3, 77, 77, 8, 8, 128, True, 0, 0, [77, 0, 40]),
        (3, 130, 190, 14, 2, 64, False, 32, 60, [190, 100, 0]),
        (2, 50, 200, 4, 1, 64, False, 0, 0, None),
        (3, 40, 40, 16, 16, 128, False, 0, 0, [0, 40, 9]),
        (2, 1, 300, 14, 2, 128, True, 0, 299, None),
        (1, 10, 20, 4, 2, 64, True, 4, 50, None),       # no live key: 0
    ]
    out = []
    for B, T, S, Hq, Hkv, D, causal, window, q_off, valid in cases:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for shape in ((B, T, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
        kw = {"causal": causal, "window": window, "q_offset": q_off,
              "kv_valid_len": None if valid is None else torch.tensor(valid, device="cuda")}
        what = f"phase 16a: flash_attention bf16 at {(B, T, S, Hq, Hkv, D)} {kw}"
        bars = bf16_bars("flash_attention", flash_attention_cuda, (q, k, v), kw, what)
        o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
        _, plain_lse = flash_attention_ref(q, k, v, return_lse=True, **kw)
        check(torch.equal(o, flash_attention_cuda(q, k, v, **kw)),
              f"{what}: the output changes with return_lse")
        dead = torch.isinf(plain_lse)
        check(torch.equal(torch.isinf(lse), dead) and bool((lse[dead] < 0).all()),
              f"{what}: lse is not -inf exactly on the rows with no live key")
        lse_err = (lse[~dead] - plain_lse[~dead]).abs().max().item() if (~dead).any() else 0.0
        check(lse_err <= BF16_LSE_TOL, f"{what}: lse {lse_err} from the plain version's")
        out.append({"case": [B, T, S, Hq, Hkv, D, causal, window, q_off, valid],
                    "lse_err": lse_err, **bars})
    return out


def bf16_row(name, kern, args, plain, library, nbytes, ops, what, tag: str,
             extra=None) -> dict:
    """One of the bf16 kernels at one shape (phase 16a's checks; ``what``
    names the shape, ``tag`` the phase): decode attention bitwise its fp32 kernel on the widened
    inputs (rounded) and within BF16_TOL of its plain version, flash and
    RMSNorm to ``bf16_bars``; its time by CUDA events beside the fp32
    kernel's on the widened inputs, the plain version's, the library
    call's and its bf16 bound."""
    if name == "decode_attention":
        got = bf16_bitwise(kern, args, {}, f"{tag}: {what}")
        bars = {"bitwise_fp32": True,
                "max_abs_err": close_err(got, plain(), BF16_TOL[name], f"{tag}: {what}")}
    else:
        bars = bf16_bars(name, kern, args, {}, f"{tag}: {what}")
    bound_ms, bound_by = bf16_bound(nbytes, ops)
    wide = widened(args)
    return {"shape": what, **bars,
            "ms": time_ms(lambda: kern(*args)), "fp32_ms": time_ms(lambda: kern(*wide)),
            "plain_ms": time_ms(plain, reps=10), "library_ms": time_ms(library),
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "ops": ops,
            **(extra or {})}


def print_bf16_rows(out: dict, tag: str, card) -> None:
    for name, cases in out.items():
        for c in cases:
            held = ("bitwise the fp32 kernel on the widened inputs" if c.get("bitwise_fp32")
                    else f"|err| vs float64 {c['err_float64']:.3e} (library "
                         f"{c['library_err_float64']:.3e}, bar x{BF16_LIB_FACTOR}), "
                         f"two calls bitwise")
            extra = ""
            if "tc_3xtf32_bound_ms" in c:
                extra = (f", 3xTF32 bound {c['tc_3xtf32_bound_ms']:.4f}; "
                         f"{c['bound_ms'] / c['ms']:.0%} of the bound, "
                         f"{c['fp32_ms'] / c['ms']:.2f}x faster than the fp32 kernel, "
                         f"{c['library_ms'] / c['ms']:.2f}x SDPA's speed"
                         + (f"; torch.addcmul(q, k, v) {c['bytes_ms']:.4f}"
                            if c.get("bytes_ms") is not None else ""))
            print(f"{tag}: {name} bf16 at {c['shape']}: {held}; |err| vs plain "
                  f"{c['max_abs_err']:.3e} (bar {BF16_TOL[name]}); {c['ms']:.4f} ms "
                  f"(fp32 kernel {c['fp32_ms']:.4f}), plain {c['plain_ms']:.4f}, library "
                  f"{c['library_ms']:.4f}, bound {c['bound_ms']:.4f} ({c['bound_by']})"
                  + extra + f"  [{card}]")


def bf16_kernel_rows(B, T, S, H, Hkv, D, d, prompts, tag: str, gen, card) -> dict:
    """The three bf16 kernels at a served model's shapes (``bf16_row`` for
    each, printed): flash at each (batch, prompt) of ``prompts``, q (B, T,
    H, D), k/v (B, T, Hkv, D), causal, beside SDPA with the kv heads
    expanded (and, where H == Hkv, ``torch.addcmul(q, k, v)``, one call
    that moves the same bytes); decode attention on the S-slot cache at
    the first and last decode step's depth, T + 1 and S - 1; RMSNorm on
    the prefill's B * T rows and a decode step's B, width d, beside
    ``F.rms_norm``."""
    G = H // Hkv
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    def heads_first(t, rep=1):
        return t.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()

    out = {"flash_attention": [], "decode_attention": [], "rmsnorm": []}
    for Bf, Tf in prompts:
        q, k, v = randn(Bf, Tf, H, D), randn(Bf, Tf, Hkv, D), randn(Bf, Tf, Hkv, D)
        qt, kt, vt = heads_first(q), heads_first(k, G), heads_first(v, G)
        pairs = Bf * H * Tf * (Tf + 1) // 2
        out["flash_attention"].append(bf16_row(
            "flash_attention", flash_attention_cuda, (q, k, v),
            lambda: flash_attention_ref(q, k, v), lambda: sdpa(qt, kt, vt, is_causal=True),
            (2 * Bf * Tf * H * D + 2 * Bf * Tf * Hkv * D) * 2, 4 * D * pairs,
            f"q {(Bf, Tf, H, D)}, k/v {(Bf, Tf, Hkv, D)}, causal", tag,
            {"tc_3xtf32_bound_ms": 3 * 4 * D * pairs / TF32_OPS_PER_S * 1e3,
             "bytes_ms": time_ms(lambda: torch.addcmul(q, k, v)) if G == 1 else None}))
        del q, k, v, qt, kt, vt
    for n in (T + 1, S - 1):
        q, kc, vc = randn(B, 1, H, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D)
        qt, kt, vt = heads_first(q), heads_first(kc, G), heads_first(vc, G)
        live = (torch.arange(S, device="cuda") < n).view(1, 1, 1, S)
        out["decode_attention"].append(bf16_row(
            "decode_attention", decode_attention_cuda, (q, kc, vc, n),
            lambda: decode_attention_ref(q, kc, vc, n),
            lambda: sdpa(qt, kt, vt, attn_mask=live),
            (2 * B * H * D + 2 * B * n * Hkv * D) * 2, 4 * B * H * n * D,
            f"q {(B, 1, H, D)}, cache {(B, S, Hkv, D)}, attend {n}", tag))
        del q, kc, vc, qt, kt, vt
    for rows in (B * T, B):
        x = randn(rows, d)
        scale = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(torch.bfloat16)
        out["rmsnorm"].append(bf16_row(
            "rmsnorm", rmsnorm_cuda, (x, scale), lambda: rmsnorm_ref(x, scale),
            lambda: torch.nn.functional.rms_norm(x, (d,), scale, 1e-6),
            (2 * rows * d + d) * 2, 4 * rows * d, f"({rows}, {d})", tag))
    torch.cuda.synchronize()
    print_bf16_rows(out, tag, card)
    return out


def moe_kernels(cfg, card) -> dict:
    """Phase 16a: the three bf16 kernels at moonshot-v1-16b-a3b's serving
    shapes (``bf16_kernel_rows``: flash at the prefill's q = k/v (8, 256,
    16, 128) and a 4,096-token prompt's (1, 4096, 16, 128); decode
    attention on the 288-slot cache; RMSNorm at d = 2,048).  Decode
    attention is bitwise the fp32 kernel on the widened inputs (rounded);
    flash and RMSNorm, kernels of their own since slice 13, are held to
    ``bf16_bars``; each within BF16_TOL of its plain version.  Then
    flash's contract sweep (``flash_sweep``) and RMSNorm at N in {1, 8,
    2048, 4097} x d in {896, 2048, 8192}, a d off 8 and a view off 16
    bytes, each held to ``bf16_bars``."""
    B, T = MOE_BATCH, MOE_PROMPT
    gen = torch.Generator(device="cuda").manual_seed(160)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    out = bf16_kernel_rows(B, T, MOE_MAX_LEN, cfg.n_heads, cfg.n_kv_heads,
                           cfg.resolved_head_dim, cfg.d_model, ((B, T), MOE_LONG_PROMPT),
                           "phase 16a", gen, card)
    out["flash_sweep"] = flash_sweep(gen)
    print(f"phase 16a: flash_attention bf16 contract sweep, {len(out['flash_sweep'])} cases: "
          f"max |err| vs plain {max(c['max_abs_err'] for c in out['flash_sweep']):.3e}, "
          f"lse {max(c['lse_err'] for c in out['flash_sweep']):.2e} (bar {BF16_LSE_TOL}); "
          f"float64 error / SDPA's at most "
          f"{max(c['err_float64'] / max(c['library_err_float64'], 1e-30) for c in out['flash_sweep']):.2f}")
    sweep = []
    for N, dd in [(N, dd) for N in (1, 8, 2048, 4097) for dd in (896, 2048, 8192)] + [
            (37, 900), (9, "view")]:
        if dd == "view":   # a view 2 bytes off 16: the element-by-element walk
            dd = 896
            x = randn(N * dd + 1)[1:].view(N, dd)
        else:
            x = randn(N, dd) * 2
        scale = (1 + 0.1 * torch.randn(dd, generator=gen, device="cuda")).to(torch.bfloat16)
        sweep.append({"shape": [N, dd], **bf16_bars(
            "rmsnorm", rmsnorm_cuda, (x, scale), {},
            f"phase 16a: rmsnorm bf16 at ({N}, {dd})")})
    out["rmsnorm_sweep"] = sweep
    print(f"phase 16a: rmsnorm bf16 at {len(sweep)} shapes: max |err| vs plain "
          f"{max(c['max_abs_err'] for c in sweep):.3e} (bar {BF16_TOL['rmsnorm']}); "
          f"float64 error / F.rms_norm's at most "
          f"{max(c['err_float64'] / max(c['library_err_float64'], 1e-30) for c in sweep):.2f}")
    return out


def inference_capacity(cfg, n_tokens: int) -> int:
    """Slots an expert takes from a group of ``n_tokens`` at the inference
    capacity factor (``models/backbone.py::_apply_ffn(dropless=True)``)."""
    m = cfg.moe
    cf = m.n_experts / m.top_k if m.n_experts <= 8 else min(4.0, m.n_experts / m.top_k)
    S = _pick_group_size(n_tokens, 4096)
    return min(max(4, int(cf * S * m.top_k / m.n_experts)), S)


def moe_serve(card) -> dict:
    """Phase 16b: moonshot-v1-16b-a3b at full width and depth in bf16,
    drawn on the card, through ``ServeEngine.generate`` (launch counts from
    0, exact); its weights, peak, tokens/s and dropped fractions; a second
    generate's picked kernel calls replayed against the plain versions,
    decode attention's also bitwise against its fp32 kernel, flash's and
    RMSNorm's also to ``bf16_bars``; the prefill alone, each decode step's
    host time and, by torch.profiler, its kernels' device time."""
    cfg = get_config(MOE_ARCH)
    L = cfg.n_layers
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = bb.init_params(cfg, seed=0, gen_device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree_leaves(params)
    check(all(t.dtype == torch.bfloat16 and t.device.type == "cuda" for t in leaves),
          "phase 16b: a parameter is not bf16 on the card")
    n_params = param_count(params)
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves)
    rng = np.random.RandomState(161)
    reqs = [Request(tokens=rng.randint(0, cfg.vocab, MOE_PROMPT), max_new_tokens=MOE_NEW)
            for _ in range(MOE_BATCH)]
    eng = ServeEngine(cfg, params, max_len=MOE_MAX_LEN)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = slice11_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = outs[0].steps
    check(steps == MOE_NEW, f"phase 16b: {steps} steps for {MOE_NEW} tokens")
    check_launches(launches, {"flash_attention_bf16": L,
                              "decode_attention_bf16": L * (steps - 1),
                              "rmsnorm_bf16": (2 * L + 1) * steps}, "phase 16b")
    for c in outs:
        check(len(c.tokens) == MOE_NEW and c.tokens.min() >= 0
              and c.tokens.max() < cfg.vocab, f"phase 16b: a completion {c.tokens}")
    aux = eng.moe_aux
    dropped = {"prefill": float(aux["prefill"]["dropped_fraction"]),
               "decode": [float(a["dropped_fraction"]) for a in aux["decode"]]}
    lb = {"prefill": float(aux["prefill"]["load_balance_loss"]),
          "decode": [float(a["load_balance_loss"]) for a in aux["decode"]]}
    check(len(dropped["decode"]) == steps - 1
          and all(0.0 <= f < 1.0 for f in [dropped["prefill"], *dropped["decode"]]),
          f"phase 16b: dropped fractions {dropped}")
    tokens = [c.tokens.tolist() for c in outs]

    kept, restore = capture_kernel_calls(cfg)
    try:
        again = eng.generate(reqs)
    finally:
        restore()
    check([c.tokens.tolist() for c in again] == tokens,
          "phase 16b: a second greedy generate gave other tokens")
    kernel_errs = replay_kernel_calls(kept, "phase 16b", tol=BF16_TOL)
    for name, calls in kept.items():
        mod, attr, _ = PATH_KERNELS[name]
        for a, kw in calls:
            if name == "decode_attention":
                bf16_bitwise(getattr(mod, attr), a, kw, f"phase 16b: {name} replayed")
            else:
                bf16_bars(name, getattr(mod, attr), a, kw, f"phase 16b: {name} replayed")
    n_kept = {n: len(c) for n, c in kept.items()}
    del kept

    batch = {"tokens": torch.as_tensor(np.stack([r.tokens for r in reqs]), device="cuda")}
    prefill_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache, T = bb.prefill(cfg, params, batch, max_len=MOE_MAX_LEN)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
    host = []
    for i in range(MOE_NEW - 1):
        tok = torch.argmax(logits, -1)[:, None]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = bb.decode_step(cfg, params, tok, cache, T + i)
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
    from torch.profiler import ProfilerActivity, profile
    logits, cache, T = bb.prefill(cfg, params, batch, max_len=MOE_MAX_LEN)
    tok = torch.argmax(logits, -1)[:, None]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(MOE_PROFILE_STEPS):
            logits, cache = bb.decode_step(cfg, params, tok, cache, T + i)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    kernels = profiled_kernels(prof)
    device_us = sum(us for us, _ in kernels.values()) / MOE_PROFILE_STEPS
    n_kernels = sum(n for _, n in kernels.values()) / MOE_PROFILE_STEPS
    top = sorted(((us / MOE_PROFILE_STEPS / 1e3, k[:48]) for k, (us, _) in kernels.items()),
                 reverse=True)[:6]
    out = {"arch": MOE_ARCH, "params": n_params, "weight_bytes": weight_bytes,
           "init_s": init_s, "requests": MOE_BATCH, "prompt": MOE_PROMPT,
           "new_tokens": MOE_NEW, "generate_s": wall,
           "tokens_per_s": MOE_BATCH * MOE_NEW / wall, "peak_bytes": peak,
           "launches": launches, "dropped_fraction": dropped, "load_balance_loss": lb,
           "kernel_errs": kernel_errs, "replayed_calls": n_kept,
           "prefill_s": statistics.median(prefill_s), "prefill_s_all": prefill_s,
           "decode_step_host_ms": [h * 1e3 for h in host],
           "decode_step_host_ms_median": statistics.median(host) * 1e3,
           "decode_step_device_ms": device_us / 1e3,
           "decode_step_kernels": n_kernels,
           "profiled_steps_host_ms": prof_s * 1e3 / MOE_PROFILE_STEPS,
           "decode_top_kernels_ms": top, "greedy_tokens_row0": tokens[0]}
    print(f"phase 16b: {MOE_ARCH} at full width and depth ({L} layers, {n_params / 1e9:.2f} B "
          f"params, {weight_bytes / 2**30:.2f} GiB of bf16 weights, drawn on the card in "
          f"{init_s:.1f} s): ServeEngine(max_len={MOE_MAX_LEN}).generate of {MOE_BATCH} x "
          f"{MOE_PROMPT}-token prompts, {MOE_NEW} greedy tokens each, in {wall:.3f} s "
          f"({out['tokens_per_s']:.1f} tokens/s); peak {peak / 2**30:.2f} GiB; launches "
          f"{ {n: c for n, c in launches.items() if c} } (exact)  [{card}]")
    print(f"phase 16b: prefill alone {out['prefill_s'] * 1e3:.1f} ms (host, median of 3: "
          f"{[round(x * 1e3, 1) for x in prefill_s]}); decode steps on the host "
          f"{[round(h * 1e3, 2) for h in host]} ms (median "
          f"{out['decode_step_host_ms_median']:.2f}); a decode step's kernels "
          f"{out['decode_step_device_ms']:.2f} ms of device time in {n_kernels:.0f} "
          f"launches (torch.profiler over {MOE_PROFILE_STEPS} steps, "
          f"{out['profiled_steps_host_ms']:.2f} ms a step on the host there); top "
          f"kernels (ms a step) {top}  [{card}]")
    print(f"phase 16b: dropped_fraction: prefill {dropped['prefill']:.4f} "
          f"({inference_capacity(cfg, MOE_BATCH * MOE_PROMPT)} slots an expert), decode "
          f"steps {[round(f, 4) for f in dropped['decode']]} "
          f"({inference_capacity(cfg, MOE_BATCH)} slots an expert); load_balance_loss "
          f"prefill {lb['prefill']:.4f}  [{card}]")
    del params, eng, logits, cache, outs, again
    torch.cuda.empty_cache()
    return out


def moe_vs_cpu(card) -> dict:
    """Phase 16c: reduced moonshot (shared expert), mixtral (sliding
    window, cut to MOE_CPU_WINDOW) and arctic (dense residual) in fp32,
    seed-0 weights, the card against the port's CPU: prefill logits and
    MOE_CPU_DECODE decode steps teacher-forced on the CPU's greedy tokens,
    within MOE_CPU_TOL; the dropped fractions of both."""
    out = {}
    for name in MOE_REDUCED:
        cfg = get_config(name).reduced()
        if cfg.sliding_window:
            cfg = dataclasses.replace(cfg, sliding_window=MOE_CPU_WINDOW)
        cpu = bb.init_params(cfg, seed=0, device="cpu")
        params = tree_to(cpu, "cuda")
        toks = np.random.RandomState(162).randint(0, cfg.vocab, (MOE_CPU_B, MOE_CPU_T))
        max_len = MOE_CPU_T + MOE_CPU_DECODE + 4
        runs = {}
        for where, p in (("card", params), ("cpu", cpu)):
            aux = [{}]
            batch = {"tokens": torch.as_tensor(toks, device=p["embed"]["table"].device)}
            logits, cache, T = bb.prefill(cfg, p, batch, max_len=max_len, aux=aux[0])
            runs[where] = ([logits.cpu()], aux, cache)
        ref_seq, diffs = runs["cpu"][0], []
        for i in range(MOE_CPU_DECODE):
            tok = torch.argmax(ref_seq[-1], -1)[:, None]
            for where, p in (("card", params), ("cpu", cpu)):
                seq, aux, cache = runs[where]
                aux.append({})
                logits, cache = bb.decode_step(cfg, p, tok.to(cache["k"].device), cache,
                                               T + i, aux=aux[-1])
                seq.append(logits.cpu())
                runs[where] = (seq, aux, cache)
        for i, (a, b) in enumerate(zip(runs["card"][0], runs["cpu"][0])):
            diffs.append((a - b).abs().max().item())
            check(torch.allclose(a, b, atol=MOE_CPU_TOL, rtol=MOE_CPU_TOL),
                  f"phase 16c: {name} {'prefill' if i == 0 else f'decode step {i}'} "
                  f"logits differ from the CPU run by {diffs[-1]}")
        drops = {w: [float(a["dropped_fraction"]) for a in runs[w][1]] for w in runs}
        out[name] = {"window": cfg.sliding_window, "max_abs_diff": diffs, "dropped": drops}
        print(f"phase 16c: {cfg.name} (window {cfg.sliding_window}), fp32: prefill of "
              f"{MOE_CPU_B} x {MOE_CPU_T} and {MOE_CPU_DECODE} decode steps, logits |card - "
              f"CPU| {[f'{x:.2e}' for x in diffs]} (bar {MOE_CPU_TOL} abs + rel); dropped "
              f"fractions card {drops['card']}, CPU {drops['cpu']}  [{card}]")
        del params
    torch.cuda.empty_cache()
    return out


def moe_alone(card) -> dict:
    """Phase 16 (a)-(c) in a fresh child process of this script, which
    prints its lines and writes its numbers to a JSON file (``phase_moe``)."""
    t0 = time.perf_counter()
    cfg = get_config(MOE_ARCH)
    kernels = moe_kernels(cfg, card)
    t_a = time.perf_counter() - t0
    serve = moe_serve(card)
    t_b = time.perf_counter() - t0 - t_a
    vs_cpu = moe_vs_cpu(card)
    return {"kernels": kernels, "serve": serve, "vs_cpu": vs_cpu,
            "part_s": {"a": t_a, "b": t_b, "c": time.perf_counter() - t0 - t_a - t_b}}


def phase_moe(card) -> tuple:
    """Phase 16: ``moe_alone`` in a fresh child process (the 53.8 GiB model
    wants an allocator that the earlier phases never touched); returns the
    three bf16 kernels' rows of the kernels line and the numbers."""
    sys.stdout.flush()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "moe_alone.json")
        subprocess.run([sys.executable, os.path.abspath(__file__), "--moe-alone", path],
                       check=True, timeout=MOE_ALONE_TIMEOUT_S)
        with open(path) as f:
            moe = json.load(f)
    moe["phase_s"] = time.perf_counter() - t0
    sources = {"flash_attention": ("src/repro_torch/csrc/flash_attention_bf16.cu",
                                   "src/repro/kernels/attention/kernel.py:78"),
               "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                                    "src/repro/kernels/decode_attention/kernel.py:79"),
               "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                           "src/repro/kernels/rmsnorm/kernel.py:25")}
    rows = []
    for name, (src, replaces) in sources.items():
        cases = moe["kernels"][name]
        main = cases[-1] if name == "decode_attention" else cases[0]
        sweep = moe["kernels"].get(f"{name.split('_')[0]}_sweep", [])
        err = max([c["max_abs_err"] for c in cases + sweep]
                  + [moe["serve"]["kernel_errs"].get(name, 0.0)])
        rows.append({"name": f"{name}_bf16", "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": moe["serve"]["launches"][f"{name}_bf16"],
                     "max_abs_err": err, "ms": main["ms"], "plain_ms": main["plain_ms"],
                     "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                     "library_ms": main["library_ms"]})
    print(f"phase 16: {moe['phase_s']:.1f} s in a child process, by part "
          f"{ {k: round(v, 1) for k, v in moe['part_s'].items()} }")
    return rows, moe


# ------------------------------------------------------------ slice 14 ---
def sdpa_graph_bf16(q, k, v, live, plain_causal: bool):
    """SDPA on bf16 q, k, v (heads first, kv heads expanded) under a
    gradient: ``is_causal`` where the mask is plain causal, else the live
    mask, a row with no live key given key 0 (its dO is zeroed, so it adds
    nothing to any gradient).  Returns the output, the inputs that take
    the gradient and a function of dO (B, T, Hq, D) that returns (dq, dk,
    dv) in the kernels' layout, the expanded heads' dk / dv summed in
    float32 and rounded to bf16 once."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dead = ~live.any(-1)
    ins = (q.transpose(1, 2).contiguous().requires_grad_(),
           k.repeat_interleave(G, 2).transpose(1, 2).contiguous().requires_grad_(),
           v.repeat_interleave(G, 2).transpose(1, 2).contiguous().requires_grad_())
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if plain_causal:
        out = sdpa(*ins, is_causal=True)
    else:
        mask = live.clone()
        mask[..., 0] |= dead
        out = sdpa(*ins, attn_mask=mask[:, None])

    def grads(do):
        dot = do.masked_fill(dead[..., None, None], 0).transpose(1, 2).contiguous()
        dq, dk, dv = torch.autograd.grad(out, ins, dot, retain_graph=True)

        def kv(t):
            return t.transpose(1, 2).float().reshape(B, S, Hkv, G, D).sum(3).to(t.dtype)

        return dq.transpose(1, 2), kv(dk), kv(dv)

    return out, ins, grads


def flash_backward_bf16_bars(q, k, v, do, kw, what: str) -> dict:
    """The bf16 flash backward's bars (phase 17a): dq, dk and dv each
    within BF16_TOL of the plain version's largest |value| (autograd of
    the fp32-inside forward on the bf16 inputs); against float64 autograd
    of dense attention, each at most BF16_LIB_FACTOR x SDPA's bf16
    backward's error on the same inputs; two calls bitwise; a row with no
    live key dq = 0 and a key no row sees dk = dv = 0, exactly."""
    o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    got = flash_attention_backward_cuda(q, k, v, o, do, lse, **kw)
    again = flash_attention_backward_cuda(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)), f"{what}: two calls differ")
    check(all(g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all()) for g in got),
          f"{what}: gradients not finite bf16")
    B, T, Hq, D = q.shape
    S = k.shape[1]
    valid = kw.get("kv_valid_len")
    live = live_mask(B, T, S, causal=kw["causal"], window=kw["window"],
                     q_offset=kw["q_offset"], kv_valid_len=valid)
    rows, seen = live.any(-1), live.any(1)                  # (B, T), (B, S)
    check(not got[0][~rows].any() and not got[1][~seen].any() and not got[2][~seen].any(),
          f"{what}: a row with no live key or a key no row sees has a nonzero gradient")
    plain = flash_attention_backward_ref(q, k, v, o, do, lse, **kw)
    exact, _ = exact_attention_grads(q, k, v, do, causal=kw["causal"], window=kw["window"],
                                     q_offset=kw["q_offset"],
                                     kv_valid_len=None if valid is None else valid.tolist())
    plain_causal = (kw["causal"] and not kw["window"] and not kw["q_offset"]
                    and valid is None and T == S)
    _, _, sdpa_grads = sdpa_graph_bf16(q, k, v, live, plain_causal)
    lib = sdpa_grads(do)
    out = {}
    for name, g, pl, ex, lb in zip(("dq", "dk", "dv"), got, plain, exact, lib):
        scale = pl.float().abs().max().item()
        err = (g.double() - pl.double()).abs().max().item()
        check(err <= BF16_TOL["flash_attention"] * scale,
              f"{what}: {name} {err:.3e} from the plain version, over "
              f"{BF16_TOL['flash_attention']} of its scale {scale:.3e}")
        e64 = (g.double() - ex).abs().max().item()
        lib64 = (lb.double() - ex).abs().max().item()
        check(e64 <= BF16_LIB_FACTOR * lib64, f"{what}: {name} {e64:.3e} from float64, "
              f"SDPA's bf16 backward {lib64:.3e}")
        out[name] = {"max_abs_err": err, "scale": scale, "err_float64": e64,
                     "library_err_float64": lib64}
    del o, lse, got, again, plain, exact, lib
    return out


def flash_backward_bf16_work(B: int, T: int, S: int, Hq: int, Hkv: int, D: int,
                             pairs: int) -> tuple:
    """(bytes, operations) of the bf16 flash backward: q, o, dO, k, v read
    and dq, dk, dv written once at 2 bytes, the log-sum-exp read at 4;
    10 * D flops a live pair."""
    return ((4 * B * T * Hq * D + 4 * B * S * Hkv * D) * 2 + B * Hq * T * 4,
            10 * D * pairs)


def rms_split(fn) -> dict:
    """The RMSNorm backward's two kernels by torch.profiler: {"rows": us,
    "dscale": us} a call, L2 flushed before each call."""
    found = device_kernels(fn, reps=20, match="rmsnorm_", flush=True)
    out = {}
    for key, (us, n) in found.items():
        part = "dscale" if "rmsnorm_dscale_kernel" in key else "rows"
        out[part] = out.get(part, 0.0) + us
    return out


def moe_train_kernels(card) -> dict:
    """Phase 17a: the two bf16 backward kernels against their plain
    versions at moonshot-v1-16b-a3b's training microbatch (flash q = k/v
    (2, 4096, 16, 128), causal; RMSNorm (8192, 2048)) and over their
    contracts: flash by ``flash_backward_bf16_bars`` (MOE_TRAIN_FLASH_SWEEP
    too), RMSNorm bitwise the fp32 kernel on the widened inputs, rounded,
    two calls bitwise and within BF16_TOL of the plain version (N in {1, 8,
    4097} x d in {896, 2048, 8192} too).  Each timed by CUDA events beside
    the fp32 kernel on the widened inputs, the plain version, the library
    call's bf16 backward (SDPA ``is_causal``; ``F.rms_norm``) and the bound;
    the flash backward's three kernels by torch.profiler."""
    gen = torch.Generator(device="cuda").manual_seed(170)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    B, T, Hq, Hkv, D = MOE_TRAIN_FLASH
    q, k, v, do = randn(B, T, Hq, D), randn(B, T, Hkv, D), randn(B, T, Hkv, D), randn(B, T, Hq, D)
    kw = {"causal": True, "window": 0, "q_offset": 0, "kv_valid_len": None}
    what = f"phase 17a: flash_attention_backward bf16 at q = k/v {(B, T, Hq, D)}, causal"
    bars = flash_backward_bf16_bars(q, k, v, do, kw, what)
    o, lse = flash_attention_cuda(q, k, v, return_lse=True)
    wide = widened((q, k, v, o, do))
    o32, lse32 = flash_attention_cuda(*wide[:3], return_lse=True)
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    ol = flash_attention_ref(ql, kl, vl)
    live = live_mask(B, T, T, causal=True, window=0, q_offset=0)
    ot, ins_t, _ = sdpa_graph_bf16(q, k, v, live, True)
    dot = do.transpose(1, 2).contiguous()
    pairs = B * Hq * T * (T + 1) // 2
    nbytes, ops = flash_backward_bf16_work(B, T, T, Hq, Hkv, D, pairs)
    bound_ms, bound_by = bf16_bound(nbytes, ops)
    flash = {"shape": [B, T, T, Hq, Hkv, D], "bars": bars,
             "max_abs_err": max(b["max_abs_err"] for b in bars.values()),
             "ms": time_ms(lambda: flash_attention_backward_cuda(q, k, v, o, do, lse)),
             "fp32_ms": time_ms(lambda: flash_attention_backward_cuda(
                 wide[0], wide[1], wide[2], o32, wide[4], lse32), reps=10),
             "plain_ms": time_ms(lambda: torch.autograd.grad(ol, (ql, kl, vl), do,
                                                             retain_graph=True), reps=3),
             "library_ms": time_ms(lambda: torch.autograd.grad(ot, ins_t, dot,
                                                               retain_graph=True)),
             "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "ops": ops,
             "tc_bound_14d_ms": 14 * D * pairs / BF16_OPS_PER_S * 1e3}
    split = device_kernels(lambda: flash_attention_backward_cuda(q, k, v, o, do, lse), reps=5,
                           match="flash_bwd_", flush=True)
    flash["kernels_us"] = {key.split("flash_bwd_")[1].split("_kernel")[0]: us
                           for key, (us, n) in split.items()}
    own = flash_backward_bounds(B, T, Hq, D, elem=2, ops_per_s=BF16_OPS_PER_S)
    flash["kernels_bound_ms"] = own
    flash["kernels_share"] = {n: own["flash_bwd_" + n.split("_")[-1]] * 1e3 / us
                              for n, us in flash["kernels_us"].items()}
    del q, k, v, do, o, lse, wide, o32, lse32, ql, kl, vl, ol, ot, ins_t, dot
    torch.cuda.empty_cache()

    sweep = []
    for Bs, Ts, Ss, Hqs, Hkvs, Ds, causal, window, q_off, valid in MOE_TRAIN_FLASH_SWEEP:
        q, k, v = randn(Bs, Ts, Hqs, Ds), randn(Bs, Ss, Hkvs, Ds), randn(Bs, Ss, Hkvs, Ds)
        do = randn(Bs, Ts, Hqs, Ds)
        skw = {"causal": causal, "window": window, "q_offset": q_off,
               "kv_valid_len": None if valid is None else torch.tensor(valid, device="cuda")}
        sbars = flash_backward_bf16_bars(
            q, k, v, do, skw, f"phase 17a: flash_attention_backward bf16 at "
            f"{(Bs, Ts, Ss, Hqs, Hkvs, Ds)} causal={causal} window={window} "
            f"q_offset={q_off} kv_valid_len={valid}")
        sweep.append({"case": [Bs, Ts, Ss, Hqs, Hkvs, Ds, causal, window, q_off, valid],
                      **sbars})
        del q, k, v, do
    flash["sweep"] = sweep
    flash["max_abs_err"] = max([flash["max_abs_err"]] + [
        c[n]["max_abs_err"] for c in sweep for n in ("dq", "dk", "dv")])

    def rms_case(N, d):
        x, g = randn(N, d) * 2, randn(N, d)
        scale = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(torch.bfloat16)
        got = rmsnorm_backward_cuda(x, scale, g)
        again = rmsnorm_backward_cuda(x, scale, g)
        wide = rmsnorm_backward_cuda(x.float(), scale.float(), g.float())
        torch.cuda.synchronize()
        what = f"phase 17a: rmsnorm_backward bf16 at ({N}, {d})"
        check(all(torch.equal(a, b) for a, b in zip(got, again)), f"{what}: two calls differ")
        check(all(a.dtype == torch.bfloat16 and torch.equal(a, w.to(torch.bfloat16))
                  for a, w in zip(got, wide)),
              f"{what}: not bitwise the fp32 kernel on the widened inputs, rounded")
        err = 0.0
        for a, pl in zip(got, rmsnorm_backward_ref(x, scale, g)):
            scl = pl.float().abs().max().item()
            e = (a.double() - pl.double()).abs().max().item()
            check(e <= BF16_TOL["rmsnorm"] * scl, f"{what}: {e:.3e} from the plain "
                  f"version, over {BF16_TOL['rmsnorm']} of its scale {scl:.3e}")
            err = max(err, e)
        return (x, scale, g), err

    N, d = MOE_TRAIN_RMS
    (x, scale, g), err = rms_case(N, d)
    xr, sr = x.detach().requires_grad_(), scale.detach().requires_grad_()
    y_ref = rmsnorm_ref(xr, sr)
    y_lib = torch.nn.functional.rms_norm(xr, (d,), sr, 1e-6)
    wide = widened((x, scale, g))
    nbytes, ops = (3 * N * d + 2 * d) * 2, 6 * N * d
    bound_ms, bound_by = bf16_bound(nbytes, ops)
    rms = {"shape": [N, d], "bitwise_fp32": True, "max_abs_err": err,
           "ms": time_ms(lambda: rmsnorm_backward_cuda(x, scale, g)),
           "fp32_ms": time_ms(lambda: rmsnorm_backward_cuda(*wide)),
           "plain_ms": time_ms(lambda: torch.autograd.grad(y_ref, (xr, sr), g,
                                                           retain_graph=True), reps=10),
           "library_ms": time_ms(lambda: torch.autograd.grad(y_lib, (xr, sr), g,
                                                             retain_graph=True)),
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "ops": ops}
    rms["kernels_us"] = rms_split(lambda: rmsnorm_backward_cuda(x, scale, g))
    rms["share"] = bound_ms * 1e3 / sum(rms["kernels_us"].values())
    # the fp32 half at phase 14's rows, split the same way
    N32, d32 = LM_RMS_ROWS
    x32, g32 = torch.randn(N32, d32, generator=gen, device="cuda") * 2, torch.randn(
        N32, d32, generator=gen, device="cuda")
    s32 = 1 + 0.1 * torch.randn(d32, generator=gen, device="cuda")
    bound32 = bound((3 * N32 * d32 + 2 * d32) * 4, 6 * N32 * d32)[0]
    rms["fp32"] = {"shape": [N32, d32], "bound_ms": bound32,
                   "ms": time_ms(lambda: rmsnorm_backward_cuda(x32, s32, g32)),
                   "kernels_us": rms_split(lambda: rmsnorm_backward_cuda(x32, s32, g32))}
    rms["fp32"]["share"] = bound32 * 1e3 / sum(rms["fp32"]["kernels_us"].values())
    del x, scale, g, xr, sr, y_ref, y_lib, wide, x32, g32, s32
    rms_errs = [rms_case(Ns, ds)[1] for Ns, ds in MOE_TRAIN_RMS_SWEEP]
    rms["sweep_shapes"] = [list(c) for c in MOE_TRAIN_RMS_SWEEP]
    rms["max_abs_err"] = max([err] + rms_errs)
    torch.cuda.synchronize()
    ratios = {n: bars[n]["err_float64"] / max(bars[n]["library_err_float64"], 1e-30)
              for n in bars}
    worst_sweep = max(c[n]["err_float64"] / max(c[n]["library_err_float64"], 1e-30)
                      for c in sweep for n in ("dq", "dk", "dv"))
    rel = max(c[n]["max_abs_err"] / c[n]["scale"] for c in [bars] + sweep
              for n in ("dq", "dk", "dv"))
    print(f"phase 17a: flash_attention_backward bf16 at q = k/v {(B, T, Hq, D)}, causal: "
          f"|err| vs plain {flash['max_abs_err']:.3e}, at most {rel:.3e} of a gradient's "
          f"scale (bar {BF16_TOL['flash_attention']}); vs float64 / SDPA bf16 backward's "
          f"{ {n: round(r, 3) for n, r in ratios.items()} } (bar x{BF16_LIB_FACTOR}), "
          f"{len(sweep)} sweep cases at most {worst_sweep:.3f}; two calls bitwise; "
          f"{flash['ms']:.4f} ms (fp32 kernel on the widened inputs {flash['fp32_ms']:.4f}), "
          f"plain {flash['plain_ms']:.4f}, SDPA bf16 backward {flash['library_ms']:.4f}, "
          f"bound {flash['bound_ms']:.4f} ({flash['bound_by']}; 14 * D as issued "
          f"{flash['tc_bound_14d_ms']:.4f}); by torch.profiler (us a call) "
          f"{ {n: round(u, 1) for n, u in flash['kernels_us'].items()} }, each of its own "
          f"bound { {n: f'{r:.1%}' for n, r in flash['kernels_share'].items()} }  [{card}]")
    print(f"phase 17a: rmsnorm_backward bf16 at ({N}, {d}) and {len(MOE_TRAIN_RMS_SWEEP)} "
          f"more shapes: bitwise the fp32 kernel on the widened inputs, rounded; two calls "
          f"bitwise; |err| vs plain {rms['max_abs_err']:.3e}; {rms['ms']:.4f} ms (fp32 "
          f"kernel {rms['fp32_ms']:.4f}), plain {rms['plain_ms']:.4f}, F.rms_norm bf16 "
          f"backward {rms['library_ms']:.4f}, bound {rms['bound_ms']:.4f} "
          f"({rms['bound_by']}); by torch.profiler (us a call) {rms['kernels_us']}, "
          f"{rms['share']:.1%} of the bound; the fp32 half at {tuple(rms['fp32']['shape'])} "
          f"{rms['fp32']['ms']:.4f} ms, by torch.profiler {rms['fp32']['kernels_us']}, "
          f"{rms['fp32']['share']:.1%} of its {rms['fp32']['bound_ms']:.4f} ms bound  [{card}]")
    return {"flash_attention_backward": flash, "rmsnorm_backward": rms}


def moe_train_expected(L: int, steps: int) -> dict:
    """Launches of ``steps`` bf16 train steps of an L-layer model in two
    microbatches each, by ``lm_expected_launches`` with the bf16 kernels'
    names."""
    per = lm_expected_launches(L, 2 * steps)
    return {f"{n}_bf16": c for n, c in per.items()}


def moe_train(card) -> dict:
    """Phase 17b: moonshot-v1-16b-a3b at full width, its depth cut to
    MOE_TRAIN_LAYERS, bf16 weights drawn on the card from seed 0, through
    ``make_train_step`` at train_4k's T: MOE_TRAIN_STEPS steps on uniform
    tokens, step 1 run twice from the same state (bitwise the same loss,
    gradient and params), with every launch count set to 0 just before
    step 1 and read just after the last (exact); every gradient leaf
    finite (the first step's momentum is its gradient), the router's
    nonzero in every layer and every expert that took a slot nonzero; the
    dropped fraction at the training capacity; step s, tokens/s, the first
    step's peak (its inputs included), and one profiled step's busy share
    and device ms by kernel."""
    from torch.profiler import ProfilerActivity, profile

    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_TRAIN_LAYERS)
    L, m = cfg.n_layers, cfg.moe
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = bb.init_params(cfg, seed=0, gen_device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree_leaves(params)
    check(all(t.dtype == torch.bfloat16 and t.device.type == "cuda" for t in leaves),
          "phase 17b: a parameter is not bf16 on the card")
    n_params = param_count(params)
    shape = InputShape("train_4k", MOE_TRAIN_SEQ, MOE_TRAIN_BATCH, "train")
    n_micro = n_microbatches(cfg, shape)
    check(n_micro == 2, f"phase 17b: {n_micro} microbatches at d = {cfg.d_model}")
    step = make_train_step(cfg, shape)
    gen = torch.Generator(device="cuda").manual_seed(171)
    batches = [{k: torch.randint(0, cfg.vocab, (MOE_TRAIN_BATCH, MOE_TRAIN_SEQ),
                                 generator=gen, device="cuda") for k in ("tokens", "labels")}
               for _ in range(MOE_TRAIN_STEPS + 1)]
    opt0 = opt_init(params)
    capacity = min(max(4, int(m.capacity_factor * MOE_TRAIN_SEQ * m.top_k / m.n_experts)),
                   MOE_TRAIN_SEQ)

    # each MoE call of the first step: its dropped fraction, and the
    # experts that took a slot, by layer (the router weight's storage)
    routed, dropped = {}, []
    moe_apply = bb.moe_apply

    def traced(p, x, **kw):
        y, aux = moe_apply(p, x, **kw)
        with torch.no_grad():
            r = moe_routing(p, x, top_k=kw["top_k"], capacity_factor=kw["capacity_factor"])
            took = torch.bincount(r["expert"][r["keep"]], minlength=m.n_experts) > 0
            key = p["router"]["w"].data_ptr()
            routed[key] = routed.get(key, took) | took
            dropped.append(float(aux["dropped_fraction"]))
        return y, aux

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    bb.moe_apply = traced
    try:
        t0 = time.perf_counter()
        p, opt, m1 = step(params, opt0, batches[0])
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
    finally:
        bb.moe_apply = moe_apply
    peak = torch.cuda.max_memory_allocated()       # the step's, its inputs included
    grads = opt["momentum"]    # zero momentum, no decay: the step's gradient in bf16
    bad = [i for i, t in enumerate(tree_leaves(grads)) if not bool(torch.isfinite(t).all())]
    check(not bad, f"phase 17b: gradient leaves {bad} not finite")
    check(len(routed) == L and len(dropped) == 2 * L * n_micro,
          f"phase 17b: {len(routed)} MoE layers routed, {len(dropped)} MoE calls")
    for i, (blk, pb) in enumerate(zip(grads["blocks"], params["blocks"])):
        took = routed[pb["moe"]["router"]["w"].data_ptr()]
        moved = torch.stack([blk["moe"][w].flatten(1).abs().amax(1) > 0
                             for w in ("gate", "up", "down")]).all(0)
        check(float(blk["moe"]["router"]["w"].abs().max()) > 0,
              f"phase 17b: layer {i}'s router gradient is 0")
        check(bool((moved | ~took).all()), f"phase 17b: layer {i}: experts "
              f"{torch.nonzero(took & ~moved).flatten().tolist()} took slots and got no gradient")
    n_took = [int(routed[pb["moe"]["router"]["w"].data_ptr()].sum()) for pb in params["blocks"]]
    del grads

    # step 1 again from the same state, its first outputs kept on the host
    # meanwhile: bitwise the same loss, gradient (momentum) and params
    kept = [t.cpu() for t in tree_leaves(p) + tree_leaves(opt)]
    del p, opt
    p, opt, m1b = step(params, opt0, batches[0])
    check(torch.equal(m1b["loss"], m1["loss"])
          and all(torch.equal(a, b.to(a.device))
                  for a, b in zip(tree_leaves(p) + tree_leaves(opt), kept)),
          "phase 17b: step 1 again from the same state is not bitwise the same")
    del kept, params, opt0
    losses, host = [float(m1["loss"])], []
    for i in range(1, MOE_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, opt, mi = step(p, opt, batches[i])
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
        losses.append(float(mi["loss"]))
    launches = slice11_counts()
    check_launches(launches, moe_train_expected(L, MOE_TRAIN_STEPS + 1), "phase 17b")
    check(all(math.isfinite(x) for x in losses), f"phase 17b: losses {losses}")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        p, opt, mi = step(p, opt, batches[MOE_TRAIN_STEPS])
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    kernels = profiled_kernels(prof)
    busy_us = sum(us for us, _ in kernels.values())
    ours = {"flash_attention_backward_bf16": "flash_bwd_",
            "flash_attention_bf16": "flash_attention_bf16_kernel",
            "rmsnorm_backward_bf16": "rmsnorm_backward_kernel<__nv_bfloat16",
            "rmsnorm_dscale_bf16": "rmsnorm_dscale_kernel<__nv_bfloat16",
            "rmsnorm_bf16": "rmsnorm_bf16_kernel"}
    by = {}
    for key, (us, n) in kernels.items():
        name = next((nm for nm, pat in ours.items() if pat in key), key[:60])
        cur = by.setdefault(name, [0.0, 0])
        cur[0] += us / 1e3
        cur[1] += n
    top = dict(sorted(by.items(), key=lambda kv: -kv[1][0])[:10])
    tokens = MOE_TRAIN_BATCH * MOE_TRAIN_SEQ
    step_s = statistics.median(host)
    out = {"arch": MOE_ARCH, "layers": L, "params": n_params, "init_s": init_s,
           "seq_len": MOE_TRAIN_SEQ, "global_batch": MOE_TRAIN_BATCH, "n_micro": n_micro,
           "capacity": capacity, "dropped_fraction": dropped,
           "experts_that_took_slots": n_took, "first_step_s": first_s, "step_s": host,
           "step_s_median": step_s, "tokens_per_s": tokens / step_s, "peak_bytes": peak,
           "losses": losses, "launches": launches, "profiled_step_s": prof_s,
           "busy_share": busy_us / 1e3 / (prof_s * 1e3),
           "ours_ms": {n: by[n] for n in ours if n in by}, "top_kernels_ms": top,
           "n_kernels": sum(n for _, n in kernels.values())}
    print(f"phase 17b: {MOE_ARCH} at full width, {L} of 48 layers ({n_params / 1e9:.3f} B "
          f"params, bf16, drawn on the card in {init_s:.1f} s), make_train_step at T = "
          f"{MOE_TRAIN_SEQ}, global batch {MOE_TRAIN_BATCH} (cut from 256) in {n_micro} "
          f"microbatches: step {step_s:.3f} s (median of {len(host)}; first {first_s:.3f} s "
          f"with the routing traced), {out['tokens_per_s']:.0f} tokens/s, step 1's peak "
          f"{peak / 2**30:.2f} GiB of {torch.cuda.get_device_properties(0).total_memory / 2**30:.1f}; "
          f"losses {losses}; launches of the {MOE_TRAIN_STEPS + 1} steps "
          f"{({n: c for n, c in launches.items() if c})} (exact); "
          f"every gradient leaf finite, the router's nonzero in every layer, every expert "
          f"that took a slot nonzero (experts that took slots by layer {n_took}); step 1 "
          f"again from the same state bitwise  [{card}]")
    print(f"phase 17b: dropped_fraction at the training capacity ({capacity} slots an "
          f"expert in a {MOE_TRAIN_SEQ}-token group): {min(dropped):.4f}-{max(dropped):.4f} "
          f"over the first step's {len(dropped)} MoE calls; busy {out['busy_share']:.1%} of a "
          f"profiled step ({prof_s:.3f} s, {out['n_kernels']} kernels); device ms (launches) "
          f"of the port's kernels {out['ours_ms']}; top kernels "
          f"{ {k: [round(v[0], 2), v[1]] for k, v in top.items()} }  [{card}]")
    del p, opt, batches
    torch.cuda.empty_cache()
    return out


def moe_train_vs_cpu(card) -> dict:
    """Phase 17c: one value-and-grad of forward_loss for reduced moonshot,
    mixtral (its window cut to MOE_CPU_WINDOW) and arctic in fp32 (TF32
    off) on the card against the port's CPU, as phase 14c; reduced
    moonshot in bf16: its loss within MOE_TRAIN_BF16_CPU_TOL relative and
    every gradient leaf finite, the leaves' distance reported (top-2 of 4
    experts: a token whose 2nd and 3rd router probabilities nearly tie
    takes another expert when its bf16 activations differ by an ulp, and
    such flips move whole leaves by up to 19 % of their scale on the CPU
    alone, kernels emulated against plain); and the same model routing
    every token to all 4 experts (top_k = n_experts, capacity S: no route
    can flip) with every leaf within MOE_TRAIN_BF16_CPU_TOL of its scale."""
    out = {}
    for name in MOE_REDUCED:
        cfg = get_config(name).reduced()
        if cfg.sliding_window:
            cfg = dataclasses.replace(cfg, sliding_window=MOE_CPU_WINDOW)
        params = tree_to(bb.init_params(cfg, seed=0, device="cpu"), "cuda")
        with fp32_math():
            out[name] = lm_vs_cpu(cfg, params, what=f"phase 17c: {cfg.name} fp32")
    cfg = dataclasses.replace(get_config(MOE_ARCH).reduced(), param_dtype="bfloat16")
    every = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, top_k=cfg.moe.n_experts))
    for key, c, tol in ((f"{MOE_ARCH} bf16", cfg, None),
                        (f"{MOE_ARCH} bf16 top_k = n_experts", every, MOE_TRAIN_BF16_CPU_TOL)):
        params = tree_to(bb.init_params(c, seed=0, device="cpu"), "cuda")
        out[key] = lm_vs_cpu(c, params, what=f"phase 17c: {c.name} bf16, top-{c.moe.top_k} "
                             f"of {c.moe.n_experts}", loss_tol=MOE_TRAIN_BF16_CPU_TOL,
                             grad_tol=tol)
    return out


def moe_train_alone(card) -> dict:
    """Phase 17 (a)-(c) in a fresh child process of this script, which
    prints its lines and writes its numbers to a JSON file
    (``phase_moe_train``)."""
    t0 = time.perf_counter()
    kernels = moe_train_kernels(card)
    t_a = time.perf_counter() - t0
    train = moe_train(card)
    t_b = time.perf_counter() - t0 - t_a
    vs_cpu = moe_train_vs_cpu(card)
    return {"kernels": kernels, "train": train, "vs_cpu": vs_cpu,
            "part_s": {"a": t_a, "b": t_b, "c": time.perf_counter() - t0 - t_a - t_b}}


def phase_moe_train(card) -> tuple:
    """Phase 17: ``moe_train_alone`` in a fresh child process, started
    after phase 16's child has freed its memory; returns the two bf16
    backward kernels' rows of the kernels line, the launches of the bf16
    forwards on its path, and the numbers."""
    sys.stdout.flush()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "moe_train_alone.json")
        subprocess.run([sys.executable, os.path.abspath(__file__), "--moe-train-alone", path],
                       check=True, timeout=MOE_TRAIN_ALONE_TIMEOUT_S)
        with open(path) as f:
            mt = json.load(f)
    mt["phase_s"] = time.perf_counter() - t0
    rows = []
    for name, src in (("flash_attention_backward", "src/repro_torch/csrc/flash_attention_backward_bf16.cu"),
                      ("rmsnorm_backward", "src/repro_torch/csrc/rmsnorm_backward.cu")):
        c = mt["kernels"][name]
        replaces = ("src/repro/kernels/attention/kernel.py:78" if name.startswith("flash")
                    else "src/repro/kernels/rmsnorm/kernel.py:25")
        rows.append({"name": f"{name}_bf16", "route": "cuda", "source": src,
                     "replaces": replaces, "launches": mt["train"]["launches"][f"{name}_bf16"],
                     "max_abs_err": c["max_abs_err"], "ms": c["ms"], "plain_ms": c["plain_ms"],
                     "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                     "library_ms": c["library_ms"]})
    forwards = {n: mt["train"]["launches"][n] for n in ("flash_attention_bf16", "rmsnorm_bf16")}
    print(f"phase 17: {mt['phase_s']:.1f} s in a child process, by part "
          f"{ {k: round(v, 1) for k, v in mt['part_s'].items()} }")
    return rows, forwards, mt


# ------------------------------------------------------------ slice 16 ---
def xlstm_cells(card) -> dict:
    """Phase 18a: the mLSTM and sLSTM on the card at xlstm-350m's heads
    (d 1,024, 4 heads of 256), fp32, seed-0 cells, B = XLSTM_CELL_B, T =
    XLSTM_CELL_T (off the 64-token chunk): the chunked mLSTM against the
    sequential one on a cell's own gates, each cell's full sequence against
    its one-token decode steps, at the reference's bars; each path's time."""
    cfg = get_config(XLSTM_ARCH)
    d, H = cfg.d_model, cfg.n_heads
    B, T = XLSTM_CELL_B, XLSTM_CELL_T
    gen = torch.Generator(device="cuda").manual_seed(181)
    out = {"shape": (B, T, H, d // H)}
    for kind, bar in (("mlstm", XLSTM_MLSTM_DECODE_TOL), ("slstm", XLSTM_SLSTM_DECODE_TOL)):
        init, apply, step, state0 = XLSTM_CELLS[kind]
        p = init(gen, d, H, device="cuda")
        x = 0.5 * torch.randn((B, T, d), generator=gen, device="cuda")
        if kind == "mlstm":
            gates = xlstm_nn._mlstm_gates(p, x, H)
            yc, _ = xlstm_nn.mlstm_chunked(*gates)
            ys = xlstm_nn.mlstm_sequential(*gates)
            err = close_err(yc, ys, XLSTM_CHUNK_TOL, "phase 18a: mlstm_chunked vs sequential")
            out["chunked_vs_sequential"] = err
            out["chunked_ms"] = time_ms(lambda: xlstm_nn.mlstm_chunked(*gates), reps=5)
            out["sequential_ms"] = time_ms(lambda: xlstm_nn.mlstm_sequential(*gates), reps=3)
        y = apply(p, x, n_heads=H)
        state = state0(B, d, H)
        ys = []
        for t in range(T):
            yt, state = step(p, x[:, t:t + 1], state, n_heads=H)
            ys.append(yt)
        out[f"{kind}_full_vs_decode"] = close_err(torch.cat(ys, 1), y, bar,
                                                  f"phase 18a: {kind} full vs decode")
        out[f"{kind}_apply_ms"] = time_ms(lambda: apply(p, x, n_heads=H), reps=5)
    print(f"phase 18a: {XLSTM_ARCH}'s cells at (B, T, H, D) = {out['shape']}, fp32: "
          f"mlstm_chunked vs mlstm_sequential max |err| {out['chunked_vs_sequential']:.3e} "
          f"(bar {XLSTM_CHUNK_TOL} abs + rel), mLSTM full vs decode "
          f"{out['mlstm_full_vs_decode']:.3e} (bar {XLSTM_MLSTM_DECODE_TOL}), sLSTM full vs "
          f"decode {out['slstm_full_vs_decode']:.3e} (bar {XLSTM_SLSTM_DECODE_TOL}); "
          f"mlstm_chunked {out['chunked_ms']:.3f} ms, mlstm_sequential "
          f"{out['sequential_ms']:.3f} ms, mlstm_apply {out['mlstm_apply_ms']:.3f} ms, "
          f"slstm_apply {out['slstm_apply_ms']:.3f} ms (CUDA events)  [{card}]")
    return out


def xlstm_rms_rows(card) -> dict:
    """RMSNorm and its backward at the xLSTM training rows (B * T, d) =
    (XLSTM_TRAIN_BATCH * XLSTM_TRAIN_SEQ, 1,024), fp32: the forward within
    LLM_KERNEL_TOL of its plain version, the backward within LM_RMS_TOL of
    float64's scale, two calls bitwise; each timed beside its plain
    version, the library call (``F.rms_norm``, its backward) and its
    bound."""
    gen = torch.Generator(device="cuda").manual_seed(183)
    N, d = XLSTM_TRAIN_BATCH * XLSTM_TRAIN_SEQ, get_config(XLSTM_ARCH).d_model
    x = torch.randn((N, d), generator=gen, device="cuda").requires_grad_()
    scale = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).requires_grad_()
    g = torch.randn((N, d), generator=gen, device="cuda")
    xd, sd = x.detach(), scale.detach()
    fwd_err = close_err(rmsnorm_cuda(xd, sd), rmsnorm_ref(xd, sd), LLM_KERNEL_TOL,
                        "phase 18: rmsnorm at the xLSTM rows")
    dx, ds = rmsnorm_backward_cuda(xd, sd, g)
    dx2, ds2 = rmsnorm_backward_cuda(xd, sd, g)
    check(torch.equal(dx, dx2) and torch.equal(ds, ds2),
          "phase 18: two rmsnorm_backward calls differ")
    rx, rs = rmsnorm_grads64(xd, sd, g)
    bwd_err = 0.0
    for got, ref, what in ((dx, rx, "dx"), (ds, rs, "dscale")):
        e = (got.double() - ref).abs().max().item()
        check(e <= LM_RMS_TOL * ref.abs().max().item(),
              f"phase 18: rmsnorm_backward {what} off float64 by {e}")
        bwd_err = max(bwd_err, e)
    y_ref, y_lib = rmsnorm_ref(x, scale), torch.nn.functional.rms_norm(x, (d,), scale, 1e-6)
    rows = {}
    for name, kern, plain, library, nbytes, ops, err in (
            ("rmsnorm", lambda: rmsnorm_cuda(xd, sd), lambda: rmsnorm_ref(xd, sd),
             lambda: torch.nn.functional.rms_norm(xd, (d,), sd, 1e-6),
             (2 * N * d + d) * 4, 4 * N * d, fwd_err),
            ("rmsnorm_backward", lambda: rmsnorm_backward_cuda(xd, sd, g),
             lambda: torch.autograd.grad(y_ref, (x, scale), g, retain_graph=True),
             lambda: torch.autograd.grad(y_lib, (x, scale), g, retain_graph=True),
             (3 * N * d + 2 * d) * 4, 6 * N * d, bwd_err)):
        bound_ms, bound_by = bound(nbytes, ops)
        ms, plain_ms, library_ms = (time_ms(fn) for fn in (kern, plain, library))
        rows[name] = {"shape": (N, d), "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"phase 18: {name} at the xLSTM training rows ({N}, {d}): {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}); max |err| {err:.3e}  [{card}]")
    return rows


def xlstm_serve(cfg, params, card) -> dict:
    """Phase 18b: xlstm-350m at full size through ``ServeEngine.generate``
    (launch counts from 0, exact: the pre-norms and the final norm a
    forward, no attention kernel); weights, peak, tokens/s; a second
    generate's layer-0 and final RMSNorm calls replayed against the plain
    version; the prefill alone, each decode step's host time and, by
    torch.profiler, its kernels' device time."""
    from torch.profiler import ProfilerActivity, profile

    L = cfg.n_layers
    leaves = tree_leaves(params)
    n_params = param_count(params)
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves)
    rng = np.random.RandomState(182)
    reqs = [Request(tokens=rng.randint(0, cfg.vocab, XLSTM_PROMPT),
                    max_new_tokens=XLSTM_NEW) for _ in range(XLSTM_BATCH)]
    eng = ServeEngine(cfg, params, max_len=XLSTM_MAX_LEN)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = slice11_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = outs[0].steps
    check(steps == XLSTM_NEW, f"phase 18b: {steps} steps for {XLSTM_NEW} tokens")
    check_launches(launches, {"rmsnorm": (L + 1) * steps}, "phase 18b")
    for c in outs:
        check(len(c.tokens) == XLSTM_NEW and c.tokens.min() >= 0
              and c.tokens.max() < cfg.vocab, f"phase 18b: a completion {c.tokens}")
    tokens = [c.tokens.tolist() for c in outs]
    kept, restore = capture_kernel_calls(cfg)
    try:
        again = eng.generate(reqs)
    finally:
        restore()
    check([c.tokens.tolist() for c in again] == tokens,
          "phase 18b: a second greedy generate gave other tokens")
    kernel_errs = replay_kernel_calls(kept, "phase 18b")
    del kept

    batch = {"tokens": torch.as_tensor(np.stack([r.tokens for r in reqs]), device="cuda")}
    prefill_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache, T = bb.prefill(cfg, params, batch, max_len=XLSTM_MAX_LEN)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
    host = []
    for i in range(XLSTM_NEW - 1):
        tok = torch.argmax(logits, -1)[:, None]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = bb.decode_step(cfg, params, tok, cache, T + i)
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
    tok = torch.argmax(logits, -1)[:, None]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(XLSTM_PROFILE_STEPS):
            logits, cache = bb.decode_step(cfg, params, tok, cache, T + XLSTM_NEW + i)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    kernels = profiled_kernels(prof)
    device_us = sum(us for us, _ in kernels.values()) / XLSTM_PROFILE_STEPS
    n_kernels = sum(n for _, n in kernels.values()) / XLSTM_PROFILE_STEPS
    top = sorted(((us / XLSTM_PROFILE_STEPS / 1e3, k[:48]) for k, (us, _) in kernels.items()),
                 reverse=True)[:6]
    out = {"arch": XLSTM_ARCH, "params": n_params, "weight_bytes": weight_bytes,
           "requests": XLSTM_BATCH, "prompt": XLSTM_PROMPT, "new_tokens": XLSTM_NEW,
           "generate_s": wall, "tokens_per_s": XLSTM_BATCH * XLSTM_NEW / wall,
           "peak_bytes": peak, "launches": launches, "kernel_errs": kernel_errs,
           "prefill_s": statistics.median(prefill_s), "prefill_s_all": prefill_s,
           "decode_step_host_ms": [h * 1e3 for h in host],
           "decode_step_host_ms_median": statistics.median(host) * 1e3,
           "decode_step_device_ms": device_us / 1e3, "decode_step_kernels": n_kernels,
           "profiled_steps_host_ms": prof_s * 1e3 / XLSTM_PROFILE_STEPS,
           "decode_top_kernels_ms": top, "greedy_tokens_row0": tokens[0]}
    print(f"phase 18b: {XLSTM_ARCH} at full size ({L} layers, {n_params / 1e9:.4f} B params, "
          f"{weight_bytes / 2**30:.2f} GiB of fp32 weights): ServeEngine(max_len="
          f"{XLSTM_MAX_LEN}).generate of {XLSTM_BATCH} x {XLSTM_PROMPT}-token prompts, "
          f"{XLSTM_NEW} greedy tokens each, in {wall:.3f} s ({out['tokens_per_s']:.1f} "
          f"tokens/s); peak {peak / 2**30:.2f} GiB; launches "
          f"{ {n: c for n, c in launches.items() if c} } (exact: {L + 1} RMSNorm a forward, "
          f"no attention kernel)  [{card}]")
    print(f"phase 18b: prefill alone {out['prefill_s'] * 1e3:.1f} ms (host, median of 3: "
          f"{[round(x * 1e3, 1) for x in prefill_s]}); decode steps on the host median "
          f"{out['decode_step_host_ms_median']:.2f} ms ({[round(h * 1e3, 2) for h in host]}); "
          f"a decode step's kernels {out['decode_step_device_ms']:.3f} ms of device time in "
          f"{n_kernels:.0f} launches (torch.profiler over {XLSTM_PROFILE_STEPS} steps, "
          f"{out['profiled_steps_host_ms']:.2f} ms a step on the host there); top kernels "
          f"(ms a step) {top}  [{card}]")
    del eng, logits, cache, outs, again
    return out


def xlstm_vs_cpu(cfg, params, card) -> dict:
    """Phase 18c: XLSTM_CPU_B prompts of XLSTM_CPU_T tokens on the card and
    on the port's CPU, the same weights: ``card_vs_cpu`` (prefill logits
    within LLM_LOGIT_TOL, greedy tokens by the near-tie rule)."""
    prompts = np.random.RandomState(185).randint(0, cfg.vocab, (XLSTM_CPU_B, XLSTM_CPU_T))
    return card_vs_cpu(cfg, params, [Request(tokens=p, max_new_tokens=XLSTM_CPU_NEW)
                                     for p in prompts],
                       XLSTM_CPU_T + XLSTM_CPU_NEW, "phase 18c")


def ranged(fn, name: str):
    """``fn`` inside a torch.profiler range named ``name``."""
    def run(*a, **kw):
        with record_function(name):
            return fn(*a, **kw)
    return run


def raw_profile(prof, ranges=()) -> dict:
    """A finished torch.profiler run read from its raw (kineto) events,
    without the Python event tree that ``key_averages`` builds (minutes
    for a step of 10^6 launches): {"kernels": {name: [device us,
    launches]}, "busy_us", "n_kernels", "ranges": {name: ...}} over the
    device work (kernels, copies, sets: the device events that a host
    call of the CUDA API, named ``cu...``, launched; not the spans that
    profiler ranges leave on the device).  For each name of
    ``ranges`` (torch.profiler ranges, ``ranged``): what the run spent in
    those ranges and in the backward of the operators run inside them (the
    autograd nodes that carry those operators' sequence numbers): host us
    (the union of those intervals on each thread), the kernels launched
    from them and their device us."""
    import bisect

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    ns = ((lambda e: e.start_ns(), lambda e: e.end_ns(), lambda e: e.duration_ns())
          if events and hasattr(events[0], "duration_ns") else
          (lambda e: e.start_us() * 1000, lambda e: (e.start_us() + e.duration_us()) * 1000,
           lambda e: e.duration_us() * 1000))
    start, end, dur = ns
    device, launch, ann, fwd, bwd = [], {}, {n: [] for n in ranges}, [], []
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                device.append((name, dur(e), e.correlation_id()))
        elif name.startswith("cu"):
            launch[e.correlation_id()] = (e.start_thread_id(), start(e))
        elif name in ann:
            ann[name].append((e.start_thread_id(), start(e), end(e)))
        elif e.sequence_nr() >= 0:
            if name.startswith("autograd::engine::evaluate_function"):
                bwd.append(((e.fwd_thread_id(), e.sequence_nr()),
                            (e.start_thread_id(), start(e), end(e))))
            elif e.fwd_thread_id() == 0:
                fwd.append((e.start_thread_id(), start(e), e.sequence_nr()))
    device = [d for d in device if d[2] in launch]
    kernels = {}
    for name, t, _ in device:
        cur = kernels.setdefault(name, [0.0, 0])
        cur[0] += t / 1e3
        cur[1] += 1

    def merged(intervals):
        """{thread: (sorted starts, ends)} of the union of (thread, start,
        end) intervals."""
        by = {}
        for tid, a, b in sorted(intervals):
            runs = by.setdefault(tid, [])
            if runs and a <= runs[-1][1]:
                runs[-1][1] = max(runs[-1][1], b)
            else:
                runs.append([a, b])
        return {t: ([a for a, _ in r], [b for _, b in r]) for t, r in by.items()}

    def inside(spans, tid, t) -> bool:
        starts, ends = spans.get(tid, ((), ()))
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= ends[i]

    out = {}
    for name, intervals in ann.items():
        spans = merged(intervals)
        seq = {(tid, n) for tid, t, n in fwd if inside(spans, tid, t)}
        spans = merged(intervals + [iv for key, iv in bwd if key in seq])
        corr = {c for c, (tid, t) in launch.items() if inside(spans, tid, t)}
        mine = [t for _, t, c in device if c in corr]
        out[name] = {"ranges": len(intervals),
                     "host_us": sum(b - a for starts, ends in spans.values()
                                    for a, b in zip(starts, ends)) / 1e3,
                     "launches": len(mine), "device_us": sum(mine) / 1e3}
    return {"kernels": kernels, "busy_us": sum(t for _, t, _ in device) / 1e3,
            "n_kernels": len(device), "ranges": out}


def xlstm_train(cfg, params, card) -> dict:
    """Phase 18d: xlstm-350m at full size, fp32, through ``make_train_step``
    at T = XLSTM_TRAIN_SEQ, the global batch cut to XLSTM_TRAIN_BATCH (one
    microbatch): XLSTM_TRAIN_STEPS steps on uniform tokens, step 1 run
    again from the same state (bitwise the same loss, gradient and
    params), launches of step 1 from 0 and exact, and of the rest exact;
    every gradient leaf finite and nonzero; step s (the rerun and step 2),
    tokens/s, step 1's peak; the last step profiled: its busy share,
    device ms by kernel, and the share of its launches, host time and
    device time in the sLSTM cells' time loop and in the mLSTM cells
    (their forwards, the remat recompute and their backward)."""
    from torch.profiler import ProfilerActivity, profile

    L = cfg.n_layers
    shape = InputShape("train_4k", XLSTM_TRAIN_SEQ, XLSTM_TRAIN_BATCH, "train")
    n_micro = n_microbatches(cfg, shape)
    check(n_micro == 1, f"phase 18d: {n_micro} microbatches at d = {cfg.d_model}")
    step = make_train_step(cfg, shape)
    gen = torch.Generator(device="cuda").manual_seed(184)
    batches = [{k: torch.randint(0, cfg.vocab, (XLSTM_TRAIN_BATCH, XLSTM_TRAIN_SEQ),
                                 generator=gen, device="cuda") for k in ("tokens", "labels")}
               for _ in range(XLSTM_TRAIN_STEPS)]
    opt0 = opt_init(params)
    per_step = {"rmsnorm": 2 * L + 1, "rmsnorm_backward": L + 1}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    p, opt, m1 = step(params, opt0, batches[0])
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = slice11_counts()
    check_launches(launches, per_step, "phase 18d: step 1")
    peak = torch.cuda.max_memory_allocated()
    leaves = tree_leaves(opt["momentum"])    # zero momentum, no decay: the gradient
    bad = [i for i, t in enumerate(leaves)
           if not bool(torch.isfinite(t).all()) or float(t.abs().max()) == 0.0]
    check(not bad, f"phase 18d: gradient leaves not finite or all zero: {bad} of {len(leaves)}")
    kept = [t.cpu() for t in tree_leaves(p) + tree_leaves(opt)]
    del p, opt, leaves
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p, opt, m1b = step(params, opt0, batches[0])
    torch.cuda.synchronize()
    host = [time.perf_counter() - t0]
    check(torch.equal(m1b["loss"], m1["loss"])
          and all(torch.equal(a, b.to(a.device))
                  for a, b in zip(tree_leaves(p) + tree_leaves(opt), kept)),
          "phase 18d: step 1 again from the same state is not bitwise the same")
    del kept, opt0
    losses = [float(m1["loss"])]
    for i in range(1, XLSTM_TRAIN_STEPS - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, opt, mi = step(p, opt, batches[i])
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
        losses.append(float(mi["loss"]))

    real = {"slstm": bb.slstm_apply, "mlstm": bb.mlstm_apply}
    bb.slstm_apply = ranged(real["slstm"], "xlstm.slstm")
    bb.mlstm_apply = ranged(real["mlstm"], "xlstm.mlstm")
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            p, opt, mi = step(p, opt, batches[-1])
            torch.cuda.synchronize()
            prof_s = time.perf_counter() - t0
    finally:
        bb.slstm_apply, bb.mlstm_apply = real["slstm"], real["mlstm"]
    losses.append(float(mi["loss"]))
    check(all(math.isfinite(x) for x in losses), f"phase 18d: losses {losses}")
    later = slice11_counts()
    check_launches(later, {n: c * XLSTM_TRAIN_STEPS for n, c in per_step.items()},
                   "phase 18d: step 1 again and the later steps")
    t0 = time.perf_counter()
    raw = raw_profile(prof, ("xlstm.slstm", "xlstm.mlstm"))
    parse_s = time.perf_counter() - t0
    kernels, busy_us, n_kernels = raw["kernels"], raw["busy_us"], raw["n_kernels"]
    check(n_kernels > 0 and busy_us > 0, "phase 18d: torch.profiler recorded no kernel")
    cells = {k: raw["ranges"][f"xlstm.{k}"] for k in ("slstm", "mlstm")}
    ours = {"rmsnorm_backward": "rmsnorm_backward_kernel<float", "rmsnorm_dscale":
            "rmsnorm_dscale_kernel<float", "rmsnorm": "rmsnorm_kernel"}
    by = {}
    for key, (us, n) in kernels.items():
        name = next((nm for nm, pat in ours.items() if pat in key), key[:60])
        cur = by.setdefault(name, [0.0, 0])
        cur[0] += us / 1e3
        cur[1] += n
    top = dict(sorted(by.items(), key=lambda kv: -kv[1][0])[:10])
    shares = {k: {"ranges": c["ranges"], "launches": c["launches"] / n_kernels,
                  "host": c["host_us"] / 1e6 / prof_s,
                  "device": c["device_us"] / busy_us} for k, c in cells.items()}
    tokens = XLSTM_TRAIN_BATCH * XLSTM_TRAIN_SEQ
    step_s = statistics.median(host)
    out = {"arch": XLSTM_ARCH, "layers": L, "seq_len": XLSTM_TRAIN_SEQ,
           "global_batch": XLSTM_TRAIN_BATCH, "n_micro": n_micro, "first_step_s": first_s,
           "step_s": host, "step_s_median": step_s, "tokens_per_s": tokens / step_s,
           "peak_bytes": peak, "losses": losses, "launches_per_step": launches,
           "profiled_step_s": prof_s, "profile_parse_s": parse_s,
           "busy_share": busy_us / 1e6 / prof_s, "n_kernels": n_kernels,
           "ours_ms": {n: by[n] for n in ours if n in by}, "top_kernels_ms": top,
           "cells": cells, "cell_shares": shares}
    print(f"phase 18d: {XLSTM_ARCH} at full size, fp32, make_train_step at T = "
          f"{XLSTM_TRAIN_SEQ} (cut from 4,096), global batch {XLSTM_TRAIN_BATCH} (cut from "
          f"256) in {n_micro} microbatch: step {step_s:.3f} s (median of {len(host)}: step 1 "
          f"again and step 2; first {first_s:.3f} s), "
          f"{out['tokens_per_s']:.0f} tokens/s, step 1's peak {peak / 2**30:.2f} GiB; losses "
          f"{losses}; launches a step { {n: c for n, c in launches.items() if c} } (exact); "
          f"every gradient leaf finite and nonzero; step 1 again from the same state "
          f"bitwise  [{card}]")
    print(f"phase 18d: a profiled step ({prof_s:.3f} s, {n_kernels} kernels; the trace "
          f"read in {parse_s:.1f} s): busy {out['busy_share']:.1%}; device ms (launches) "
          f"of the port's kernels {out['ours_ms']}; top kernels "
          f"{ {k: [round(v[0], 2), v[1]] for k, v in top.items()} }; the sLSTM time loop "
          f"(3 cells: forward, recompute, backward) {shares['slstm']['launches']:.1%} of the "
          f"launches, {shares['slstm']['host']:.1%} of the host time, "
          f"{shares['slstm']['device']:.1%} of the device time; the mLSTM cells "
          f"{shares['mlstm']['launches']:.1%}, {shares['mlstm']['host']:.1%}, "
          f"{shares['mlstm']['device']:.1%}  [{card}]")
    del p, opt, batches
    return out


def xlstm_alone(card) -> dict:
    """Phase 18 (a)-(d) in a fresh child process of this script, which
    prints its lines and writes its numbers to a JSON file
    (``phase_xlstm``): xlstm-350m's seed-0 weights drawn on the card."""
    t0 = time.perf_counter()
    cells = xlstm_cells(card)
    rms = xlstm_rms_rows(card)
    t_a = time.perf_counter() - t0
    cfg = get_config(XLSTM_ARCH)
    params = bb.init_params(cfg, seed=0, gen_device="cuda")
    check(all(t.dtype == torch.float32 and t.device.type == "cuda"
              for t in tree_leaves(params)), "phase 18: a parameter is not fp32 on the card")
    serve = xlstm_serve(cfg, params, card)
    t_b = time.perf_counter() - t0 - t_a
    vs_cpu = xlstm_vs_cpu(cfg, params, card)
    t_c = time.perf_counter() - t0 - t_a - t_b
    train = xlstm_train(cfg, params, card)
    return {"cells": cells, "rms": rms, "serve": serve, "vs_cpu": vs_cpu, "train": train,
            "part_s": {"a": t_a, "b": t_b, "c": t_c,
                       "d": time.perf_counter() - t0 - t_a - t_b - t_c}}


def phase_xlstm(card) -> tuple:
    """Phase 18: ``xlstm_alone`` in a fresh child process, started after
    phase 17's has ended; returns the launches of the fp32 RMSNorm kernels
    on its paths, their largest errors, and the numbers."""
    sys.stdout.flush()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "xlstm_alone.json")
        subprocess.run([sys.executable, os.path.abspath(__file__), "--xlstm-alone", path],
                       check=True, timeout=XLSTM_ALONE_TIMEOUT_S)
        with open(path) as f:
            xl = json.load(f)
    xl["phase_s"] = time.perf_counter() - t0
    launches = {n: xl["serve"]["launches"].get(n, 0)
                + xl["train"]["launches_per_step"].get(n, 0) * (XLSTM_TRAIN_STEPS + 1)
                for n in ("rmsnorm", "rmsnorm_backward")}
    errs = {"rmsnorm": max(xl["rms"]["rmsnorm"]["max_abs_err"],
                           xl["serve"]["kernel_errs"].get("rmsnorm", 0.0)),
            "rmsnorm_backward": xl["rms"]["rmsnorm_backward"]["max_abs_err"]}
    print(f"phase 18: {xl['phase_s']:.1f} s in a child process, by part "
          f"{ {k: round(v, 1) for k, v in xl['part_s'].items()} }")
    return launches, errs, xl


# ------------------------------------------------------------ slice 17 ---
def jamba_block(card) -> dict:
    """Phase 19a: one Mamba block of jamba-1.5-large-398b at full width (d
    8,192, d_inner 16,384), fp32, seed-190 weights drawn on the card, B =
    JAMBA_BLOCK_B, T = JAMBA_BLOCK_T (off the 128-token chunk): the chunked
    scan (``mamba_apply``) against the sequential oracle
    (``mamba_reference``) within 2e-4; the prefill's state, then
    JAMBA_BLOCK_DECODE decode steps, against the oracle within 3e-4; each
    path over the T tokens timed once on the host and by torch.profiler
    (its kernels' device ms and launches)."""
    from torch.profiler import ProfilerActivity, profile

    cfg = get_config(JAMBA_ARCH)
    h = cfg.hybrid
    kw = {"d_state": h.d_state, "d_conv": h.d_conv}
    B, T, n = JAMBA_BLOCK_B, JAMBA_BLOCK_T, JAMBA_BLOCK_DECODE
    gen = torch.Generator(device="cuda").manual_seed(190)
    p = ssm_nn.mamba_init(gen, cfg.d_model, expand=h.expand, device="cuda", **kw)
    x = 0.5 * torch.randn((B, T + n, cfg.d_model), generator=gen, device="cuda")
    full = ssm_nn.mamba_reference(p, x, **kw)
    y, state = ssm_nn.mamba_apply(p, x[:, :T], return_state=True, **kw)
    out = {"shape": [B, T, cfg.d_model, h.expand * cfg.d_model, h.d_state],
           "chunked_vs_sequential": close_err(
               y, full[:, :T], JAMBA_CHUNK_TOL, "phase 19a: mamba_apply vs mamba_reference")}
    steps = []
    for t in range(T, T + n):
        yt, state = ssm_nn.mamba_decode_apply(p, x[:, t:t + 1], state, **kw)
        steps.append(yt)
    out["decode_vs_sequential"] = close_err(
        torch.cat(steps, 1), full[:, T:], JAMBA_DECODE_TOL,
        "phase 19a: prefill state then decode vs mamba_reference")
    xt = x[:, :T]
    for name, fn in (("chunked", lambda: ssm_nn.mamba_apply(p, xt, **kw)),
                     ("sequential", lambda: ssm_nn.mamba_reference(p, xt, **kw))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        raw = raw_profile(prof)
        check(raw["n_kernels"] > 0, f"phase 19a: torch.profiler recorded no kernel of {name}")
        out[name] = {"host_ms": host_ms, "device_ms": raw["busy_us"] / 1e3,
                     "launches": raw["n_kernels"]}
    del p, x, full, y, state
    print(f"phase 19a: a Mamba block of {JAMBA_ARCH} at full width (B, T, d, d_inner, "
          f"d_state) = {out['shape']}, fp32: chunked vs sequential max |err| "
          f"{out['chunked_vs_sequential']:.3e} (bar {JAMBA_CHUNK_TOL} abs + rel), prefill "
          f"state then {n} decode steps vs sequential {out['decode_vs_sequential']:.3e} (bar "
          f"{JAMBA_DECODE_TOL}); over {T} tokens: chunked {out['chunked']['host_ms']:.2f} ms "
          f"host, {out['chunked']['device_ms']:.2f} ms device in "
          f"{out['chunked']['launches']} launches; sequential "
          f"{out['sequential']['host_ms']:.2f} ms host, {out['sequential']['device_ms']:.2f} "
          f"ms device in {out['sequential']['launches']} launches  [{card}]")
    return out


def jamba_served_config():
    """Jamba at full width cut to one card: one superblock, JAMBA_EXPERTS
    of its 16 experts (top-2 kept)."""
    cfg = get_config(JAMBA_ARCH)
    return dataclasses.replace(cfg, n_layers=JAMBA_LAYERS,
                               moe=dataclasses.replace(cfg.moe, n_experts=JAMBA_EXPERTS))


def jamba_serve(cfg, card) -> dict:
    """Phase 19c: the served Jamba (``jamba_served_config``) in bf16, drawn
    on the card, through ``ServeEngine.generate`` (launch counts from 0,
    exact: a flash call a prefill and a decode attention call a step for
    its attention layer, 2L + 1 RMSNorm calls a forward); weights, peak,
    tokens/s, the dropped fractions; a second generate's tokens equal and
    its attention layer's and final norm's kernel calls replayed against
    the plain versions (phase 16b's bars); the prefill alone; each decode
    step's host time; and by torch.profiler, read raw (``raw_profile``),
    a prefill's and JAMBA_PROFILE_STEPS decode steps' kernels and the
    Mamba mixers' shares of their launches, host time and device time."""
    from torch.profiler import ProfilerActivity, profile

    L, n_attn = cfg.n_layers, cfg.n_superblocks
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free_before = torch.cuda.mem_get_info()[0]
    t0 = time.perf_counter()
    params = bb.init_params(cfg, seed=0, gen_device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree_leaves(params)
    f32 = {"dt_bias", "A_log", "D"}
    check(all(t.device.type == "cuda" for t in leaves)
          and all((t.dtype == torch.float32) == (k in f32)
                  for blk in params["blocks"] if "mamba" in blk
                  for k, t in blk["mamba"].items() if isinstance(t, torch.Tensor)),
          "phase 19c: a parameter is off the card, or a Mamba leaf in the wrong dtype")
    n_params = param_count(params)
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves)
    rng = np.random.RandomState(193)
    reqs = [Request(tokens=rng.randint(0, cfg.vocab, JAMBA_PROMPT),
                    max_new_tokens=JAMBA_NEW) for _ in range(JAMBA_BATCH)]
    eng = ServeEngine(cfg, params, max_len=JAMBA_MAX_LEN)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = slice11_counts()
    peak, reserved = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
    steps = outs[0].steps
    check(steps == JAMBA_NEW, f"phase 19c: {steps} steps for {JAMBA_NEW} tokens")
    check_launches(launches, {"flash_attention_bf16": n_attn,
                              "decode_attention_bf16": n_attn * (steps - 1),
                              "rmsnorm_bf16": (2 * L + 1) * steps}, "phase 19c")
    for c in outs:
        check(len(c.tokens) == JAMBA_NEW and c.tokens.min() >= 0
              and c.tokens.max() < cfg.vocab, f"phase 19c: a completion {c.tokens}")
    aux = eng.moe_aux
    dropped = {"prefill": float(aux["prefill"]["dropped_fraction"]),
               "decode": [float(a["dropped_fraction"]) for a in aux["decode"]]}
    check(len(dropped["decode"]) == steps - 1
          and all(0.0 <= f < 1.0 for f in [dropped["prefill"], *dropped["decode"]]),
          f"phase 19c: dropped fractions {dropped}")
    tokens = [c.tokens.tolist() for c in outs]

    kept, restore = capture_kernel_calls(cfg)
    try:
        again = eng.generate(reqs)
    finally:
        restore()
    check([c.tokens.tolist() for c in again] == tokens,
          "phase 19c: a second greedy generate gave other tokens")
    kernel_errs = replay_kernel_calls(kept, "phase 19c", tol=BF16_TOL)
    for name, calls in kept.items():
        mod, attr, _ = PATH_KERNELS[name]
        for a, kw in calls:
            if name == "decode_attention":
                bf16_bitwise(getattr(mod, attr), a, kw, f"phase 19c: {name} replayed")
            else:
                bf16_bars(name, getattr(mod, attr), a, kw, f"phase 19c: {name} replayed")
    n_kept = {n: len(c) for n, c in kept.items()}
    del kept

    batch = {"tokens": torch.as_tensor(np.stack([r.tokens for r in reqs]), device="cuda")}
    prefill_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache, T = bb.prefill(cfg, params, batch, max_len=JAMBA_MAX_LEN)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
    host = []
    for i in range(JAMBA_NEW - 1):
        tok = torch.argmax(logits, -1)[:, None]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = bb.decode_step(cfg, params, tok, cache, T + i)
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
    del logits, cache

    real = {"mamba_apply": bb.mamba_apply, "mamba_decode_apply": bb.mamba_decode_apply}
    bb.mamba_apply = ranged(real["mamba_apply"], "jamba.mamba")
    bb.mamba_decode_apply = ranged(real["mamba_decode_apply"], "jamba.mamba")
    prof = {}
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as pp:
            t0 = time.perf_counter()
            logits, cache, T = bb.prefill(cfg, params, batch, max_len=JAMBA_MAX_LEN)
            torch.cuda.synchronize()
            prefill_prof_s = time.perf_counter() - t0
        tok = torch.argmax(logits, -1)[:, None]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as pd:
            t0 = time.perf_counter()
            for i in range(JAMBA_PROFILE_STEPS):
                logits, cache = bb.decode_step(cfg, params, tok, cache, T + i)
            torch.cuda.synchronize()
            decode_prof_s = (time.perf_counter() - t0) / JAMBA_PROFILE_STEPS
    finally:
        bb.mamba_apply, bb.mamba_decode_apply = real["mamba_apply"], real["mamba_decode_apply"]
    for name, pr, wall_s, per in (("prefill", pp, prefill_prof_s, 1),
                                  ("decode_step", pd, decode_prof_s, JAMBA_PROFILE_STEPS)):
        raw = raw_profile(pr, ("jamba.mamba",))
        check(raw["n_kernels"] > 0, f"phase 19c: torch.profiler recorded no kernel in {name}")
        m = raw["ranges"]["jamba.mamba"]
        check(m["ranges"] == 7 * cfg.n_superblocks * per,
              f"phase 19c: {m['ranges']} Mamba ranges in {name}")
        top = sorted(((us / per / 1e3, k[:48]) for k, (us, _) in raw["kernels"].items()),
                     reverse=True)[:6]
        prof[name] = {"host_ms": wall_s * 1e3, "device_ms": raw["busy_us"] / 1e3 / per,
                      "launches": raw["n_kernels"] / per, "top_kernels_ms": top,
                      "mamba": {"launches": m["launches"] / raw["n_kernels"],
                                "host": m["host_us"] / 1e6 / (wall_s * per),
                                "device": m["device_us"] / raw["busy_us"]}}
    out = {"arch": JAMBA_ARCH, "layers": L, "experts": cfg.moe.n_experts,
           "params": n_params, "weight_bytes": weight_bytes, "init_s": init_s,
           "requests": JAMBA_BATCH, "prompt": JAMBA_PROMPT, "new_tokens": JAMBA_NEW,
           "generate_s": wall, "tokens_per_s": JAMBA_BATCH * JAMBA_NEW / wall,
           "free_before_bytes": free_before, "peak_bytes": peak,
           "peak_reserved_bytes": reserved, "launches": launches,
           "dropped_fraction": dropped, "kernel_errs": kernel_errs, "replayed_calls": n_kept,
           "prefill_s": statistics.median(prefill_s), "prefill_s_all": prefill_s,
           "decode_step_host_ms": [x * 1e3 for x in host],
           "decode_step_host_ms_median": statistics.median(host) * 1e3,
           "profiled": prof, "greedy_tokens_row0": tokens[0]}
    print(f"phase 19c: {JAMBA_ARCH} at full width, cut to {L} layers (one superblock; 72 "
          f"in full) "
          f"and {cfg.moe.n_experts} of 16 experts (top-{cfg.moe.top_k}): {n_params / 1e9:.2f} B "
          f"params, {weight_bytes / 2**30:.2f} GiB (bf16; A_log, dt_bias, D fp32), drawn on "
          f"the card in {init_s:.1f} s; ServeEngine(max_len={JAMBA_MAX_LEN}).generate of "
          f"{JAMBA_BATCH} x {JAMBA_PROMPT}-token prompts, {JAMBA_NEW} greedy tokens each, in "
          f"{wall:.3f} s ({out['tokens_per_s']:.1f} tokens/s); peak {peak / 2**30:.2f} GiB "
          f"({reserved / 2**30:.2f} reserved; {free_before / 2**30:.2f} of "
          f"{torch.cuda.mem_get_info()[1] / 2**30:.2f} free before the weights); "
          f"launches { {n: c for n, c in launches.items() if c} } (exact); a second generate "
          f"equal; dropped fraction prefill {dropped['prefill']:.4f}, decode steps max "
          f"{max(dropped['decode']):.4f}  [{card}]")
    print(f"phase 19c: prefill alone {out['prefill_s'] * 1e3:.1f} ms (host, median of 3: "
          f"{[round(x * 1e3, 1) for x in prefill_s]}); decode steps on the host median "
          f"{out['decode_step_host_ms_median']:.2f} ms ({[round(x * 1e3, 2) for x in host]})  "
          f"[{card}]")
    for name, c in prof.items():
        print(f"phase 19c: a profiled {name}: {c['host_ms']:.2f} ms host, {c['device_ms']:.3f} "
              f"ms of kernels in {c['launches']:.0f} launches; the Mamba mixers "
              f"{c['mamba']['launches']:.1%} of the launches, {c['mamba']['host']:.1%} of the "
              f"host time, {c['mamba']['device']:.1%} of the device time; top kernels (ms) "
              f"{c['top_kernels_ms']}  [{card}]")
    del params, eng, logits, cache, outs, again
    torch.cuda.empty_cache()
    return out


def jamba_train_vs_cpu(cfg, grad_tol, per_step: dict) -> dict:
    """One ``make_train_step`` (one microbatch, zero momentum in, no weight
    decay: the momentum out is the gradient) of ``cfg`` from seed-0
    weights on JAMBA_TRAIN_B x JAMBA_TRAIN_T tokens, on the card and on the
    port's CPU: the loss within LM_CPU_LOSS_TOL relative, every gradient
    leaf finite and within ``grad_tol`` of the CPU leaf's scale (None:
    reported); the card's step again from the same state bitwise.  Each of
    the card's two steps launches exactly ``per_step``.  Returns the
    distances and the card's launches over both steps, as counted."""
    cpu = bb.init_params(cfg, seed=0, device="cpu")
    params = tree_to(cpu, "cuda")
    step = make_train_step(cfg, InputShape("t", JAMBA_TRAIN_T, JAMBA_TRAIN_B, "train"),
                           n_micro_override=1)
    rng = np.random.RandomState(194)
    batch = {k: rng.randint(0, cfg.vocab, (JAMBA_TRAIN_B, JAMBA_TRAIN_T))
             for k in ("tokens", "labels")}
    counted = []
    for i in (1, 2):
        reset_counts()
        out = step(params, opt_init(params), batch)
        torch.cuda.synchronize()
        counted.append(slice11_counts())
        check_launches(counted[-1], per_step, f"phase 19d: {cfg.name} train step {i} of 2")
        if i == 1:
            p1, o1, m1 = out
    p2, o2, m2 = out
    launches = {n: sum(c[n] for c in counted) for n in counted[0]}
    check(torch.equal(m1["loss"], m2["loss"])
          and all(torch.equal(a, b) for a, b in zip(tree_leaves(p1) + tree_leaves(o1),
                                                    tree_leaves(p2) + tree_leaves(o2))),
          f"phase 19d: {cfg.name}'s train step again from the same state is not bitwise")
    _, oc, mc = step(cpu, opt_init(cpu), batch)
    loss_err = abs(float(m1["loss"]) - float(mc["loss"])) / abs(float(mc["loss"]))
    check(loss_err <= LM_CPU_LOSS_TOL, f"phase 19d: {cfg.name} loss card vs CPU {loss_err:.3e}")
    worst = 0.0
    for i, (a, b) in enumerate(zip(tree_leaves(o1["momentum"]), tree_leaves(oc["momentum"]))):
        e = (a.cpu().double() - b.double()).abs().max().item() / max(b.abs().max().item(), 1e-30)
        check(bool(torch.isfinite(a).all()) and (grad_tol is None or e <= grad_tol),
              f"phase 19d: {cfg.name} gradient leaf {i} card vs CPU {e:.3e} of scale")
        worst = max(worst, e)
    n_leaves = len(tree_leaves(oc["momentum"]))
    del params, p1, o1, p2, o2
    return {"loss": float(mc["loss"]), "loss_rel_err": loss_err, "grad_err": worst,
            "leaves": n_leaves, "launches": launches}


def jamba_vs_cpu(card) -> dict:
    """Phase 19d: reduced Jamba (one superblock, d 256, 4 experts top-2),
    fp32, seed-0 weights, the card against the port's CPU: prefill logits
    and greedy tokens (``card_vs_cpu``, phase 8's bars); one train step
    (``jamba_train_vs_cpu``, phase 14c's bars) of the same model routing
    to all 4 experts (no top-2 route can flip on an ulp), and of the top-2
    config with its leaves' distance reported; launches of each train step
    exact (remat runs each layer's forwards twice)."""
    cfg = get_config(JAMBA_ARCH).reduced()
    L, n_attn = cfg.n_layers, cfg.n_superblocks
    params = tree_to(bb.init_params(cfg, seed=0, device="cpu"), "cuda")
    prompts = np.random.RandomState(195).randint(0, cfg.vocab, (JAMBA_CPU_B, JAMBA_CPU_T))
    reset_counts()
    serve = card_vs_cpu(cfg, params, [Request(tokens=p, max_new_tokens=JAMBA_CPU_NEW)
                                      for p in prompts],
                        JAMBA_CPU_T + JAMBA_CPU_NEW, "phase 19d")
    serve_launches = slice11_counts()
    every = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, top_k=cfg.moe.n_experts))
    per_step = {"flash_attention": 2 * n_attn, "flash_attention_backward": n_attn,
                "rmsnorm": 4 * L + 1, "rmsnorm_backward": 2 * L + 1}
    train = {}
    for key, c, tol in (("top_k = n_experts", every, LM_CPU_GRAD_TOL), ("top-2", cfg, None)):
        train[key] = jamba_train_vs_cpu(c, tol, per_step)
        print(f"phase 19d: {c.name} top-{c.moe.top_k} of {c.moe.n_experts}, fp32: one "
              f"make_train_step on {JAMBA_TRAIN_B} x {JAMBA_TRAIN_T} tokens, card vs CPU: loss "
              f"{train[key]['loss_rel_err']:.3e} relative (bar {LM_CPU_LOSS_TOL}); every one of "
              f"{train[key]['leaves']} gradient leaves within {train[key]['grad_err']:.3e} of "
              f"its scale (bar {tol or 'none: reported'}); the step again bitwise; launches of "
              f"the two steps { {n: v for n, v in train[key]['launches'].items() if v} } "
              f"(each step exact)  [{card}]")
    launches = {n: serve_launches.get(n, 0) + sum(t["launches"].get(n, 0)
                                                  for t in train.values())
                for n in set(serve_launches)}
    return {"serve": serve, "train": train, "launches": launches}


def jamba_alone(card) -> dict:
    """Phase 19 (a)-(d) in a fresh child process of this script, which
    prints its lines and writes its numbers to a JSON file
    (``phase_jamba``)."""
    t0 = time.perf_counter()
    block = jamba_block(card)
    cfg = jamba_served_config()
    kernels = bf16_kernel_rows(  # phase 19b: G = 8, RMSNorm at its widest row
        JAMBA_BATCH, JAMBA_PROMPT, JAMBA_MAX_LEN, cfg.n_heads, cfg.n_kv_heads,
        cfg.resolved_head_dim, cfg.d_model, ((JAMBA_BATCH, JAMBA_PROMPT),), "phase 19b",
        torch.Generator(device="cuda").manual_seed(192), card)
    t_ab = time.perf_counter() - t0
    serve = jamba_serve(cfg, card)
    t_c = time.perf_counter() - t0 - t_ab
    vs_cpu = jamba_vs_cpu(card)
    return {"block": block, "kernels": kernels, "serve": serve, "vs_cpu": vs_cpu,
            "part_s": {"ab": t_ab, "c": t_c, "d": time.perf_counter() - t0 - t_ab - t_c}}


def phase_jamba(card) -> tuple:
    """Phase 19: ``jamba_alone`` in a fresh child process (the 66.3 GiB
    model wants an allocator the earlier phases never touched), started
    after phase 18's has ended; returns the launches of the kernels on its
    paths (the bf16 forwards of (c), the fp32 kernels of (d)), their
    largest errors, and the numbers.  The child's allocator maps its
    segments as they grow (``expandable_segments``): drawing the weights
    frees a float32 copy of each leaf after its bf16 cast, and fixed
    segments would keep those holes beside the 66 GiB."""
    torch.cuda.empty_cache()
    print(f"phase 19: this process holds {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"({torch.cuda.memory_reserved() / 2**30:.2f} reserved) of the card while its "
          f"child runs")
    sys.stdout.flush()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "jamba_alone.json")
        subprocess.run([sys.executable, os.path.abspath(__file__), "--jamba-alone", path],
                       check=True, timeout=JAMBA_ALONE_TIMEOUT_S,
                       env={**os.environ, "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
        with open(path) as f:
            jb = json.load(f)
    jb["phase_s"] = time.perf_counter() - t0
    launches = {n: jb["serve"]["launches"].get(n, 0) + jb["vs_cpu"]["launches"].get(n, 0)
                for n in set(jb["serve"]["launches"]) | set(jb["vs_cpu"]["launches"])}
    errs = {f"{n}_bf16": max([c["max_abs_err"] for c in jb["kernels"][n]]
                             + [jb["serve"]["kernel_errs"].get(n, 0.0)])
            for n in ("flash_attention", "decode_attention", "rmsnorm")}
    print(f"phase 19: {jb['phase_s']:.1f} s in a child process, by part "
          f"{ {k: round(v, 1) for k, v in jb['part_s'].items()} }")
    return launches, errs, jb


# ------------------------------------------------------------- phase 20 ---
def kernel_counts() -> dict:
    return {n: k.launches for n, k in _build.KERNELS.items()}


def nonzero(counts: dict) -> dict:
    return {n: c for n, c in counts.items() if c}


def launch_plain(cfg, params, card) -> dict:
    """20a: ``python -m repro_torch.launch.serve --arch qwen2-0.5b --tokens
    32`` at full width: launches from 0, exact; its greedy tokens against
    ``ServeEngine.generate`` on the same weights and prompt (phase 8's
    near-tie rule)."""
    kept, real = [], launch_serve.serve_plain

    def plain(cfg_, params_, batch, args, tel):
        out = real(cfg_, params_, batch, args, tel)
        kept.append((batch, out))
        return out

    launch_serve.serve_plain = plain
    reset_counts()
    t0 = time.perf_counter()
    try:
        rc = launch_serve.main(LAUNCH_PLAIN_ARGV)
    finally:
        launch_serve.serve_plain = real
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_counts()
    check(rc == 0 and len(kept) == 1, f"20a: the launcher returned {rc}")
    batch, got = kept[0]
    B, T = batch["tokens"].shape
    L, new = cfg.n_layers, LAUNCH_TOKENS
    expect = dict.fromkeys(_build.KERNELS, 0) | {
        "rmsnorm": (2 * L + 1) * (new + 1), "flash_attention": L,
        "decode_attention": L * new}
    check(launches == expect, f"20a: launches {nonzero(launches)}, expected {nonzero(expect)}")
    max_len = T + new + 8
    reqs = [Request(tokens=batch["tokens"][b].cpu().numpy(), max_new_tokens=new + 1)
            for b in range(B)]
    ref = ServeEngine(cfg, params, max_len=max_len).generate(reqs)
    ties = [near_tie(cfg, params, reqs[b].tokens, ref[b].tokens.tolist(), got[b].tolist(),
                     f"phase 20a: row {b}", max_len=max_len) for b in range(B)]
    print(f"phase 20a: launch.serve {' '.join(LAUNCH_PLAIN_ARGV)} at full width: "
          f"{B} x {T}-token prompt, {new + 1} greedy tokens a row in {wall:.2f} s with "
          f"the weights' draw; launches {nonzero(launches)} (exact); tokens equal "
          f"ServeEngine.generate's but at near-ties {ties}  [{card}]")
    return {"wall_s": wall, "launches": launches, "near_ties": ties}


def launch_queue(cfg, params, card, tmp, extra=(), tag="20b") -> dict:
    """20b: ``--queue 16 --lengths 64,256,512 --tokens 16 --prefix-cache
    --kv-tier-mb 8`` at full width with its metrics dump and trace, the
    prefix cache's hot budget cut to LAUNCH_HOT_PAGES so that its cold
    tier runs: launches from 0, exact against the forwards and page
    compressions; the same tokens as the same SchedulerConfig driven
    directly; JAX's gauge names in the dump; a Chrome trace with spans.
    ``extra``: more flags (phase 21a's mesh), which skip the direct run."""
    metrics, trace = os.path.join(tmp, "metrics.json"), os.path.join(tmp, "trace.json")
    engines, real_generate = [], ServeEngine.generate
    compressions, real_compress = [], PrefixCache._compress

    def generate(self, reqs):
        outs = real_generate(self, reqs)
        engines.append((self, reqs, [c.tokens.tolist() for c in outs]))
        return outs

    def compress(self, page):
        compressions.append(page.shape)
        return real_compress(self, page)

    ServeEngine.generate, PrefixCache._compress = generate, compress
    sched_cfg = launch_serve.SchedulerConfig
    launch_serve.SchedulerConfig = functools.partial(SchedulerConfig,
                                                     prefix_hot_pages=LAUNCH_HOT_PAGES)
    calls, unwrap = count_forwards()
    reset_counts()
    t0 = time.perf_counter()
    try:
        rc = launch_serve.main(LAUNCH_QUEUE_ARGV + list(extra) + [
            "--metrics-json", metrics, "--trace-out", trace])
    finally:
        ServeEngine.generate, PrefixCache._compress = real_generate, real_compress
        launch_serve.SchedulerConfig = sched_cfg
        unwrap()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_counts()
    check(rc == 0 and len(engines) == 1, f"{tag}: the launcher returned {rc}")
    eng, reqs, tokens = engines[0]
    expect = expected_launches(cfg, calls) | {"quantize": len(compressions)}
    check(launches == expect, f"{tag}: launches {nonzero(launches)}, expected "
          f"{nonzero(expect)} over forwards {calls}")
    check(launches["quantize"] > 0 and len(compressions) % 2 == 0,
          f"{tag}: the cold tier compressed {len(compressions)} K / V pages")
    with open(metrics) as f:
        dump = json.load(f)
    names = set(LAUNCH_QUEUE_GAUGES) - set(dump)
    check(not names, f"{tag}: the metrics dump lacks {sorted(names)}")
    check(dump["prefix.cold_pages"] > 0 and dump["prefix.page_hits"] > 0,
          f"{tag}: prefix stats { {k: v for k, v in dump.items() if k.startswith('prefix')} }")
    with open(trace) as f:
        events = [ev for ev in json.load(f)["traceEvents"] if ev["ph"] == "X"]
    check(events and all({"name", "ts", "dur", "tid"} <= set(ev) for ev in events),
          f"{tag}: the trace holds no Chrome-trace spans")
    numbers = {"wall_s": wall, "serve_wall_s": dump["serve.wall_s"],
               "tokens_per_s": dump["serve.tokens_per_s"], "forwards": calls,
               "launches": launches, "pages_compressed": len(compressions) // 2,
               "prefix": {k: v for k, v in dump.items() if k.startswith("prefix.")},
               "trace_spans": len(events), "tokens": tokens,
               "gathers": dump.get("sched.pool_gathers"),
               "gather_spans": sum(ev["name"] == "gather" for ev in events)}
    if extra:
        return numbers
    t1 = time.perf_counter()
    direct = ServeEngine(cfg, params, max_len=eng.max_len, scheduler=eng._sched_cfg).generate(reqs)
    direct_s = time.perf_counter() - t1
    check([c.tokens.tolist() for c in direct] == tokens,
          "20b: the launcher's tokens differ from its SchedulerConfig driven directly")
    generated = sum(map(len, tokens))
    print(f"phase 20b: launch.serve {' '.join(LAUNCH_QUEUE_ARGV)} (hot budget "
          f"{LAUNCH_HOT_PAGES} pages) at full width: {len(reqs)} requests of "
          f"{min(map(len, (r.tokens for r in reqs)))}-{max(map(len, (r.tokens for r in reqs)))} "
          f"tokens, {generated} generated in {dump['serve.wall_s']:.3f} s "
          f"({dump['serve.tokens_per_s']:.1f} tokens/s), {wall:.2f} s with the weights' draw; "
          f"forwards {calls}; launches {nonzero(launches)} (exact: {len(compressions)} "
          f"quantize launches at L = 256 for {len(compressions) // 2} pages); prefix "
          f"{ {k[7:]: v for k, v in dump.items() if k.startswith('prefix.')} }; "
          f"{len(events)} trace spans; the same SchedulerConfig driven directly "
          f"({direct_s:.2f} s) gives the same tokens  [{card}]")
    return {**numbers, "direct_s": direct_s}


def launch_stream(cfg, params, card, tmp) -> dict:
    """20c: ``--queue 16 --stream --max-queue 8 --priority mixed --preempt
    --journal J``: served + shed + rejected account for every request, and
    ``recover`` of the journal into a fresh frontend loses none."""
    journal = os.path.join(tmp, "journal.jsonl")
    frontends, real_run = [], StreamingFrontend.run

    def run(self):
        out = real_run(self)
        frontends.append((self, out))
        return out

    StreamingFrontend.run = run
    reset_counts()
    try:
        rc = launch_serve.main(LAUNCH_STREAM_ARGV + ["--journal", journal])
    finally:
        StreamingFrontend.run = real_run
    torch.cuda.synchronize()
    launches = kernel_counts()
    check(rc == 0 and len(frontends) == 1, f"20c: the launcher returned {rc}")
    fe, results = frontends[0]
    by = {s: sum(st == s for st, _ in results.values()) for s in ("served", "shed")}
    events = RequestJournal.read(journal)
    submitted = {rec["rid"] for rec in events if rec["ev"] == "submit"}
    rejected = LAUNCH_STREAM_REQS - len(submitted)
    check(by["served"] + by["shed"] == len(submitted) == len(results)
          and by["served"] > 0 and rejected >= 0,
          f"20c: {by} of {len(submitted)} admitted, {rejected} rejected")
    fresh = StreamingFrontend(cfg, params, sched=fe.sched.sched, max_len=fe.sched.max_len)
    merged = recover(fresh, events)
    lost = len(submitted - set(merged))
    check(lost == 0, f"20c: recovery lost {lost} journaled requests")
    check(all(np.asarray(merged[r][1]).tolist() == np.asarray(results[r][1]).tolist()
              for r in submitted),
          "20c: the recovered results differ from the run's")
    check(launches["decode_attention"] > 0 and launches["flash_attention"] > 0,
          f"20c: launches {nonzero(launches)}")
    print(f"phase 20c: launch.serve {' '.join(LAUNCH_STREAM_ARGV)} --journal J: "
          f"{LAUNCH_STREAM_REQS} requests -> {by['served']} served, {by['shed']} shed, "
          f"{rejected} rejected; {len(events)} journal events, recovered into a fresh "
          f"frontend with none lost; launches {nonzero(launches)}  [{card}]")
    return {"served": by["served"], "shed": by["shed"], "rejected": rejected,
            "journal_events": len(events), "lost": lost, "launches": launches}


def launch_gateway(card) -> dict:
    """20d: the two gateway runs through the launcher: every request
    resolved on the ladder, one offload_fused launch a fleet build."""
    reports, real_run = [], OffloadGateway.run

    def run(self):
        out = real_run(self)
        reports.append(out)
        return out

    out, total = {}, dict.fromkeys(_build.KERNELS, 0)
    OffloadGateway.run = run
    try:
        for argv in LAUNCH_GATEWAY_ARGVS:
            reset_counts()
            check(launch_serve.main(argv) == 0, f"20d: {argv} failed")
            torch.cuda.synchronize()
            launches = kernel_counts()
            report = reports[-1]
            n = int(argv[1]) * int(argv[argv.index("--requests") + 1]
                                   if "--requests" in argv else 4)
            resolved(report, n, f"20d: {' '.join(argv)}")
            check(launches == dict.fromkeys(_build.KERNELS, 0) | {"offload_fused": 1},
                  f"20d: launches {nonzero(launches)}, expected one offload_fused")
            summary = report.summary()
            out[" ".join(argv)] = {k: summary[k] for k in (
                "requests", "e2e_p50_ms", "e2e_p99_ms", "fallback_rate", "degraded_rate",
                "deadline_miss_rate", "clients_per_s")}
            total = {k: total[k] + launches[k] for k in total}
            print(f"phase 20d: launch.serve {' '.join(argv)}: {n} requests resolved on the "
                  f"ladder, one offload_fused launch; {out[' '.join(argv)]}  [{card}]")
    finally:
        OffloadGateway.run = real_run
    return {"runs": out, "launches": total}


def launch_training(card) -> dict:
    """20e: ``launch.train --local --steps 3`` for LAUNCH_TRAIN_ARCHS:
    finite losses, each run's launches counted (exact for the RMSNorm
    decoders, by ``lm_expected_launches``)."""
    out, total, real = {}, dict.fromkeys(_build.KERNELS, 0), launch_train.train
    for arch in LAUNCH_TRAIN_ARCHS:
        kept = []

        def train(*a, **kw):
            kept.append(real(*a, **kw))
            return kept[-1]

        launch_train.train = train
        reset_counts()
        t0 = time.perf_counter()
        try:
            rc = launch_train.main(["--arch", arch, "--local", "--steps",
                                    str(LAUNCH_TRAIN_STEPS)])
        finally:
            launch_train.train = real
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_counts()
        losses = kept[0]
        check(rc == 0 and len(losses) == LAUNCH_TRAIN_STEPS
              and all(math.isfinite(x) for x in losses), f"20e: {arch} losses {losses}")
        cfg = get_config(arch).reduced()
        if cfg.norm == "rmsnorm":
            expect = dict.fromkeys(_build.KERNELS, 0) | lm_expected_launches(
                cfg.n_layers, LAUNCH_TRAIN_STEPS)
            check(launches == expect, f"20e: {arch} launches {nonzero(launches)}, "
                  f"expected {nonzero(expect)}")
        check(launches["flash_attention"] > 0 and launches["flash_attention_backward"] > 0,
              f"20e: {arch} launches {nonzero(launches)}")
        out[arch] = {"losses": losses, "launches": nonzero(launches), "wall_s": wall}
        total = {k: total[k] + launches[k] for k in total}
        print(f"phase 20e: launch.train --arch {arch} --local --steps "
              f"{LAUNCH_TRAIN_STEPS}: losses {[round(x, 4) for x in losses]} in "
              f"{wall:.2f} s; launches {nonzero(launches)}  [{card}]")
    return {"archs": out, "launches": total}


def roofline_records(cfg, params, sizes) -> dict:
    """(fn, args, analytic shape, n_micro) of 20f's three steps: a prefill
    of (B, T), one decode step at (B, depth), a train step of (global
    batch, T) in n_micro microbatches, as ``sizes`` gives them; inputs
    drawn on the params' device from one seed (a CPU generator, so that
    the card and the CPU get the same inputs)."""
    dev = params["embed"]["table"].device
    gen = torch.Generator().manual_seed(20)

    def tokens(*shape):
        return torch.randint(0, cfg.vocab, shape, generator=gen).to(dev)

    (B, T), (Bd, depth), (Bt, Tt, n_micro) = sizes
    prefill_shape = InputShape("prefill", T, B, "prefill")
    decode_shape = InputShape("decode", depth, Bd, "decode")
    train_shape = InputShape("train_4k", Tt, Bt, "train")
    return {
        "prefill": (make_prefill_step(cfg, prefill_shape), (params, {"tokens": tokens(B, T)}),
                    prefill_shape, 1),
        "decode": (make_serve_step(cfg, decode_shape),
                   (params, tokens(Bd, 1), bb.init_cache(cfg, Bd, depth + 1, device=dev),
                    depth), decode_shape, 1),
        "train": (make_train_step(cfg, train_shape, n_micro_override=n_micro),
                  (params, opt_init(params), {"tokens": tokens(Bt, Tt),
                                              "labels": tokens(Bt, Tt)}),
                  train_shape, n_micro),
    }


def roofline_phase(cfg, params, card) -> dict:
    """20f: ``analyze_step`` of a prefill, a decode step and a train step of
    qwen2-0.5b at full width, each counted once in a run of its own, then
    timed by CUDA events (median of ROOF_REPS); the analytic estimate at
    MeshSpec(1, 1, 1) beside the count; and on reduced qwen2-0.5b the
    count on the card equal to the count on the port's CPU, exactly."""
    out = {}
    mesh = roof_analytic.MeshSpec(1, 1, 1)
    for name, (fn, args, shape, n_micro) in roofline_records(cfg, params, ROOF_SIZES).items():
        rec = roof.analyze_step(fn, *args)
        torch.cuda.synchronize()
        ms = time_ms(lambda: fn(*args), reps=ROOF_REPS)
        r = rec["roofline"]
        bound_ms = max(r["compute_s"], r["memory_s"]) * 1e3
        est_flops = roof_analytic.flops_estimate(cfg, shape)
        est_bytes = roof_analytic.memory_bytes_per_chip(cfg, shape, mesh, n_micro=n_micro)
        out[name] = {"flops": rec["flops"], "hbm_bytes": rec["hbm_bytes"],
                     "flops_by_type": rec["flops_by_type"],
                     "kernels": rec["kernels"], "compute_ms": r["compute_s"] * 1e3,
                     "memory_ms": r["memory_s"] * 1e3, "bound_ms": bound_ms,
                     "dominant": r["dominant"], "ms": ms, "share": bound_ms / ms,
                     "analytic_flops": est_flops, "analytic_bytes": est_bytes,
                     "flops_ratio": est_flops / rec["flops"],
                     "bytes_ratio": est_bytes / rec["hbm_bytes"]}
        print(f"phase 20f: roofline of the {name} step ({shape.global_batch} x "
              f"{shape.seq_len}, {cfg.name} full width, fp32, TF32 off): {rec['flops']:.4e} "
              f"flops ({ {k: f'{v:.4e}' for k, v in rec['flops_by_type'].items()} }), "
              f"{rec['hbm_bytes']:.4e} bytes; bound {bound_ms:.3f} ms by "
              f"{r['dominant'][:-2]} (compute {r['compute_s'] * 1e3:.3f}, memory "
              f"{r['memory_s'] * 1e3:.3f}); measured {ms:.3f} ms (CUDA events, median of "
              f"{ROOF_REPS}): {bound_ms / ms:.1%} of the bound; analytic flops_estimate "
              f"{est_flops:.4e} ({est_flops / rec['flops']:.3f}x the count), "
              f"memory_bytes_per_chip {est_bytes:.4e} ({est_bytes / rec['hbm_bytes']:.3f}x); "
              f"the kernels' share: { {k: v['calls'] for k, v in rec['kernels'].items()} } "
              f"calls  [{card}]")
        del rec
    small = get_config(LLM_ARCH).reduced()
    cpu = bb.init_params(small, seed=0, device="cpu")
    on_card = tree_to(cpu, "cuda")
    same = {}
    for name, (fn, args, _, _) in roofline_records(small, on_card, ROOF_SMALL).items():
        got = roof.analyze_step(fn, *args)
        want = roof.analyze_step(fn, *tree_to(list(args), "cpu"))
        if got != want:
            for part in ("kernels", "ops"):
                diff = {k: (got[part].get(k), want[part].get(k))
                        for k in set(got[part]) | set(want[part])
                        if got[part].get(k) != want[part].get(k)}
                print(f"phase 20f: {name} {part} card vs CPU: {diff}")
        check(got == want, f"20f: reduced {name}: the card counts {got['flops']} flops, "
              f"{got['hbm_bytes']} bytes, the CPU {want['flops']}, {want['hbm_bytes']}")
        same[name] = {"flops": got["flops"], "hbm_bytes": got["hbm_bytes"]}
    print(f"phase 20f: reduced {LLM_ARCH}: the card's count equals the CPU's exactly "
          f"for each step {same}")
    return {"full": out, "reduced_card_eq_cpu": same}


def run_examples(card) -> dict:
    """20g: each examples/torch_*.py's ``main`` with small arguments on the
    card; each returns (exit 0) and launches the kernels of its path."""
    here = os.path.dirname(os.path.abspath(__file__))
    out, total = {}, dict.fromkeys(_build.KERNELS, 0)
    with tempfile.TemporaryDirectory() as tmp:
        for name, (argv, kernels) in EXAMPLES.items():
            argv = [a.replace("TMP", tmp) for a in argv]
            spec = importlib.util.spec_from_file_location(
                name, os.path.join(here, "examples", f"{name}.py"))
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            reset_counts()
            t0 = time.perf_counter()
            module.main(argv)
            torch.cuda.synchronize()
            launches = kernel_counts()
            check(all(launches[k] > 0 for k in kernels),
                  f"20g: {name} launched {nonzero(launches)}, expected {kernels}")
            out[name] = {"s": time.perf_counter() - t0, "launches": nonzero(launches)}
            total = {k: total[k] + launches[k] for k in total}
            print(f"phase 20g: examples/{name}.py {' '.join(argv)}: exit 0 in "
                  f"{out[name]['s']:.2f} s; launches {out[name]['launches']}  [{card}]")
    return {"examples": out, "launches": total}


def phase_launch(cfg, params, card) -> tuple:
    """Phase 20: the launchers' ``main`` in this process, the roofline and
    the examples; returns (the launches of the driven paths, numbers)."""
    t_phase, part = time.perf_counter(), {}
    numbers = {}
    with tempfile.TemporaryDirectory() as tmp:
        for key, fn in (("a", lambda: launch_plain(cfg, params, card)),
                        ("b", lambda: launch_queue(cfg, params, card, tmp)),
                        ("c", lambda: launch_stream(cfg, params, card, tmp)),
                        ("d", lambda: launch_gateway(card)),
                        ("e", lambda: launch_training(card)),
                        ("f", lambda: roofline_phase(cfg, params, card)),
                        ("g", lambda: run_examples(card))):
            t0 = time.perf_counter()
            numbers[key] = fn()
            part[key] = time.perf_counter() - t0
            sys.stdout.flush()
    launches = dict.fromkeys(_build.KERNELS, 0)
    for rec in numbers.values():
        for n, c in rec.get("launches", {}).items():
            launches[n] += c
    numbers["part_s"] = part
    numbers["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 20: {numbers['phase_s']:.1f} s, by part "
          f"{ {k: round(v, 1) for k, v in part.items()} }")
    return launches, numbers


def step_times(fn, args, reps: int) -> tuple:
    """(host ms, card ms) of ``fn(*args)``, medians of ``reps`` calls: the
    host clock around the call (its enqueue), CUDA events around it."""
    host, dev = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        fn(*args)
        host.append((time.perf_counter() - t0) * 1e3)
        end.record()
        torch.cuda.synchronize()
        dev.append(start.elapsed_time(end))
    return statistics.median(host), statistics.median(dev)


def mesh_decode_step(cfg, params, card, plain_rec) -> dict:
    """21b: 20f's decode step (8 rows at depth 544) with its params, tokens
    and cache distributed on a one-rank (1, 1) NCCL mesh: ``analyze_step``
    counts 20f's flops and bytes exactly (its collectives as they come:
    none are expected on one rank), and every kernel's launches equal the
    mesh-less step's on the same inputs; then the meshed and the mesh-less
    step timed in turns (plain, meshed, meshed, plain), host and card ms."""
    from repro_torch.launch import partition
    from repro_torch.launch.mesh import make_serving_mesh, process_group

    fn, (p, tok, cache, depth), _, _ = roofline_records(cfg, params, ROOF_SIZES)["decode"]
    with process_group("nccl"):
        mesh = make_serving_mesh()
        mp = partition.distribute(p, partition.param_shardings(p, mesh, cfg=cfg))
        mt = partition.batch_spec(mesh, 2).distribute(tok)
        mc = partition.distribute(cache, partition.cache_shardings(
            cache, mesh, batch=tok.shape[0], cfg=cfg))
        reset_counts()
        roof.analyze_step(fn, p, tok, cache, depth)
        torch.cuda.synchronize()
        plain_launches = kernel_counts()
        reset_counts()
        rec = roof.analyze_step(fn, mp, mt, mc, depth, mesh=mesh)
        torch.cuda.synchronize()
        launches = kernel_counts()
        check(rec["flops"] == plain_rec["flops"] and rec["hbm_bytes"] == plain_rec["hbm_bytes"],
              f"21b: the meshed decode step counts {rec['flops']} flops, "
              f"{rec['hbm_bytes']} bytes; 20f's {plain_rec['flops']}, {plain_rec['hbm_bytes']}")
        check(launches == plain_launches and launches["decode_attention"] == cfg.n_layers,
              f"21b: the meshed step launched {nonzero(launches)}, the mesh-less "
              f"{nonzero(plain_launches)}")
        turns = {"plain": [], "meshed": []}
        for name in ("plain", "meshed", "meshed", "plain"):
            args = (p, tok, cache, depth) if name == "plain" else (mp, mt, mc, depth)
            turns[name].append(step_times(fn, args, MESH_STEP_REPS))
    r = rec["roofline"]
    out = {"flops": rec["flops"], "hbm_bytes": rec["hbm_bytes"],
           "collectives": rec["collectives"], "collective_s": r["collective_s"],
           "chips": r["chips"], "launches": launches, "turns_ms": turns}
    print(f"phase 21b: 20f's decode step (8 rows at depth 544, full width) on a (1, 1) "
          f"NCCL mesh: {rec['flops']:.4e} flops, {rec['hbm_bytes']:.4e} bytes (20f's, "
          f"exactly); collectives {rec['collectives']['counts']} "
          f"({rec['collectives']['total_bytes']} bytes), collective_s {r['collective_s']}; "
          f"launches {nonzero(launches)}; host / card ms (medians of {MESH_STEP_REPS}, in "
          f"turns plain, meshed, meshed, plain): plain {turns['plain']}, meshed "
          f"{turns['meshed']}  [{card}]")
    return out


def start_dryruns(tmp) -> list:
    """21c, started: each DRYRUN_ARGVS run of ``python -m
    repro_torch.launch.dryrun`` as a child process writing its record."""
    here = os.path.dirname(os.path.abspath(__file__))
    # meta tensors only: the children see no card
    env = dict(os.environ, PYTHONPATH=os.path.join(here, "src"), CUDA_VISIBLE_DEVICES="")
    runs = []
    for i, argv in enumerate(DRYRUN_ARGVS):
        out = os.path.join(tmp, f"dryrun{i}.json")
        runs.append((argv, out, time.perf_counter(), subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *argv, "--out", out],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    return runs


def finish_dryruns(runs, card) -> dict:
    """21c: each dry-run child exits 0 within DRYRUN_TIMEOUT_S with an OK
    line and a record (per-rank argument and output bytes, the roofline
    terms, the collectives by kind), whose counter saw the collectives
    DTensor issues inside its operators: the weights' all-gathers and the
    partial sums' all-reduces of a tensor-parallel step."""
    out = {}
    for argv, path, t0, proc in runs:
        try:
            stdout, stderr = proc.communicate(timeout=max(1.0, DRYRUN_TIMEOUT_S
                                                         - (time.perf_counter() - t0)))
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        wall = time.perf_counter() - t0
        check(proc.returncode == 0 and "OK    " in stdout,
              f"21c: dryrun {' '.join(argv)} exited {proc.returncode}: {stdout[-800:]} "
              f"{stderr[-2000:]}")
        with open(path) as f:
            rec = json.load(f)[0]
        key = " ".join(argv)
        counts = rec["collectives"]["counts"]
        check(counts["all-gather"] > 0 and counts["all-reduce"] > 0,
              f"21c: dryrun {key} counted the collectives {counts}")
        out[key] = {"wall_s": wall, "lower_s": rec["lower_s"], "compile_s": rec["compile_s"],
                    "memory": rec["memory"], "flops": rec["flops"],
                    "hbm_bytes": rec["hbm_bytes"], "collectives": rec["collectives"],
                    "roofline": rec["roofline"]}
        r = rec["roofline"]
        print(f"phase 21c: python -m repro_torch.launch.dryrun {key} (torch "
              f"{torch.__version__}, meta tensors, fake process group, no card): mesh "
              f"{rec['mesh']}, {rec['kind']}, lower {rec['lower_s']} s, compile "
              f"{rec['compile_s']} s, {wall:.1f} s with start-up; per rank "
              f"{rec['memory']['argument_bytes']} argument / {rec['memory']['output_bytes']} "
              f"output bytes; {rec['flops']:.4e} flops, {rec['hbm_bytes']:.4e} bytes, "
              f"collectives {rec['collectives']['counts']} ({rec['collectives']['total_bytes']} "
              f"bytes); roofline compute {r['compute_s']:.4g} s, memory {r['memory_s']:.4g} s, "
              f"collective {r['collective_s']:.4g} s over {r['chips']} ranks  [{card}]")
    return out


def phase_mesh(cfg, params, card, launch_numbers) -> tuple:
    """Phase 21: mesh sharding on one rank; returns (the launches of the
    driven paths, numbers)."""
    t_phase, part = time.perf_counter(), {}
    numbers = {}
    with tempfile.TemporaryDirectory() as tmp:
        runs = start_dryruns(tmp)
        try:
            t0 = time.perf_counter()
            plain = launch_numbers["b"]
            meshed = launch_queue(cfg, params, card, tmp, extra=MESH_ARGV, tag="21a")
            check(meshed["tokens"] == plain["tokens"],
                  "21a: the (1, 1) mesh's tokens differ from 20b's")
            check(meshed["launches"] == plain["launches"],
                  f"21a: launches {nonzero(meshed['launches'])}, 20b's "
                  f"{nonzero(plain['launches'])}")
            check(meshed["gathers"] and meshed["gather_spans"] == meshed["gathers"],
                  f"21a: {meshed['gathers']} pool gathers, {meshed['gather_spans']} spans")
            print(f"phase 21a: launch.serve {' '.join(LAUNCH_QUEUE_ARGV + MESH_ARGV)} (hot "
                  f"budget {LAUNCH_HOT_PAGES} pages) on one NCCL rank: 20b's tokens "
                  f"bitwise; launches {nonzero(meshed['launches'])} (20b's exactly); "
                  f"{meshed['gathers']} pool gathers (one a round, each a trace span); "
                  f"serve {meshed['serve_wall_s']:.3f} s ({meshed['tokens_per_s']:.1f} "
                  f"tokens/s) against 20b's {plain['serve_wall_s']:.3f} s "
                  f"({plain['tokens_per_s']:.1f}), {meshed['wall_s']:.2f} s with the "
                  f"weights' draw  [{card}]")
            numbers["a"] = {k: v for k, v in meshed.items() if k != "tokens"}
            part["a"] = time.perf_counter() - t0
        finally:
            t0 = time.perf_counter()
            numbers["c"] = finish_dryruns(runs, card)
            part["c_wait"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        numbers["b"] = mesh_decode_step(cfg, params, card, launch_numbers["f"]["full"]["decode"])
        part["b"] = time.perf_counter() - t0
    launches = dict.fromkeys(_build.KERNELS, 0)
    for rec in (numbers["a"], numbers["b"]):
        for n, c in rec["launches"].items():
            launches[n] += c
    numbers["part_s"] = part
    numbers["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 21: {numbers['phase_s']:.1f} s, by part "
          f"{ {k: round(v, 1) for k, v in part.items()} }")
    return launches, numbers


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the full record as JSON here")
    ap.add_argument("--lm-alone", metavar="JSON",
                    help="only time phase 14's backward kernels alone by torch.profiler "
                         "(the kernels built already) and write the numbers here")
    ap.add_argument("--moe-alone", metavar="JSON",
                    help="only run phase 16 (moonshot-v1-16b-a3b in bf16; the kernels "
                         "built already) and write the numbers here")
    ap.add_argument("--moe-train-alone", metavar="JSON",
                    help="only run phase 17 (moonshot-v1-16b-a3b trained in bf16; the "
                         "kernels built already) and write the numbers here")
    ap.add_argument("--xlstm-alone", metavar="JSON",
                    help="only run phase 18 (xlstm-350m served and trained; the kernels "
                         "built already) and write the numbers here")
    ap.add_argument("--jamba-alone", metavar="JSON",
                    help="only run phase 19 (jamba-1.5-large-398b served at full width "
                         "and trained reduced; the kernels built already) and write the "
                         "numbers here")
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
    if args.lm_alone:
        with open(args.lm_alone, "w") as f:
            json.dump(lm_alone(card), f)
        return 0
    if args.moe_alone:
        with open(args.moe_alone, "w") as f:
            json.dump(moe_alone(card), f)
        return 0
    if args.moe_train_alone:
        with open(args.moe_train_alone, "w") as f:
            json.dump(moe_train_alone(card), f)
        return 0
    if args.xlstm_alone:
        with open(args.xlstm_alone, "w") as f:
            json.dump(xlstm_alone(card), f)
        return 0
    if args.jamba_alone:
        with open(args.jamba_alone, "w") as f:
            json.dump(jamba_alone(card), f)
        return 0
    print(f"phase 1: card: {card}")
    t0 = time.perf_counter()
    libs = _build.build(_build.sources())
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
    prefix_launches, prefix = phase_prefix(llm_cfg, llm_params, card)
    lm_launches, lm_kernel_rows, lm = phase_lm(llm_cfg, llm_params, card)
    s11_launches, s11_errs, s11 = phase_slice11(llm_cfg, llm_params, card)
    for row in rows:               # the kernels' launches over every path
        row["launches"] += (gw_launches[row["name"]]
                            + train_launches.get(row["name"], 0)
                            + sched_launches.get(row["name"], 0)
                            + prefix_launches[row["name"]]
                            + lm_launches.get(row["name"], 0))
        row["max_abs_err"] = max(row["max_abs_err"],
                                 sched["kernel_errs"].get(row["name"], 0.0),
                                 prefix["kernel_errs"].get(row["name"], 0.0),
                                 lm["checks"]["errs"].get(row["name"], 0.0))
    rows += lm_kernel_rows
    for row in rows:               # and over slice 11's paths
        row["launches"] += s11_launches.get(row["name"], 0)
        row["max_abs_err"] = max(row["max_abs_err"], s11_errs.get(row["name"], 0.0))
    moe_rows, moe = phase_moe(card)
    rows += moe_rows
    mt_rows, mt_forwards, moe_train_numbers = phase_moe_train(card)
    for row in rows:               # the bf16 forwards' launches on slice 14's path
        row["launches"] += mt_forwards.get(row["name"], 0)
    rows += mt_rows
    xl_launches, xl_errs, xlstm_numbers = phase_xlstm(card)
    for row in rows:               # the fp32 RMSNorm kernels on slice 16's paths
        row["launches"] += xl_launches.get(row["name"], 0)
        row["max_abs_err"] = max(row["max_abs_err"], xl_errs.get(row["name"], 0.0))
    jb_launches, jb_errs, jamba_numbers = phase_jamba(card)
    for row in rows:               # the bf16 forwards and fp32 kernels on slice 17's paths
        row["launches"] += jb_launches.get(row["name"], 0)
        row["max_abs_err"] = max(row["max_abs_err"], jb_errs.get(row["name"], 0.0))
    lc_launches, launch_numbers = phase_launch(llm_cfg, llm_params, card)
    for row in rows:               # the launchers' and examples' paths (slice 18)
        row["launches"] += lc_launches.get(row["name"], 0)
    mesh_launches, mesh_numbers = phase_mesh(llm_cfg, llm_params, card, launch_numbers)
    for row in rows:               # the meshed queue and decode step (slice 19)
        row["launches"] += mesh_launches.get(row["name"], 0)

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
                       "train": train, "scheduler": sched, "prefix": prefix,
                       "lm": lm, "slice11": s11, "moe": moe,
                       "moe_train": moe_train_numbers, "xlstm": xlstm_numbers,
                       "jamba": jamba_numbers, "launch": launch_numbers,
                       "mesh": mesh_numbers},
                      f, indent=1)
    print(f"chip_smoke: phases 1-21 in {time.perf_counter() - t_start:.1f} s "
          f"(phase 12 {sched['phase_s']:.1f} s, phase 15 {s11['phase_s']:.1f} s, "
          f"phase 16 {moe['phase_s']:.1f} s, phase 17 {moe_train_numbers['phase_s']:.1f} s, "
          f"phase 18 {xlstm_numbers['phase_s']:.1f} s, phase 19 "
          f"{jamba_numbers['phase_s']:.1f} s, phase 20 {launch_numbers['phase_s']:.1f} s, "
          f"phase 21 {mesh_numbers['phase_s']:.1f} s)")
    print(f"card: {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
