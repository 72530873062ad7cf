"""The convolution's backward on one GPU: autograd's own (``F.conv2d``)
against ``repro_torch.nn.linear._Conv2d`` (backward made of
``conv_transpose2d`` and the weight-only ``convolution_backward``), on the
AgileNN training steps at full widths.

    python3 scripts/conv_backward_ab.py [--out chiprun_out/conv_ab.json]

Every conv of ``repro_torch.models.cnn`` is forced to one path for a run:
``native`` calls ``F.conv2d`` under autograd, ``function`` calls
``_Conv2d.apply``.  Cases: a stage-C joint step (the first-order outer
backward and the second derivative through the reference NN's IG passes)
and a stage-A step (first order only), at 96^2 and at 32^2; and the
no-grad forward of the reference NN at B = 1 (the host's cost of the
Function where no gradient is taken).  Each case runs native, function,
function, native, a warm-up and TIMED steps each; the record holds every
step's host-clock time, the median by path, one step's kernels and
device time by torch.profiler, and the largest difference between the
two paths' updated params (relative to the leaf's largest |value|).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import fp32_math, tree_leaves, tree_to, value_and_grad  # noqa: E402
from repro_torch.configs.agilenn_cifar import AgileNNConfig  # noqa: E402
from repro_torch.core.agile import cross_entropy, init_agile_params  # noqa: E402
from repro_torch.data.synthetic import ImageDatasetSpec, SyntheticImages  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.nn import linear  # noqa: E402
from repro_torch.optim.sgd import sgd_init, sgd_update  # noqa: E402
from repro_torch.train.agile_pipeline import joint_step  # noqa: E402

TIMED = 3
CASES = (("joint", 96, 8), ("joint", 32, 64), ("stage_a", 96, 32),
         ("stage_a", 32, 64), ("no_grad_forward", 32, 1))


def forced_conv2d(path: str):
    """``linear.conv2d`` with the path fixed: ``F.conv2d`` or ``_Conv2d``."""
    def conv2d(params, x, *, stride: int = 1, groups: int = 1):
        w, b = params["w"], params.get("b")
        ph = linear.same_pads(x.shape[1], w.shape[2], stride)
        pw = linear.same_pads(x.shape[2], w.shape[3], stride)
        xc = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
        if path == "native":
            y = F.conv2d(xc, w, b, stride=stride, groups=groups)
        else:
            y = linear._Conv2d.apply(xc, w, b, stride, groups)
        return y.permute(0, 2, 3, 1)
    return conv2d


def make_case(kind: str, size: int, batch: int):
    """(step() -> tree of updated params or outputs) for one case."""
    cfg = AgileNNConfig(image_size=size)
    params = init_agile_params(cfg, seed=0, device="cuda")
    mapping = tuple(int(p) for p in np.random.RandomState(0).permutation(
        cfg.extractor_channels))
    params.pop("mapping")
    ref = tree_to(cnn.reference_nn_init(
        torch.Generator().manual_seed(1), cfg.extractor_channels, cfg.n_classes,
        width=cfg.reference_width, blocks=cfg.reference_blocks), "cuda")
    images, labels = SyntheticImages(ImageDatasetSpec(
        image_size=size, seed=0)).batch(batch, seed=3)
    x = torch.as_tensor(images, device="cuda")
    y = torch.as_tensor(labels, device="cuda").long()
    if kind == "joint":
        opt, ref_opt = sgd_init(params), sgd_init(ref)

        def step():
            p, _, r, _, _, _ = joint_step(cfg, params, opt, ref, ref_opt, x, y,
                                          mapping=mapping, lr=0.02)
            return {"p": p, "r": r}
    elif kind == "stage_a":
        sa = {"ex": params["extractor"], "ref": ref}
        sa_opt = sgd_init(sa)

        def step():
            (_, _), grads = value_and_grad(lambda p: (cross_entropy(
                cnn.reference_nn_apply(p["ref"], cnn.extractor_apply(p["ex"], x)),
                y), None), sa)
            return sgd_update(sa, grads, sa_opt, lr=0.05)[0]
    else:
        feats = cnn.extractor_apply(params["extractor"], x)

        def step():
            with torch.no_grad():
                return cnn.reference_nn_apply(ref, feats)
    return step


def run_path(step, path: str, reps: int):
    cnn.conv2d = forced_conv2d(path)
    times = []
    with fp32_math():
        out = step()
        torch.cuda.synchronize()
        for _ in range(reps):
            t0 = time.perf_counter()
            out = step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    return times, out


def profile_step(step, path: str):
    from torch.profiler import ProfilerActivity, profile
    cnn.conv2d = forced_conv2d(path)
    with fp32_math(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    n, us = 0, 0.0
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            total = getattr(evt, "device_time_total", None)
            us += total if total is not None else evt.cuda_time_total
            n += evt.count
    return n, us


def worst_diff(a, b) -> float:
    worst = 0.0
    for u, v in zip(tree_leaves(a), tree_leaves(b)):
        scale = max(v.abs().max().item(), 1e-30)
        worst = max(worst, (u - v).abs().max().item() / scale)
    return worst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the record as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("conv_backward_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    saved = cnn.conv2d
    rows = []
    try:
        for kind, size, batch in CASES:
            step = make_case(kind, size, batch)
            reps = TIMED * (20 if kind == "no_grad_forward" else 1)
            times, outs = {"native": [], "function": []}, {}
            for path in ("native", "function", "function", "native"):
                t, outs[path] = run_path(step, path, reps)
                times[path] += t
            prof = {path: profile_step(step, path) for path in ("native", "function")}
            row = {"case": kind, "image_size": size, "batch": batch,
                   "step_s": times,
                   "median_ms": {p: statistics.median(t) * 1e3 for p, t in times.items()},
                   "kernels": {p: n for p, (n, _) in prof.items()},
                   "device_ms": {p: us / 1e3 for p, (_, us) in prof.items()},
                   "paths_max_rel_diff": worst_diff(outs["function"], outs["native"]),
                   "peak_bytes": torch.cuda.max_memory_allocated()}
            rows.append(row)
            print(f"{kind} at {size}^2, B = {batch}: median ms native "
                  f"{row['median_ms']['native']:.3f} / function "
                  f"{row['median_ms']['function']:.3f} (host clock); kernels "
                  f"{row['kernels']}, device ms "
                  f"{ {p: round(v, 3) for p, v in row['device_ms'].items()} }; "
                  f"paths differ by {row['paths_max_rel_diff']:.2e}  [{card}]", flush=True)
            del step, outs
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    finally:
        cnn.conv2d = saved
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    print(json.dumps({"card": card, "median_ms": {
        f"{r['case']}_{r['image_size']}_B{r['batch']}": r["median_ms"] for r in rows}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
