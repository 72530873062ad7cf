"""Multi-pod dry-run: build and run every (architecture x input shape)
step once on the production meshes, on ``meta`` tensors over torch's
``fake`` process group, and dump memory / roofline / collective analyses.
The port of ``repro.launch.dryrun``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out results.json]

The JAX package forces 512 host devices before JAX starts and lowers each
step with XLA; torch runs one process a rank, so here this process is
rank 0 of a fake group of 256 (or 512) ranks whose collectives move
nothing, the params, optimizer state, batch and cache are meta DTensors
in the JAX package's placements (``launch/steps.py::lower_step``), and
"compiling" runs the step once under ``roofline.analysis``'s counter:
nothing is allocated.  The mesh is a cuda mesh, as the card's NCCL ranks
are, so that DTensor plans their collectives (an all-to-all where a cpu
mesh gathers the whole tensor and keeps a chunk), and no card is needed.  The memory block holds one rank's argument and
output bytes (its local blocks); the temporaries and the peak, which
torch does not know without running, are null.  ``collectives_by_shape``
lists the collectives' calls and bytes by kind and output shape and dtype,
which name what they moved (an expert block, a cache, a row of
activations).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.configs.shapes import SHAPES, get_shape
from repro_torch.launch.mesh import PRODUCTION, make_production_mesh, process_group
from repro_torch.launch.steps import OPTIMIZED_STRATEGIES, lower_step

# documented skips: the enc-dec audio family has no meaningful 500k-token
# autoregressive decode
SKIPS = {("whisper-tiny", "long_500k"): "enc-dec audio: bounded decoder; see DESIGN.md"}


def _mesh_name(multi_pod: bool) -> str:
    return "x".join(map(str, PRODUCTION[multi_pod][0]))


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            skip_compile: bool = False, optimized: bool = False) -> dict:
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    shape_, _ = PRODUCTION[multi_pod]
    ranks = 1
    for s in shape_:
        ranks *= s
    strategy = OPTIMIZED_STRATEGIES.get((arch, shape_name)) if optimized else None
    with process_group("fake", world_size=ranks):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cuda")
        t0 = time.time()
        lowered, meta = lower_step(cfg, shape, mesh, strategy=strategy)
        t_lower = time.time() - t0
        rec = {"arch": arch, "shape": shape_name, "mesh": _mesh_name(multi_pod),
               "kind": meta["kind"], "lower_s": round(t_lower, 1),
               "strategy": "optimized" if strategy is not None else "baseline"}
        if skip_compile:
            return rec
        t0 = time.time()
        compiled = lowered.compile()
        rec["compile_s"] = round(time.time() - t0, 1)
    rec["memory"] = compiled.memory_analysis()
    a = compiled.analysis
    rec.update({"flops": a["flops"], "hbm_bytes": a["hbm_bytes"],
                "collectives": a["collectives"], "roofline": a["roofline"],
                "collectives_by_shape": a["collectives_by_shape"]})
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-compile", action="store_true",
                    help="specs and placements only (fast sanity sweep)")
    ap.add_argument("--optimized", action="store_true",
                    help="use OPTIMIZED_STRATEGIES for their (arch, shape) pairs")
    args = ap.parse_args(argv)

    archs = ASSIGNED_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    pairs = [(a, s) for a in archs for s in shapes]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results = []
    failures = 0
    for multi_pod in meshes:
        for a, s in pairs:
            if (a, s) in SKIPS:
                results.append({"arch": a, "shape": s, "mesh": _mesh_name(multi_pod),
                                "skipped": SKIPS[(a, s)]})
                print(f"SKIP  {a:24s} {s:12s} ({SKIPS[(a, s)]})")
                continue
            try:
                rec = run_one(a, s, multi_pod=multi_pod,
                              skip_compile=args.skip_compile,
                              optimized=args.optimized)
                results.append(rec)
                mem = rec.get("memory", {}).get("argument_bytes")
                mem_s = f"args/rank {mem / 2**30:.2f}GiB" if mem else ""
                print(f"OK    {a:24s} {s:12s} mesh={rec['mesh']} "
                      f"lower={rec['lower_s']}s "
                      f"compile={rec.get('compile_s', '-')}s {mem_s}")
            except Exception as e:  # noqa: BLE001 - a sweep reports every pair
                failures += 1
                results.append({"arch": a, "shape": s, "mesh": _mesh_name(multi_pod),
                                "error": f"{type(e).__name__}: {e}"})
                print(f"FAIL  {a:24s} {s:12s}: {type(e).__name__}: {e}")
                traceback.print_exc(limit=3)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
