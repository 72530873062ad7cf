"""The flash-attention backward kernel against an earlier version of its
source, on one GPU, in one process.

    python3 scripts/flash_backward_ab.py --parent DIR [--out chiprun_out/flash_ab.json]

DIR is a checkout of the earlier commit (``git archive <commit> | tar -x
-C DIR``) whose ``src/repro_torch/csrc/flash_attention_backward.cu`` has
the C entry point without q_offset and kv_valid_len (the fp32 SIMT
kernel).  It is built with the same nvcc flags as the port's kernels into
``build/ab/`` and loaded beside the current one.  At qwen2-0.5b's training
microbatch (q (4, 4096, 14, 64), k/v (4, 4096, 2, 64)) and at qwen2-1.5b's
heads (q (2, 2048, 12, 128), k/v (2, 2048, 2, 128)), causal, each version
is timed by CUDA events (``chip_smoke.time_ms``: L2 flushed, median of
REPS) in the order earlier, current, current, earlier, with SDPA's
backward (heads expanded) as the yardstick; the two versions' gradients
must agree within 1e-4 of each gradient's largest magnitude.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.attention.kernel import (  # noqa: E402
    flash_attention_backward_cuda,
    flash_attention_cuda,
)

REPS = 10
TOL = 1e-4
SHAPES = ((4, 4096, 14, 2, 64), (2, 2048, 12, 2, 128))   # B, T = S, Hq, Hkv, D


def load_earlier(parent: Path):
    """The earlier source's ``flash_attention_backward_launch``, built here."""
    csrc = parent / "src" / "repro_torch" / "csrc"
    out = ROOT / "build" / "ab" / "flash_attention_backward_earlier.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    log = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc),
                          "-o", str(out), str(csrc / "flash_attention_backward.cu")],
                         capture_output=True, text=True, timeout=_build.BUILD_TIMEOUT_S)
    if log.returncode != 0:
        raise RuntimeError(f"nvcc failed on the earlier source:\n{log.stdout}{log.stderr}")
    regs = [line.strip() for line in (log.stdout + log.stderr).splitlines()
            if "registers" in line]
    fn = ctypes.CDLL(str(out)).flash_attention_backward_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 7 + [I] * 8 + [ctypes.c_float, P, P, P, P]
    fn.restype = ctypes.c_int

    def backward(q, k, v, o, do, lse):
        B, T, Hq, D = q.shape
        S, Hkv = k.shape[1], k.shape[2]
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        dvec = torch.empty((B, Hq, T), dtype=torch.float32, device=q.device)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                lse.data_ptr(), dvec.data_ptr(), B, T, S, Hq, Hkv, D, 1, 0,
                1.0 / math.sqrt(D), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"earlier flash backward: CUDA error {rc}")
        return dq, dk, dv
    return backward, regs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="a checkout of the earlier commit")
    ap.add_argument("--out", help="also write the record as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_backward_ab: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    earlier, regs = load_earlier(args.parent)
    gen = torch.Generator(device="cuda").manual_seed(15)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    record = {"card": card, "earlier_registers": regs, "cases": []}
    for B, T, Hq, Hkv, D in SHAPES:
        q = torch.randn(B, T, Hq, D, generator=gen, device="cuda")
        k, v = (torch.randn(B, T, Hkv, D, generator=gen, device="cuda") for _ in range(2))
        do = torch.randn(B, T, Hq, D, generator=gen, device="cuda")
        o, lse = flash_attention_cuda(q, k, v, return_lse=True)
        new = flash_attention_backward_cuda(q, k, v, o, do, lse)
        old = earlier(q, k, v, o, do, lse)
        torch.cuda.synchronize()
        diff = {}
        for name, a, b in zip(("dq", "dk", "dv"), new, old):
            diff[name] = ((a - b).abs().max() / b.abs().max()).item()
            chip_smoke.check(diff[name] <= TOL, f"{(B, T, Hq, Hkv, D)}: {name} of the "
                             f"two versions {diff[name]:.3e} of scale apart")
        qt = q.transpose(1, 2).contiguous().requires_grad_()
        kt = k.repeat_interleave(Hq // Hkv, 2).transpose(1, 2).contiguous().requires_grad_()
        vt = v.repeat_interleave(Hq // Hkv, 2).transpose(1, 2).contiguous().requires_grad_()
        ot = sdpa(qt, kt, vt, is_causal=True)
        dot = do.transpose(1, 2).contiguous()
        times = {"earlier": [], "current": []}
        for which in ("earlier", "current", "current", "earlier"):
            fn = ((lambda: earlier(q, k, v, o, do, lse)) if which == "earlier" else
                  (lambda: flash_attention_backward_cuda(q, k, v, o, do, lse)))
            times[which].append(chip_smoke.time_ms(fn, reps=REPS))
        sdpa_ms = chip_smoke.time_ms(lambda: torch.autograd.grad(
            ot, (qt, kt, vt), dot, retain_graph=True), reps=REPS)
        case = {"shape": (B, T, T, Hq, Hkv, D), "causal": True, "ms": times,
                "sdpa_backward_ms": sdpa_ms, "rel_diff": diff}
        record["cases"].append(case)
        print(f"flash_backward_ab {case['shape']}: earlier {times['earlier']} ms, "
              f"current {times['current']} ms, SDPA backward {sdpa_ms:.4f} ms; "
              f"gradients apart by {diff} of scale  [{card}]", flush=True)
        del q, k, v, do, o, lse, new, old, qt, kt, vt, ot, dot
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
