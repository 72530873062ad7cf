"""The fp32 / bf16 RMSNorm forward and the quantizer against an earlier
version of their sources, on one GPU, in one process.

    python3 scripts/rmsnorm_quantize_ab.py --parent DIR [--out ab.json]

DIR is a checkout of the earlier commit (``git archive <commit> | tar -x
-C DIR``) with ``src/repro_torch/csrc/{rmsnorm,quantize}.cu`` exporting
``rmsnorm_launch``, ``rmsnorm_bf16_launch`` and ``quantize_launch``.  Each
is built with the port's nvcc flags into ``build/ab/`` and loaded beside
the current kernels, and so are two builds of the current quantize.cu
with the search's threshold moved (``kSearchMinCenters`` 2: the search
at every sorted L; 257: the scan at every L).

Checked first: each current kernel within its bar of its plain version
(RMSNorm fp32 ``chip_smoke.rms_fp32_bars``, bf16 within 2e-2 and bitwise
the fp32 kernel on the widened inputs, rounded; quantize bitwise), the
earlier RMSNorm within 2e-5 of the current one, the earlier quantizer and
both variants bitwise the current one.  Then each version is timed by
CUDA events (``chip_smoke.time_ms``: L2 flushed, median of REPS) in the
order earlier, current, current, earlier, beside ``F.rms_norm``,
``x.clone()`` (the same bytes moved by one PyTorch copy) and the byte
bound, at the rows of ``RMS_ROWS`` / ``BF16_ROWS`` and the quantizer
at L = 256 on one full-width qwen2-0.5b K page and at L = 8 on phase 5's
remote features; then the scan against the search at L in ``SWEEP_L``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from chip_smoke import check, time_ms  # noqa: E402
from repro_torch.compress.quantize import linspace_f32  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.quantize.kernel import quantize_cuda  # noqa: E402
from repro_torch.kernels.quantize.ref import quantize_ref  # noqa: E402
from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402

REPS = 30
TOL = 2e-5
BF16_TOL = 2e-2
# fp32 rows: qwen2-0.5b's prefill (8 x 512) and a decode step (8), xLSTM's
# train_4k rows, the cut steps' and a decode step; bf16: moonshot's
# prefill and decode rows, jamba's (the kernel's widest)
RMS_ROWS = ((4096, 896), (8, 896), (8192, 1024), (2048, 1024), (1024, 1024), (8, 1024))
BF16_ROWS = ((2048, 2048), (8, 2048), (2048, 8192), (8, 8192))
PAGE = (24, 32, 2, 64)          # a K page: layers, tokens, kv heads, head dim
REMOTE = (147_456, 19)          # phase 5: N = 256 * 24 * 24 rows, C - k = 19
SWEEP_L = (4, 8, 12, 16, 17, 24, 32, 64, 256)


def build_lib(src: Path, include: Path, name: str):
    out = ROOT / "build" / "ab" / f"{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    log = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(include),
                          "-o", str(out), str(src)],
                         capture_output=True, text=True, timeout=_build.BUILD_TIMEOUT_S)
    if log.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{log.stdout}{log.stderr}")
    regs = [line.strip() for line in (log.stdout + log.stderr).splitlines()
            if "registers" in line or "Compiling entry" in line]
    return ctypes.CDLL(str(out)), regs


def rms_fn(lib, entry: str):
    fn = getattr(lib, entry)
    P = ctypes.c_void_p
    fn.argtypes = [P, P, ctypes.c_longlong, ctypes.c_int, ctypes.c_float, P, P]
    fn.restype = ctypes.c_int

    def call(x, scale):
        y = torch.empty_like(x)
        rc = fn(x.data_ptr(), scale.data_ptr(), x.shape[0], x.shape[1], 1e-6,
                y.data_ptr(), torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"{entry}: CUDA error {rc}")
        return y
    return call


def quantize_fn(lib):
    fn = lib.quantize_launch
    P = ctypes.c_void_p
    fn.argtypes = [P, P, ctypes.c_longlong, ctypes.c_int, P, P, P]
    fn.restype = ctypes.c_int

    def call(x, centers):
        idx = torch.empty(x.shape, dtype=torch.int32, device=x.device)
        deq = torch.empty_like(x)
        rc = fn(x.data_ptr(), centers.data_ptr(), x.numel(), centers.numel(),
                idx.data_ptr(), deq.data_ptr(), torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"quantize_launch: CUDA error {rc}")
        return idx, deq
    return call


def in_turns(earlier, current) -> dict:
    times = {"earlier": [], "current": []}
    for which in ("earlier", "current", "current", "earlier"):
        times[which].append(time_ms(earlier if which == "earlier" else current, reps=REPS))
    return times


def equal(a, b) -> bool:
    return all(torch.equal(u, v) for u, v in zip(a, b))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="a checkout of the earlier commit")
    ap.add_argument("--out", help="also write the record as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rmsnorm_quantize_ab: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    csrc = args.parent / "src" / "repro_torch" / "csrc"
    here = _build.CSRC
    rms_lib, rms_regs = build_lib(csrc / "rmsnorm.cu", csrc, "rmsnorm_earlier")
    q_lib, q_regs = build_lib(csrc / "quantize.cu", csrc, "quantize_earlier")
    variants, variant_regs = {}, {}
    source = (here / "quantize.cu").read_text()
    check("kSearchMinCenters = 17;" in source, "quantize.cu: no kSearchMinCenters = 17")
    for name, lmin in (("search", 2), ("scan", 257)):
        src = ROOT / "build" / "ab" / f"quantize_{name}.cu"
        src.parent.mkdir(parents=True, exist_ok=True)
        src.write_text(source.replace("kSearchMinCenters = 17;", f"kSearchMinCenters = {lmin};"))
        lib, variant_regs[name] = build_lib(src, here, f"quantize_{name}")
        variants[name] = quantize_fn(lib)
    old_rms, old_rms_bf16 = rms_fn(rms_lib, "rmsnorm_launch"), rms_fn(rms_lib, "rmsnorm_bf16_launch")
    old_q = quantize_fn(q_lib)
    libs = _build.build(["rmsnorm", "quantize"])
    current_regs = {n: [line.strip() for line in p.with_suffix(".log").read_text().splitlines()
                        if "registers" in line or "Compiling entry" in line]
                    for n, p in libs.items()}
    record = {"card": card, "registers": {"earlier_rmsnorm": rms_regs, "earlier_quantize": q_regs,
                                          "current": current_regs, "variants": variant_regs},
              "rmsnorm": [], "rmsnorm_bf16": [], "quantize": [], "sweep": []}
    print(f"rmsnorm_quantize_ab: registers {json.dumps(record['registers'])}  [{card}]",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(30)
    rms_lib_fn = torch.nn.functional.rms_norm

    for N, d in RMS_ROWS:
        x = torch.randn((N, d), generator=gen, device="cuda") * 3
        scale = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        bars = chip_smoke.rms_fp32_bars(x, scale, f"ab: rmsnorm at ({N}, {d})")
        diff = (old_rms(x, scale) - rmsnorm_cuda(x, scale)).abs().max().item()
        check(diff <= TOL * 3, f"ab: rmsnorm ({N}, {d}): earlier and current {diff} apart")
        bound_ms, _ = chip_smoke.bound((2 * N * d + d) * 4, 4 * N * d)
        row = {"shape": [N, d], **bars, "earlier_vs_current": diff,
               "ms": in_turns(lambda: old_rms(x, scale), lambda: rmsnorm_cuda(x, scale)),
               "library_ms": time_ms(lambda: rms_lib_fn(x, (d,), scale, 1e-6), reps=REPS),
               "plain_ms": time_ms(lambda: rmsnorm_ref(x, scale), reps=REPS),
               "copy_ms": time_ms(x.clone, reps=REPS), "bound_ms": bound_ms}
        record["rmsnorm"].append(row)
        print(f"ab: rmsnorm fp32 ({N}, {d}): earlier {row['ms']['earlier']} ms, current "
              f"{row['ms']['current']} ms, F.rms_norm {row['library_ms']:.4f}, plain "
              f"{row['plain_ms']:.4f}, x.clone() {row['copy_ms']:.4f}, bound "
              f"{bound_ms:.4f}; |err| vs float64 "
              f"{bars['err_float64']:.3e} (F.rms_norm {bars['library_err_float64']:.3e})  "
              f"[{card}]", flush=True)

    for N, d in BF16_ROWS:
        x = (torch.randn((N, d), generator=gen, device="cuda") * 3).to(torch.bfloat16)
        scale = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(torch.bfloat16)
        got = rmsnorm_cuda(x, scale)
        check(torch.equal(got, rmsnorm_cuda(x.float(), scale.float()).to(torch.bfloat16)),
              f"ab: rmsnorm bf16 ({N}, {d}) is not the fp32 kernel on the widened inputs")
        err = chip_smoke.close_err(got, rmsnorm_ref(x, scale), BF16_TOL, f"ab: bf16 ({N}, {d})")
        bound_ms, _ = chip_smoke.bf16_bound((2 * N * d + d) * 2, 4 * N * d)
        row = {"shape": [N, d], "max_abs_err": err,
               "earlier_vs_current": (old_rms_bf16(x, scale).float() - got.float()).abs().max().item(),
               "ms": in_turns(lambda: old_rms_bf16(x, scale), lambda: rmsnorm_cuda(x, scale)),
               "library_ms": time_ms(lambda: rms_lib_fn(x, (d,), scale, 1e-6), reps=REPS),
               "copy_ms": time_ms(x.clone, reps=REPS), "bound_ms": bound_ms}
        record["rmsnorm_bf16"].append(row)
        print(f"ab: rmsnorm bf16 ({N}, {d}): earlier {row['ms']['earlier']} ms, current "
              f"{row['ms']['current']} ms, F.rms_norm {row['library_ms']:.4f}, x.clone() "
              f"{row['copy_ms']:.4f}, bound {bound_ms:.4f}  [{card}]", flush=True)

    page = torch.randn(PAGE, generator=gen, device="cuda").reshape(-1) * 2
    remote = torch.randn(REMOTE, generator=gen, device="cuda") * 3
    lo, hi = (float(v) for v in torch.aminmax(page))
    for name, x, c in (("L = 256, one K page", page, linspace_f32(256, lo, hi)),
                       ("L = 8, phase 5's remote features", remote, linspace_f32(8, -4.0, 4.0))):
        c = torch.from_numpy(c).cuda()
        got = quantize_cuda(x, c)
        check(equal(got, quantize_ref(x, c)) and equal(got, old_q(x, c))
              and all(equal(got, v(x, c)) for v in variants.values()),
              f"ab: quantize on {name}: the versions differ")
        n, L = x.numel(), c.numel()
        row = {"case": name, "n": n, "L": L,
               "ms": in_turns(lambda: old_q(x, c), lambda: quantize_cuda(x, c)),
               "bound_ms": chip_smoke.bound(12 * n, 0)[0],
               "scan_ops_bound_ms": chip_smoke.bound(0, 3 * L * n)[0]}
        record["quantize"].append(row)
        print(f"ab: quantize {name} ({n} values): earlier {row['ms']['earlier']} ms, current "
              f"{row['ms']['current']} ms, byte bound {row['bound_ms']:.4f}, the scan's "
              f"operations {row['scan_ops_bound_ms']:.4f}  [{card}]", flush=True)

    for L in SWEEP_L:
        for name, x in (("page", page), ("remote", remote)):
            lo, hi = (float(v) for v in torch.aminmax(x))
            c = torch.from_numpy(linspace_f32(L, lo, hi)).cuda()
            check(equal(variants["scan"](x, c), variants["search"](x, c)),
                  f"ab: scan and search differ at L = {L} on {name}")
            times = {"scan": [], "search": []}
            for which in ("scan", "search", "search", "scan"):
                times[which].append(time_ms(lambda: variants[which](x, c), reps=REPS))
            record["sweep"].append({"L": L, "x": name, "n": x.numel(), "ms": times})
            print(f"ab: L = {L} on {name} ({x.numel()} values): scan {times['scan']} ms, "
                  f"search {times['search']} ms  [{card}]", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
