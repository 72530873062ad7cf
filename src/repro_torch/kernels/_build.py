"""Build and load the port's CUDA kernels.

Each ``repro_torch/csrc/<name>.cu`` is compiled by nvcc for ``sm_90a`` into
its own shared library with a plain C interface, at first use, and loaded
with ``ctypes``.  A library may export more than one entry point: the
bf16 halves of RMSNorm and decode attention (``<name>_bf16_launch``) live
in their fp32 kernel's source, each a ``CudaKernel`` of its own with its
own launch count; flash attention's bf16 half, a kernel of another
design, has a source of its own (``flash_attention_bf16.cu``).  A library is named by a hash of the sources and flags,
under ``build/kernels/`` at the repository root, so an edited source is
rebuilt and an unchanged one is not.  Nothing here runs when a module is
imported: the first CUDA tensor handed to a kernel wrapper builds it.
``build()`` compiles several sources at once, one nvcc process each.

Without nvcc, or when a build fails, ``build`` raises: there is no
fallback from a kernel to its plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600

# every CudaKernel, by name: the registry of launch counts
KERNELS: dict[str, "CudaKernel"] = {}


def sources() -> list[str]:
    """The sources (``csrc/<name>.cu``) of every registered kernel."""
    return sorted({k.library for k in KERNELS.values()})


def find_nvcc() -> str | None:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        nvcc = str(cand) if cand.exists() else None
    return nvcc


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built: keyed by the source, the shared
    headers and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names) -> dict[str, Path]:
    """Compile every named source that is not built yet, all at once.

    Returns {name: library path}.  Raises RuntimeError without nvcc or on
    a failed build; each build's compiler output (registers, shared
    memory, spills) is kept beside its library as ``.log``."""
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME): cannot build "
                           f"the CUDA kernels {sorted(todo)}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for n, p in todo.items():
            tmp = p.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp)
        failed = []
        for n, (proc, tmp) in procs.items():
            out, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
            todo[n].with_suffix(".log").write_text(out)
            if proc.returncode != 0:
                failed.append(f"{n} (nvcc exit {proc.returncode}):\n{out}")
                continue
            os.replace(tmp, todo[n])
        if failed:
            raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    finally:
        for proc, tmp in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return paths


def check_operand(t, what: str, dtype, device=None) -> None:
    """Raise ValueError unless ``t`` is a contiguous CUDA tensor of
    ``dtype`` (one dtype, or a tuple of those the kernel takes; on
    ``device`` when given): what the kernels take.  The type is checked
    before the device, so a wrong dtype is named as such on any device."""
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{what}: the CUDA kernel takes a CUDA tensor, got "
                         f"{type(t)}")
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        raise ValueError(f"{what}: the CUDA kernel takes "
                         f"{' or '.join(map(str, dtypes))}, got {t.dtype}")
    if not t.is_cuda:
        raise ValueError(f"{what}: the CUDA kernel takes a CUDA tensor, got "
                         f"{t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: the CUDA kernel takes a contiguous tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")


# the element types of the forward kernels, and where their backward
# kernels' bf16 halves wait
FORWARD_DTYPES = (torch.float32, torch.bfloat16)
BF16_BACKWARD_ITEM = ("ROADMAP Queue 1 item 6(d) (MoE training, with the "
                      "bf16 backward kernels)")


def refuse_bf16_backward(t, what: str) -> None:
    """Raise NotImplementedError for a bf16 tensor handed to a backward
    kernel, or to a forward under a gradient: the backward kernels take
    float32 only."""
    if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16:
        raise NotImplementedError(
            f"{what}: the backward kernels take float32; their bf16 halves "
            f"wait for {BF16_BACKWARD_ITEM}")


def check_aligned(t, what: str) -> None:
    """Raise ValueError unless ``t``'s data starts on a 16-byte boundary,
    as the kernels' 16-byte copies need.  A contiguous view at an odd
    offset can miss it; nothing here copies it into place."""
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: the CUDA kernel takes 16-byte aligned data, "
                         f"got an address {t.data_ptr() % 16} bytes past it")


def perm_array(perm, C: int):
    """The static channel permutation as a C int array, checked: C entries
    (C <= 64), each in [0, C)."""
    perm = tuple(int(p) for p in perm)
    if len(perm) != C or not 1 <= C <= 64 or not all(0 <= p < C for p in perm):
        raise ValueError(f"perm must hold C={C} (<= 64) channel indices in "
                         f"[0, C), got {perm}")
    return (ctypes.c_int * C)(*perm)


class CudaKernel:
    """One kernel's C entry point ``<name>_launch`` in the library built
    from ``csrc/<library>.cu`` (``library`` defaults to ``name``), and its
    launch count.

    The C entry enqueues the kernel on the stream it is given and returns
    ``cudaGetLastError()``; a non-zero code raises here, since a refused
    launch never runs and a later synchronize would not report it."""

    def __init__(self, name: str, argtypes: list, library: str | None = None):
        self.name = name
        self.library = library or name
        self.argtypes = argtypes
        self.launches = 0
        self._lib = None
        self._fn = None
        KERNELS[name] = self

    def _load(self):
        self._lib = ctypes.CDLL(str(build([self.library])[self.library]))
        fn = getattr(self._lib, f"{self.name}_launch")
        fn.argtypes = self.argtypes + [ctypes.c_void_p]     # + stream
        fn.restype = ctypes.c_int
        self._lib.kernel_error_string.argtypes = [ctypes.c_int]
        self._lib.kernel_error_string.restype = ctypes.c_char_p
        self._fn = fn

    def launch(self, *args, stream: int) -> None:
        if self._fn is None:
            self._load()
        rc = self._fn(*args, ctypes.c_void_p(stream))
        if rc != 0:
            msg = self._lib.kernel_error_string(rc).decode()
            raise RuntimeError(f"{self.name}: kernel launch failed: CUDA "
                               f"error {rc} ({msg})")
        self.launches += 1
