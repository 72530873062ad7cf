"""Rules of the PyTorch port: it imports neither JAX nor the JAX package,
its entry points run on CUDA unless the CPU is asked for, and importing
its kernel modules builds nothing."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_entry_points_raise_without_cuda_unless_cpu_is_named(monkeypatch):
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs.agilenn_cifar import gateway_demo_config
    from repro_torch.core.agile import init_agile_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = gateway_demo_config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_agile_params(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"quant": {"centers": [0.0, 1.0]}})
    p = init_agile_params(cfg, 0, device="cpu")
    assert p["quant"]["centers"].device.type == "cpu"


def test_kernel_modules_import_and_run_on_cpu_without_building():
    """In a fresh interpreter with no nvcc to be found, every module under
    repro_torch.kernels imports and every op runs on CPU tensors, and no
    kernel library is built or loaded."""
    code = r"""
import importlib, pkgutil
import torch
import repro_torch.kernels._build as b

def refuse(*a, **k):
    raise AssertionError("a kernel was built")

b.build = refuse
assert b.find_nvcc() is None
import repro_torch.kernels as K
for m in pkgutil.walk_packages(K.__path__, "repro_torch.kernels."):
    importlib.import_module(m.name)
from repro_torch.kernels.offload_fused.ops import fused_offload
from repro_torch.kernels.quantize.ops import quantize_op
from repro_torch.kernels.topk_split.ops import split_op
x, c = torch.randn(3, 4, 24), torch.linspace(-2, 2, 8)
fused_offload(x, c, perm=tuple(range(24))[::-1], k=5)
quantize_op(x, c)
split_op(x, perm=tuple(range(24)), k=5)
assert sorted(b.KERNELS) == ["offload_fused", "quantize", "topk_split"]
assert all(k._lib is None and k.launches == 0 for k in b.KERNELS.values())
print("ok")
"""
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    env["PATH"] = os.path.dirname(sys.executable)
    env["CUDA_HOME"] = str(ROOT / "no-cuda-here")
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["offload_fused", "quantize", "topk_split"])
    assert not any(tmp_path.iterdir())
