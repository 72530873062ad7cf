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
# every kernel of the port, by the name of its csrc/<name>.cu
KERNEL_NAMES = ["decode_attention", "flash_attention", "flash_attention_backward",
                "flash_attention_backward_bf16", "flash_attention_bf16",
                "offload_fused", "quantize", "rmsnorm", "rmsnorm_backward",
                "topk_split"]
# the bf16 halves that are entry points of their fp32 kernels' libraries
# (flash attention's and its backward's have sources of their own, in
# KERNEL_NAMES)
BF16_NAMES = ["decode_attention_bf16", "rmsnorm_backward_bf16", "rmsnorm_bf16"]
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
    from repro_torch.bridge import backbone_params_from_numpy, params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.configs.agilenn_cifar import gateway_demo_config
    from repro_torch.core.agile import init_agile_params
    from repro_torch.models.backbone import init_cache, init_params
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.gateway import Fleet, OffloadGateway, mixed_fleet
    from repro_torch.serve.scheduler import ContinuousScheduler

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = gateway_demo_config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_agile_params(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"quant": {"centers": [0.0, 1.0]}})
    p = init_agile_params(cfg, 0, device="cpu")
    assert p["quant"]["centers"].device.type == "cpu"
    specs = mixed_fleet(2, n_requests=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Fleet(cfg, init_agile_params(cfg, 0), specs)
    fleet = Fleet(cfg, p, specs)
    assert fleet.device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OffloadGateway(cfg, init_agile_params(cfg, 0), fleet)
    assert len(OffloadGateway(cfg, p, fleet).run().traces) == 2

    from repro_torch.data.synthetic import ImageDatasetSpec, SyntheticImages
    from repro_torch.train.agile_pipeline import pretrain_reference, run_full_pipeline

    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_full_pipeline(cfg, pretrain_steps=0, joint_steps=0)
    data = SyntheticImages(ImageDatasetSpec(image_size=cfg.image_size))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pretrain_reference(cfg, data, steps=0)
    ex, ref, _ = pretrain_reference(cfg, data, steps=0, device="cpu")
    assert ex["convs"][0]["w"].device.type == "cpu"

    llm = get_config("qwen2-0.5b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(llm, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(llm, 1, 8)
    params = init_params(llm, 0, device="cpu")
    assert params["blocks"][0]["attn"]["wq"]["w"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(llm, params)
    assert ServeEngine(llm, params, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousScheduler(llm, params, max_len=32)
    sched = ContinuousScheduler(llm, params, max_len=32, device="cpu")
    assert sched.device.type == "cpu"
    assert sched._pool["cache"]["k"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        backbone_params_from_numpy({"embed": {"table": [[0.0]]}, "blocks": []},
                                   llm)

    from repro_torch.serve.frontend import StreamingFrontend

    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingFrontend(llm, params, max_len=32)
    fe = StreamingFrontend(llm, params, max_len=32, device="cpu")
    assert fe.sched.device.type == "cpu"
    assert fe.sched._pool["cache"]["k"].device.type == "cpu"


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
from repro_torch.kernels.attention.ops import flash_attention_op
from repro_torch.kernels.decode_attention.ops import decode_attention_op
from repro_torch.kernels.offload_fused.ops import fused_offload
from repro_torch.kernels.quantize.ops import quantize_op
from repro_torch.kernels.rmsnorm.ops import rmsnorm_op
from repro_torch.kernels.topk_split.ops import split_op
x, c = torch.randn(3, 4, 24), torch.linspace(-2, 2, 8)
fused_offload(x, c, perm=tuple(range(24))[::-1], k=5)
quantize_op(x, c)
split_op(x, perm=tuple(range(24)), k=5)
rmsnorm_op(torch.randn(5, 64), torch.ones(64))
q, kv = torch.randn(2, 9, 4, 64), torch.randn(2, 9, 2, 64)
flash_attention_op(q, kv, kv, window=4, kv_valid_len=torch.tensor([9, 3]))
decode_attention_op(q[:, :1], kv, kv, torch.tensor([9, 3]))
assert sorted(b.KERNELS) == sorted(KERNEL_NAMES + BF16_NAMES), sorted(b.KERNELS)
assert b.sources() == KERNEL_NAMES, b.sources()
assert all(b.KERNELS[n].library == n for n in KERNEL_NAMES)
assert all(b.KERNELS[n].library == n[:-len("_bf16")] for n in BF16_NAMES)
assert all(k._lib is None and k.launches == 0 for k in b.KERNELS.values())
print("ok")
"""
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    env["PATH"] = os.path.dirname(sys.executable)
    env["CUDA_HOME"] = str(ROOT / "no-cuda-here")
    env["PYTHONPATH"] = str(ROOT / "src")
    code = f"KERNEL_NAMES = {KERNEL_NAMES!r}\nBF16_NAMES = {BF16_NAMES!r}\n" + code
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(KERNEL_NAMES)
    assert not any(tmp_path.iterdir())


def test_every_kernel_has_its_source():
    assert sorted(p.stem for p in (ROOT / "src" / "repro_torch" / "csrc")
                  .glob("*.cu")) == KERNEL_NAMES


def _llm_wrapper_calls(dtype=torch.float32, D=64, where="cpu"):
    from repro_torch.kernels.attention.kernel import (
        flash_attention_backward_cuda,
        flash_attention_cuda,
    )
    from repro_torch.kernels.decode_attention.kernel import decode_attention_cuda
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_backward_cuda, rmsnorm_cuda

    x = torch.zeros(4, 96, dtype=dtype, device=where)
    q = torch.zeros(2, 5, 4, D, dtype=dtype, device=where)
    kv = torch.zeros(2, 7, 2, D, dtype=dtype, device=where)
    lse = torch.zeros(2, 4, 5, dtype=dtype, device=where)
    return {
        "rmsnorm": lambda: rmsnorm_cuda(x, torch.ones(96, dtype=dtype)),
        "flash_attention": lambda: flash_attention_cuda(q, kv, kv),
        "decode_attention": lambda: decode_attention_cuda(q[:, :1], kv, kv, 3),
        "rmsnorm_backward": lambda: rmsnorm_backward_cuda(
            x, torch.ones(96, dtype=dtype), x),
        "flash_attention_backward": lambda: flash_attention_backward_cuda(
            q, kv, kv, q, q, lse),
    }


@pytest.mark.parametrize("call", ["rmsnorm", "flash_attention", "decode_attention",
                                  "rmsnorm_backward", "flash_attention_backward"])
def test_llm_wrappers_refuse_cpu_tensors(call):
    """Handed a CPU tensor, a kernel wrapper raises before it builds or
    launches anything: only ``ops.py`` picks the plain version."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        _llm_wrapper_calls()[call]()


@pytest.mark.parametrize("call", ["rmsnorm", "flash_attention", "decode_attention",
                                  "rmsnorm_backward", "flash_attention_backward"])
def test_llm_wrappers_refuse_other_dtypes(call):
    with pytest.raises(ValueError, match="float32"):
        _llm_wrapper_calls(dtype=torch.float64)[call]()


@pytest.mark.parametrize("call", ["flash_attention", "decode_attention",
                                  "flash_attention_backward"])
@pytest.mark.parametrize("D", [32, 96])
def test_attention_wrappers_refuse_other_head_dims(call, D):
    with pytest.raises(ValueError, match="D in"):
        _llm_wrapper_calls(D=D)[call]()


def test_decode_wrapper_refuses_wide_groups():
    from repro_torch.kernels.decode_attention.kernel import decode_attention_cuda

    q, kv = torch.zeros(1, 1, 17, 64), torch.zeros(1, 4, 1, 64)
    with pytest.raises(ValueError, match="G <= 16"):
        decode_attention_cuda(q, kv, kv, 2)


def test_check_aligned_refuses_views_off_16_bytes():
    """The flash and permute wrappers call check_aligned: their kernels copy
    16 bytes at a time, and a misaligned view is refused, never copied."""
    from repro_torch.kernels._build import check_aligned

    base = torch.zeros(64)
    check_aligned(base, "x")
    check_aligned(base[4:], "x")
    for off in (1, 2, 3, 5):
        with pytest.raises(ValueError, match="16-byte aligned"):
            check_aligned(base[off:], "x")
