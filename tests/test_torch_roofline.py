"""The port's roofline (``repro_torch.roofline``) on the CPU.

- ``analytic``: every count (``active_param_count``, ``total_param_count``,
  ``model_flops``, ``flops_estimate``, ``memory_bytes_per_chip``,
  ``collective_bytes_per_chip``, the strategy and analytic records) equals
  the JAX package's exactly for the ten assigned archs at the four shapes
  on two meshes; each seconds term is its count over the H100's constant;
  JAX's direction tests (``tests/test_roofline.py``) hold on the H100's
  peaks too.
- ``analysis.analyze_step``: each dispatcher's reported work equals the
  formula worked out here at three shapes (live pairs by brute force over
  the mask); the operators inside a reported call are not counted; a
  function without kernels counts FlopCounterMode's flops, a gather or
  scatter the rows it moves; a reduced
  prefill and a train step count the same on two runs, with the kernels'
  calls that the path makes; while counting, the CPU's train step gives
  the plain path's loss and new params within 1e-6 of each leaf's scale
  (the plain bodies inside the autograd Functions sum their gradients in
  another order: measured 5e-7 on reduced qwen2-0.5b).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.shapes import SHAPES as JAX_SHAPES  # noqa: E402
from repro.roofline import analysis as janalysis  # noqa: E402
from repro.roofline import analytic as janalytic  # noqa: E402
from repro_torch import tree_leaves  # noqa: E402
from repro_torch.configs import ASSIGNED_ARCHS, get_config  # noqa: E402
from repro_torch.configs.shapes import SHAPES, get_shape  # noqa: E402
from repro_torch.kernels.attention.ops import flash_attention_op  # noqa: E402
from repro_torch.kernels.decode_attention.ops import decode_attention_op  # noqa: E402
from repro_torch.kernels.offload_fused.ops import fused_offload  # noqa: E402
from repro_torch.kernels.quantize.ops import quantize_op  # noqa: E402
from repro_torch.kernels.rmsnorm.ops import rmsnorm_op  # noqa: E402
from repro_torch.kernels.topk_split.ops import channel_permute_op  # noqa: E402
from repro_torch.launch.steps import make_prefill_step, make_train_step, opt_init  # noqa: E402
from repro_torch.models import backbone as bb  # noqa: E402
from repro_torch.roofline import analysis, analytic  # noqa: E402

SHAPE_NAMES = sorted(SHAPES)
MESHES = ((16, 16, 1), (1, 1, 1))


# ------------------------------------------------------------- analytic ---
@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_analytic_counts_equal_jax(arch, shape):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    sh, jsh = get_shape(shape), JAX_SHAPES[shape]
    assert analysis.active_param_count(cfg) == janalysis.active_param_count(jcfg)
    assert analytic.total_param_count(cfg) == janalytic.total_param_count(jcfg)
    assert analysis.model_flops(cfg, sh) == janalysis.model_flops(jcfg, jsh)
    assert analytic.flops_estimate(cfg, sh) == janalytic.flops_estimate(jcfg, jsh)
    for dims in MESHES:
        mesh, jmesh = analytic.MeshSpec(*dims), janalytic.MeshSpec(*dims)
        for kw in ({}, {"n_micro": 4}, {"fsdp_serve": True}):
            assert (analytic.memory_bytes_per_chip(cfg, sh, mesh, **kw)
                    == janalytic.memory_bytes_per_chip(jcfg, jsh, jmesh, **kw))
            assert (analytic.collective_bytes_per_chip(cfg, sh, mesh, **kw)
                    == janalytic.collective_bytes_per_chip(jcfg, jsh, jmesh, **kw))
            rec = analytic.analytic_roofline(cfg, sh, mesh, **kw)
            jrec = janalytic.analytic_roofline(jcfg, jsh, jmesh, **kw)
            for k in ("flops", "hbm_bytes_per_chip", "collective_bytes_per_chip", "chips"):
                assert rec[k] == jrec[k], k
            assert rec["compute_s"] == rec["flops"] / (mesh.chips * analysis.PEAK_FLOPS)
            assert rec["memory_s"] == rec["hbm_bytes_per_chip"] / analysis.HBM_BW
            assert rec["collective_s"] == rec["collective_bytes_per_chip"] / analysis.LINK_BW
            assert rec["dominant"] == max(("compute_s", "memory_s", "collective_s"),
                                          key=rec.get)
    for kw in ({}, {"tp": 1, "fsdp": False, "replicated_params": True},
               {"tp": 256, "fsdp": False}, {"n_micro": 4, "expert_resident": True}):
        rec = analytic.strategy_roofline(cfg, sh, **kw)
        jrec = janalytic.strategy_roofline(jcfg, jsh, **kw)
        assert rec["flops"] == jrec["flops"]
        # each term's count, recovered from the H100's and the v5e's constants
        for term, peak, jpeak in (("compute_s", analysis.PEAK_FLOPS, janalysis.PEAK_FLOPS),
                                  ("memory_s", analysis.HBM_BW, janalysis.HBM_BW),
                                  ("collective_s", analysis.LINK_BW, janalysis.ICI_BW)):
            assert rec[term] * peak == pytest.approx(jrec[term] * jpeak, rel=1e-12, abs=0.0)


def test_h100_constants():
    """The H100 SXM's published dense peaks (700 W) and the type rule."""
    assert (analysis.PEAK_FLOPS, analysis.PEAK_FLOPS_TF32, analysis.PEAK_FLOPS_FP32,
            analysis.HBM_BW, analysis.LINK_BW) == (989e12, 495e12, 67e12, 3.35e12, 450e9)
    assert analysis.peak_flops(torch.bfloat16) == 989e12
    tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        assert analysis.peak_flops(torch.float32) == 67e12
        torch.backends.cuda.matmul.allow_tf32 = True
        assert analysis.peak_flops(torch.float32) == 495e12
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _h1():
    cfg, sh = get_config("qwen2-0.5b"), get_shape("train_4k")
    base = analytic.strategy_roofline(cfg, sh, tp=16, fsdp=True, n_micro=1)
    opt = analytic.strategy_roofline(cfg, sh, tp=1, fsdp=False,
                                     replicated_params=True, n_micro=1)
    assert opt["step_s_bound"] < base["step_s_bound"] / 3


def _h2():
    cfg, sh = get_config("arctic-480b"), get_shape("train_4k")
    base = analytic.strategy_roofline(cfg, sh, tp=16, fsdp=True, n_micro=16)
    opt = analytic.strategy_roofline(cfg, sh, tp=16, fsdp=True, n_micro=4,
                                     expert_resident=True)
    assert opt["step_s_bound"] < base["step_s_bound"] / 5


def _h3():
    cfg, sh = get_config("jamba-1.5-large-398b"), get_shape("decode_32k")
    base = analytic.strategy_roofline(cfg, sh, tp=16, fsdp=True)
    opt = analytic.strategy_roofline(cfg, sh, tp=256, fsdp=False)
    assert opt["step_s_bound"] < base["step_s_bound"] / 20


def _param_counts():
    assert 3e8 < analytic.total_param_count(get_config("qwen2-0.5b")) < 8e8
    assert 4e10 < analytic.total_param_count(get_config("mixtral-8x7b")) < 6e10
    assert 2.5e11 < analytic.total_param_count(get_config("jamba-1.5-large-398b")) < 6e11


def _train_vs_prefill():
    cfg = get_config("llama3.2-1b")
    tr = analytic.flops_estimate(cfg, get_shape("train_4k"))
    pf = analytic.flops_estimate(cfg, get_shape("prefill_32k"))
    assert tr > 0 and pf > 0 and 1.5 < tr / pf < 4.0


def _decode_tiny():
    cfg = get_config("qwen2-0.5b")
    assert (analytic.flops_estimate(cfg, get_shape("decode_32k"))
            < analytic.flops_estimate(cfg, get_shape("prefill_32k")) / 1000)


def _terms_positive():
    for arch in ("qwen2-0.5b", "mixtral-8x7b", "xlstm-350m"):
        for sname in ("train_4k", "decode_32k"):
            r = analytic.analytic_roofline(get_config(arch), get_shape(sname),
                                           analytic.MeshSpec())
            assert r["compute_s"] > 0 and r["memory_s"] > 0
            assert r["dominant"] in ("compute_s", "memory_s", "collective_s")


def _model_flops_scaling():
    cfg = get_config("qwen2-0.5b")
    assert (analysis.model_flops(cfg, get_shape("train_4k"))
            == 6.0 * analysis.active_param_count(cfg) * 256 * 4096)


DIRECTIONS = {"h1_pure_dp_beats_tp": _h1, "h2_resident_experts": _h2,
              "h3_all_chip_tp_decode": _h3, "param_counts_sane": _param_counts,
              "train_vs_prefill_ratio": _train_vs_prefill,
              "decode_flops_tiny": _decode_tiny, "terms_positive": _terms_positive,
              "model_flops_scaling": _model_flops_scaling}


@pytest.mark.parametrize("case", sorted(DIRECTIONS))
def test_roofline_directions_hold_on_h100_peaks(case):
    """JAX's tests/test_roofline.py cases (all but its HLO parser, which
    has no torch input), on the port's model."""
    DIRECTIONS[case]()


# -------------------------------------------------------- analyze_step ---
def _randn(*shape, seed=0):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def _pairs(B, T, S, *, causal, window, q_offset, valid):
    """Live (query, key) pairs by brute force over the mask."""
    qp = torch.arange(T)[:, None] + q_offset
    kp = torch.arange(S)[None, :]
    live = torch.ones(T, S, dtype=torch.bool)
    if causal:
        live &= kp <= qp
    if window:
        live &= kp > qp - window
    rows = valid if valid is not None else [S] * B
    return sum(int((live & (kp < v)).sum()) for v in rows)


FLASH = (  # (B, T, S, Hq, Hkv, D, causal, window, q_offset, kv_valid_len)
    (2, 16, 16, 4, 2, 64, True, 0, 0, None),
    (1, 9, 40, 4, 1, 64, True, 8, 31, None),
    (3, 12, 20, 2, 2, 128, False, 5, 4, (20, 0, 7)),
)


def _flash_case(i):
    B, T, S, Hq, Hkv, D, causal, window, off, valid = FLASH[i]
    q, k, v = _randn(B, T, Hq, D, seed=1), _randn(B, S, Hkv, D, seed=2), _randn(B, S, Hkv, D, seed=3)
    vl = None if valid is None else torch.tensor(valid)
    kw = dict(causal=causal, window=window, q_offset=off, kv_valid_len=vl)
    pairs = _pairs(B, T, S, causal=causal, window=window, q_offset=off, valid=valid)
    extra = 0 if vl is None else vl.numel() * 8
    return q, k, v, kw, pairs, extra


def _flash_fwd(i):
    q, k, v, kw, pairs, extra = _flash_case(i)
    B, T, Hq, D = q.shape
    want = {"flash_attention": (4 * D * Hq * pairs, (2 * q.numel() + 2 * k.numel()) * 4 + extra)}
    return lambda: flash_attention_op(q, k, v, **kw), want


def _flash_bwd(i):
    q, k, v, kw, pairs, extra = _flash_case(i)
    B, T, Hq, D = q.shape
    qkv = [t.requires_grad_() for t in (q, k, v)]

    def fn():
        o = flash_attention_op(*qkv, **kw)
        torch.autograd.grad(o, qkv, torch.ones_like(o))

    lse = B * Hq * T * 4
    want = {"flash_attention": (4 * D * Hq * pairs,
                                (2 * q.numel() + 2 * k.numel()) * 4 + lse + extra),
            "flash_attention_backward": (10 * D * Hq * pairs,
                                         (4 * q.numel() + 4 * k.numel()) * 4 + lse + extra)}
    return fn, want


DECODE = ((2, 4, 2, 64, 33, 17), (1, 14, 2, 64, 64, (64,)), (3, 8, 8, 128, 40, (1, 40, 0)))


def _decode(i):
    B, Hq, Hkv, D, S, attend = DECODE[i]
    q, kc, vc = _randn(B, 1, Hq, D), _randn(B, S, Hkv, D, seed=1), _randn(B, S, Hkv, D, seed=2)
    a = attend if isinstance(attend, int) else torch.tensor(attend)
    slots = attend * B if isinstance(attend, int) else sum(attend)
    extra = 0 if isinstance(attend, int) else a.numel() * 8
    want = {"decode_attention": (4 * D * Hq * slots,
                                 (2 * q.numel() + 2 * slots * Hkv * D) * 4 + extra)}
    return lambda: decode_attention_op(q, kc, vc, a), want


ROWS = ((8, 64), (3, 5, 96), (1, 896))


def _rms(i):
    x, s = _randn(*ROWS[i]), 1 + 0.1 * _randn(ROWS[i][-1], seed=1)
    n, d = x.numel(), s.numel()
    return lambda: rmsnorm_op(x, s), {"rmsnorm": (4 * n, 8 * n + 4 * d)}


def _rms_bwd(i):
    x = _randn(*ROWS[i]).requires_grad_()
    s = (1 + 0.1 * _randn(ROWS[i][-1], seed=1)).requires_grad_()
    n, d = x.numel(), s.numel()

    def fn():
        y = rmsnorm_op(x, s)
        torch.autograd.grad(y, (x, s), torch.ones_like(y))

    return fn, {"rmsnorm": (4 * n, 8 * n + 4 * d),
                "rmsnorm_backward": (6 * n, 12 * n + 8 * d)}


OFFLOAD = ((16, 24, 5, 8), (7, 24, 0, 8), (3, 64, 21, 16))


def _quantize(i):
    N, C, _, L = OFFLOAD[i]
    x, c = _randn(N, C), torch.linspace(-2, 2, L)
    return lambda: quantize_op(x, c), {"quantize": (3 * L * N * C, N * C * 12 + L * 4)}


def _fused(i):
    N, C, k, L = OFFLOAD[i]
    x, c = _randn(N, C), torch.linspace(-2, 2, L)
    perm = tuple(np.random.RandomState(i).permutation(C).tolist())
    r = N * (C - k)
    return (lambda: fused_offload(x, c, perm=perm, k=k),
            {"offload_fused": (3 * L * r, 2 * N * C * 4 + L * 4 + 8 * r)})


def _permute(i):
    N, C, _, _ = OFFLOAD[i]
    x = _randn(N, C).requires_grad_()
    perm = tuple(np.random.RandomState(i).permutation(C).tolist())

    def fn():
        y = channel_permute_op(x, perm)
        torch.autograd.grad(y, x, torch.ones_like(y))

    return fn, {"topk_split": (0, 2 * 2 * N * C * 4)}


WORK = {"flash_attention": _flash_fwd, "flash_attention_backward": _flash_bwd,
        "decode_attention": _decode, "rmsnorm": _rms, "rmsnorm_backward": _rms_bwd,
        "quantize": _quantize, "offload_fused": _fused, "topk_split": _permute}


@pytest.mark.parametrize("i", range(3))
@pytest.mark.parametrize("kernel", sorted(WORK))
def test_reported_work_equals_formula(kernel, i):
    """One dispatcher call (and its backward) reports (operations, bytes)
    as worked out here, and nothing else of it is counted."""
    fn, want = WORK[kernel](i)
    rec = analysis.analyze_step(fn)
    got = {n: (r["flops"], r["bytes"]) for n, r in rec["kernels"].items()}
    assert got == want
    if kernel not in ("flash_attention_backward", "rmsnorm_backward", "topk_split"):
        assert rec["ops"] == {}
    assert rec["flops"] == sum(f for f, _ in want.values()) + sum(
        r["flops"] for r in rec["ops"].values())


def test_plain_function_counts_flop_counter_mode():
    """Without a dispatcher the count is FlopCounterMode's, and a view or
    an allocation moves no bytes."""
    from torch.utils.flop_counter import FlopCounterMode

    a, b = _randn(32, 48), _randn(48, 16, seed=1)

    def fn():
        return (a.t().t() @ b).relu().reshape(16, 32)

    with FlopCounterMode(display=False) as fc:
        fn()
    rec = analysis.analyze_step(fn)
    assert rec["flops"] == fc.get_total_flops() == 2 * 32 * 48 * 16
    assert rec["ops"]["aten.mm"]["bytes"] == (32 * 48 + 48 * 16 + 32 * 16) * 4
    assert rec["ops"]["aten.t"]["bytes"] == 0
    assert rec["hbm_bytes"] == (32 * 48 + 48 * 16 + 32 * 16) * 4 + 2 * 32 * 16 * 4
    assert rec["roofline"]["compute_s"] == rec["flops"] / analysis.peak_flops(torch.float32)
    assert rec["roofline"]["memory_s"] == rec["hbm_bytes"] / analysis.HBM_BW
    assert rec["roofline"]["collective_s"] == 0.0 and rec["roofline"]["chips"] == 1


def test_gathers_and_scatters_move_their_rows():
    """An embedding lookup reads the rows it gathers, not the table; a
    scatter writes its values, not the whole target."""
    table, ids = _randn(1000, 64), torch.tensor([[3, 5, 7]])
    cache, rows, slots, vals = torch.zeros(2, 50, 8), torch.arange(2), torch.tensor([3, 9]), _randn(2, 8)

    def fn():
        table[ids]
        torch.nn.functional.embedding(ids, table)
        cache[rows, slots] = vals

    rec = analysis.analyze_step(fn)
    assert rec["ops"]["aten.index"]["bytes"] == 3 * 8 + 2 * 3 * 64 * 4
    assert rec["ops"]["aten.embedding"]["bytes"] == 3 * 8 + 2 * 3 * 64 * 4
    assert rec["ops"]["aten.index_put_"]["bytes"] == 2 * 2 * 8 + 2 * 2 * 8 * 4


@pytest.fixture(scope="module")
def small():
    cfg = get_config("qwen2-0.5b").reduced()
    return cfg, bb.init_params(cfg, seed=0, device="cpu")


def test_prefill_count_repeats_and_covers_the_kernels(small):
    cfg, params = small
    L = cfg.n_layers
    tokens = torch.as_tensor(np.random.RandomState(0).randint(0, cfg.vocab, (2, 16)))
    step = make_prefill_step(cfg, dataclasses.replace(get_shape("prefill_32k"),
                                                      seq_len=24, global_batch=2))
    first = analysis.analyze_step(step, params, {"tokens": tokens})
    assert analysis.analyze_step(step, params, {"tokens": tokens}) == first
    assert {n: r["calls"] for n, r in first["kernels"].items()} == {
        "rmsnorm": 2 * L + 1, "flash_attention": L}
    assert first["flops"] > 2 * 2 * 16 * analysis.active_param_count(cfg) * 0.5
    assert first["roofline"]["dominant"] in ("compute_s", "memory_s")


def test_train_step_count_and_gradients_while_counting(small):
    """A train step under the counter: the kernels' calls of two
    microbatches (remat reruns each layer's forward), the same count twice,
    and the plain step's loss and new params (the CPU takes the card's
    autograd Functions while counting, with plain bodies)."""
    cfg, params = small
    L = cfg.n_layers
    rng = np.random.RandomState(1)
    batch = {k: torch.as_tensor(rng.randint(0, cfg.vocab, (4, 16))) for k in ("tokens", "labels")}
    step = make_train_step(cfg, dataclasses.replace(get_shape("train_4k"), global_batch=4,
                                                    seq_len=16), n_micro_override=2)
    kept, threads, opt = [], torch.get_num_threads(), opt_init(params)
    torch.set_num_threads(1)     # the CPU's embedding backward is bitwise on one thread
    try:
        rec = analysis.analyze_step(lambda: kept.append(step(params, opt, batch)))
        again = analysis.analyze_step(step, params, opt, batch)
        plain = step(params, opt, batch)
    finally:
        torch.set_num_threads(threads)
    assert rec == again
    assert {n: r["calls"] for n, r in rec["kernels"].items()} == {
        "rmsnorm": 2 * (2 * (2 * L + 1) - 1), "flash_attention": 2 * 2 * L,
        "rmsnorm_backward": 2 * (2 * L + 1), "flash_attention_backward": 2 * L}
    assert kept[0][2]["loss"] == plain[2]["loss"]
    for a, b in zip(plain[:2], kept[0][:2]):
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            assert (x - y).abs().max() <= 1e-6 * x.abs().max()
