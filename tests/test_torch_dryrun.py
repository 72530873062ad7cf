"""The port's dry-run (``repro_torch.launch.steps.lower_step`` and
``launch/dryrun.py``) on the CPU, against the JAX package's placements.

JAX's four cases of tests/test_dryrun_small_mesh.py (reduced configs,
batch 8, T 64, a (2, 4) ("data", "model") mesh): qwen2-0.5b train_4k,
mixtral-8x7b decode_32k, jamba-1.5-large-398b prefill_32k, and qwen2-0.5b
train_4k under the pure-DP strategy.  The port builds each step's
arguments as meta DTensors over torch's fake process group of 8 ranks and
runs the step once (``Lowered.compile``):

- each record's per-rank argument bytes equal the sum, over the same
  trees, of JAX's ``NamedSharding.shard_shape`` under the shardings JAX's
  ``lower_step`` gives them (``param_shardings``, ``batch_shardings``,
  ``cache_shardings``; the decode step's depth an int32 scalar);
- the pure-DP strategy issues fewer all-gathers, or fewer collectives,
  than the baseline, as JAX's test asserts;
- the collectives are counted by JAX's kinds, and the roofline's
  collective term is their bytes over ranks x NVLink;
- the counter sees the collectives that DTensor issues inside an
  operator as well as the explicit ones: its counts by kind equal those
  of torch's own ``CommDebugMode`` over the same run, for every case;
  and by hand, a product with an FSDP-split weight gathers that weight
  once and a row-parallel product all-reduces its output once, each with
  its bytes;
- beside JAX's compiled program (``collective_bytes_from_hlo``, 8 forced
  host devices in a subprocess of its own) for qwen2-0.5b train_4k:
  both partitioners gather weights and all-reduce partial sums under
  FSDP + TP, and neither gathers under pure DP.  The bytes differ by
  design (XLA combines collectives and picks all-to-alls and permutes,
  DTensor redistributes op by op), so they are printed, not compared.

Also: on a one-rank (1, 1) mesh a decode step's ``analyze_step`` counts
the unmeshed step's flops and bytes exactly, with no collective; and
``dryrun.main`` prints JAX's OK / SKIP lines (qwen2-0.5b decode_32k at
full size on the 256-rank mesh, specs only, and whisper-tiny long_500k's
documented skip).

The port runs in a subprocess, so that its fake process groups never meet
another test; its meshes of meta tensors are cuda meshes, as the
dry-run's are (``launch/dryrun.py``).
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.shapes import get_shape as jax_get_shape  # noqa: E402
from repro.launch import partition as jpart  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CASES = [("qwen2-0.5b", "train_4k", False), ("mixtral-8x7b", "decode_32k", False),
         ("jamba-1.5-large-398b", "prefill_32k", False), ("qwen2-0.5b", "train_4k", True)]

SCRIPT = r"""
import contextlib, dataclasses, io, json, sys
import torch
torch.set_num_threads(1)
from repro_torch.configs import get_config
from repro_torch.configs.shapes import get_shape
from repro_torch.launch import dryrun, partition
from repro_torch.launch.mesh import make_serving_mesh, process_group
from repro_torch.launch.steps import Strategy, lower_step, make_serve_step
from repro_torch.models import backbone as bb
from repro_torch.roofline import analysis
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.debug import CommDebugMode

def kinds(comm):
    # CommDebugMode's counts by the JAX package's kinds
    names = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
             "reduce_scatter_tensor": "reduce-scatter", "shard_dim_alltoall": "all-to-all",
             "all_to_all_single": "all-to-all"}
    out = {}
    for op, n in comm.get_comm_counts().items():
        kind = names.get(str(op).split(".")[-1], str(op))
        out[kind] = out.get(kind, 0) + n
    return out

cases = json.loads(sys.argv[1])
out = {"records": []}
with process_group("fake", world_size=8):
    mesh = make_serving_mesh(data=2, model=4, device_type="cuda")
    for arch, shape_name, pure_dp in cases:
        cfg = get_config(arch).reduced()
        shape = dataclasses.replace(get_shape(shape_name), global_batch=8, seq_len=64)
        strat = Strategy(model_axes=(), fsdp=False) if pure_dp else None
        lowered, meta = lower_step(cfg, shape, mesh, strategy=strat)
        with CommDebugMode() as comm:
            compiled = lowered.compile()
        out["records"].append({"kind": meta["kind"], "memory": compiled.memory_analysis(),
                               "comm": kinds(comm),
                               **{k: compiled.analysis[k] for k in
                                  ("flops", "hbm_bytes", "collectives", "roofline")}})
    # by hand: x (8, 64) rows over data; w (64, 32) split over data (FSDP,
    # its rows) and model (its columns); w2 (32, 64) split over model (its
    # rows: row-parallel).  x @ w gathers w's FSDP split (one all-gather,
    # 64 x 8 floats a rank) and gives (4, 8) a rank; @ w2 gives partial
    # sums over model, replicated by one all-reduce of (4, 64) floats
    x = distribute_tensor(torch.empty(8, 64, device="meta"), mesh, [Shard(0), Replicate()])
    w = distribute_tensor(torch.empty(64, 32, device="meta"), mesh, [Shard(0), Shard(1)])
    w2 = distribute_tensor(torch.empty(32, 64, device="meta"), mesh, [Replicate(), Shard(0)])
    hand = analysis.analyze_step(
        lambda x, w, w2: ((x @ w) @ w2).redistribute(mesh, [Shard(0), Replicate()]),
        x, w, w2, mesh=mesh)
    out["hand"] = {k: hand[k] for k in ("flops", "collectives")}

# a decode step on a one-rank mesh counts as the unmeshed step
cfg = get_config("qwen2-0.5b").reduced()
params = bb.init_params(cfg, seed=0, device="cpu")
gen = torch.Generator().manual_seed(0)
tok = torch.randint(0, cfg.vocab, (4, 1), generator=gen)
step = make_serve_step(cfg, get_shape("decode_32k"))
plain = analysis.analyze_step(step, params, tok, bb.init_cache(cfg, 4, 32, device="cpu"), 17)
with process_group("fake", world_size=1):
    one = make_serving_mesh(data=1, model=1)
    p = partition.distribute(params, partition.param_shardings(params, one, cfg=cfg))
    c = bb.init_cache(cfg, 4, 32, device="cpu")
    c = partition.distribute(c, partition.cache_shardings(c, one, batch=4, cfg=cfg))
    meshed = analysis.analyze_step(step, p, partition.batch_spec(one, 2).distribute(tok),
                                   c, 17, mesh=one)
out["one_rank"] = {k: [plain[k], meshed[k]] for k in ("flops", "hbm_bytes")}
out["one_rank"]["collective_s"] = meshed["roofline"]["collective_s"]
out["one_rank"]["kernels"] = [plain["kernels"], meshed["kernels"]]

buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    rc = dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k", "--skip-compile"])
    rc += dryrun.main(["--arch", "whisper-tiny", "--shape", "long_500k"])
out["main"] = [rc, buf.getvalue()]
print(json.dumps(out))
"""


JAX_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json
import jax
from repro.configs import get_config
from repro.configs.shapes import get_shape
from repro.launch.steps import Strategy, lower_step
from repro.roofline.analysis import analyze_compiled

mesh = jax.make_mesh((2, 4), ("data", "model"))
out = []
for strat in (None, Strategy(model_axes=(), fsdp=False)):
    cfg = get_config("qwen2-0.5b").reduced()
    shape = dataclasses.replace(get_shape("train_4k"), global_batch=8, seq_len=64)
    lowered, _ = lower_step(cfg, shape, mesh, strategy=strat)
    out.append(analyze_compiled(lowered.compile(), mesh=mesh)["collectives"])
print(json.dumps(out))
"""


def _finish(proc) -> dict:
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, stderr[-3000:]
    return json.loads(stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs():
    """The port's run and JAX's small-mesh compile, side by side."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    port = subprocess.Popen([sys.executable, "-c", SCRIPT, json.dumps(CASES)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    jax_run = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT], env=env,
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        return {"port": _finish(port), "jax": _finish(jax_run)}
    finally:
        for proc in (port, jax_run):
            if proc.poll() is None:
                proc.kill()
                proc.wait()


@pytest.fixture(scope="module")
def port(runs):
    return runs["port"]


def _jax_argument_bytes(arch, shape_name, pure_dp) -> int:
    """Per-device bytes of the arguments of JAX's ``lower_step`` for the
    case: its shardings (the choices of ``repro.launch.steps.lower_step``)
    through ``NamedSharding.shard_shape``."""
    mesh = AbstractMesh((2, 4), ("data", "model"))
    cfg = jax_get_config(arch).reduced()
    shape = dataclasses.replace(jax_get_shape(shape_name), global_batch=8, seq_len=64)
    strategy = jsteps.Strategy(model_axes=(), fsdp=False) if pure_dp else jsteps.BASELINE
    p_sds = jsteps.params_specs(cfg)
    msize = int(np.prod([mesh.shape[a] for a in strategy.model_axes]))
    serve_fsdp = jsteps._param_gib(p_sds) / max(msize, 1) > 12.0
    trees = []
    if shape.kind == "train":
        p_sh = jpart.param_shardings(p_sds, mesh, fsdp=True, strategy=strategy)
        b_sds = jsteps.make_batch_specs(cfg, shape)
        trees = [(p_sds, p_sh), (p_sds, p_sh),
                 (b_sds, jsteps.batch_shardings(cfg, b_sds, mesh, strategy))]
    else:
        p_sh = jpart.param_shardings(p_sds, mesh, fsdp=serve_fsdp, strategy=strategy)
        trees = [(p_sds, p_sh)]
        if shape.kind == "prefill":
            b_sds = jsteps.make_batch_specs(cfg, shape)
            trees.append((b_sds, jsteps.batch_shardings(cfg, b_sds, mesh, strategy)))
        else:
            b = shape.global_batch
            baxes = strategy.batch_axes(mesh)
            tok = jax.ShapeDtypeStruct((b, 1), np.int32)
            tok_sh = NamedSharding(mesh, P(baxes, None))
            c_sds = jsteps.cache_specs(cfg, shape)
            trees += [(tok, tok_sh),
                      (c_sds, jpart.cache_shardings(c_sds, mesh, batch=b, strategy=strategy)),
                      (jax.ShapeDtypeStruct((), np.int32), NamedSharding(mesh, P()))]
    total = 0
    for sds, sh in trees:
        for leaf, s in zip(jax.tree_util.tree_leaves(sds), jax.tree_util.tree_leaves(sh)):
            total += int(np.prod(s.shard_shape(leaf.shape))) * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{a}-{s}{'-pure_dp' if d else ''}" for a, s, d in CASES])
def test_argument_bytes_equal_jax_shard_shapes(port, case):
    rec = port["records"][case]
    assert rec["memory"]["argument_bytes"] == _jax_argument_bytes(*CASES[case])
    assert rec["memory"]["output_bytes"] > 0
    assert rec["memory"]["temp_bytes"] is None and rec["memory"]["peak_bytes"] is None
    assert rec["kind"] == jax_get_shape(CASES[case][1]).kind


def test_pure_dp_moves_fewer_collectives(port):
    base, opt = port["records"][0]["collectives"], port["records"][3]["collectives"]
    assert opt["counts"]["all-gather"] < base["counts"]["all-gather"] or \
        sum(opt["counts"].values()) < sum(base["counts"].values())


def test_collective_term(port):
    from repro_torch.roofline.analysis import LINK_BW

    for rec in port["records"]:
        coll = rec["collectives"]
        assert sorted(coll["counts"]) == sorted(("all-gather", "all-reduce", "reduce-scatter",
                                                 "all-to-all", "collective-permute"))
        assert coll["total_bytes"] == sum(coll["bytes_by_kind"].values())
        assert rec["roofline"]["chips"] == 8
        assert rec["roofline"]["collective_s"] == coll["total_bytes"] / (8 * LINK_BW)
    assert port["records"][0]["collectives"]["total_bytes"] > 0


def test_collectives_equal_comm_debug_mode(port):
    """Every collective, inside DTensor's operators or explicit, is
    counted: the counts by kind are CommDebugMode's over the same run."""
    for rec in port["records"]:
        counted = {k: n for k, n in rec["collectives"]["counts"].items() if n}
        assert counted == rec["comm"]


def test_collectives_by_hand(port):
    hand = port["hand"]
    coll = hand["collectives"]
    assert {k: n for k, n in coll["counts"].items() if n} == {"all-gather": 1,
                                                               "all-reduce": 1}
    assert coll["bytes_by_kind"]["all-gather"] == 64 * 8 * 4
    assert coll["bytes_by_kind"]["all-reduce"] == 4 * 64 * 4
    # one rank's products: (4, 64) @ (64, 8) and (4, 8) @ (8, 64)
    assert hand["flops"] == 2 * (2 * 4 * 64 * 8)


def test_collectives_beside_jax(runs):
    """qwen2-0.5b train_4k on (2, 4): the same kinds carry FSDP + TP and
    pure DP in both partitioners; the bytes a rank moves are printed."""
    (base, opt), jbase, jopt = ((runs["port"]["records"][0]["collectives"],
                                 runs["port"]["records"][3]["collectives"]),
                                *runs["jax"])
    for coll in (base, jbase):
        assert coll["counts"]["all-gather"] > 0 and coll["counts"]["all-reduce"] > 0
    for coll in (opt, jopt):
        assert coll["counts"]["all-gather"] == 0 and coll["counts"]["all-reduce"] > 0
    print(f"collective bytes a rank, port / JAX: FSDP + TP {base['total_bytes']} / "
          f"{jbase['total_bytes']}, pure DP {opt['total_bytes']} / {jopt['total_bytes']}")


def test_one_rank_mesh_counts_the_unmeshed_step(port):
    one = port["one_rank"]
    assert one["flops"][0] == one["flops"][1]
    assert one["hbm_bytes"][0] == one["hbm_bytes"][1]
    assert one["kernels"][0] == one["kernels"][1]
    assert one["collective_s"] == 0.0


def test_dryrun_main_prints_jaxs_lines(port):
    rc, text = port["main"]
    assert rc == 0
    lines = text.splitlines()
    assert any(line.startswith("OK    qwen2-0.5b") and "mesh=16x16" in line for line in lines)
    assert any(line.startswith("SKIP  whisper-tiny") for line in lines)
