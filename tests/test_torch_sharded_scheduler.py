"""The port's mesh-sharded slot pool, on 4 gloo ranks on the CPU.

JAX's sharded scheduler cannot serve as the oracle here: under jax 0.9.0
its inject scatter into a data-sharded pool raises ShardingTypeError
(``src/repro/serve/scheduler.py:355``), so tests/test_sharded_scheduler.py
and ``test_mesh_engine_routes_equal_lengths_through_scheduler`` fail on
the reference side.  Their claims are held instead against the port's own
``mesh=None`` scheduler, which tests/test_torch_scheduler.py holds to
JAX's single-device one.  The same reduced qwen2-0.5b, queue and
SchedulerConfig as JAX's test, with a (4, 1) mesh in place of its (8, 1)
and (2, 2) in place of (4, 2):

  * greedy tokens from the data-sharded pool equal the single-device
    scheduler's, overlap on or off, and so does the pool's integer state
    (buf / gen / done / tok / cache_len / eos / max_new); K/V within
    1e-5 (JAX's bar: a rank's rows multiply at another M-shape);
  * two sharded runs are bitwise the same, cache included;
  * a tensor-parallel (2, 2) mesh shards params over the model axis and
    serves deterministically, every request its full budget;
  * the slot axis is sharded, inject lands a request's rows on the rank
    that owns its slot, that rank's block holds the rows the gathered
    pool shows, and evict resets its depth there;
  * a meshed ServeEngine routes equal-length prompts through the
    scheduler and matches the per-request reference.

One train step of reduced qwen2-0.5b on the (2, 2) mesh under FSDP + TP
placements (``param_shardings(fsdp=True)``: the FFN weights split over
data and model) gives the loss and every updated leaf within 1e-5 of
``make_train_step`` on one process, in one microbatch and in two (each
taking its share of every rank's rows); a tensor axis over ("pod", "data")
puts pod-major blocks on the ranks, as JAX does.

The four ranks run once, in subprocesses sharing a ``file://`` store under
tmp_path, each on one torch thread; rank 0 writes the checks to JSON and
each claim is its own test below.
"""
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RANKS = 4

SCRIPT = r"""
import dataclasses, json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch import tree_leaves, tree_map
from repro_torch.configs import get_config
from repro_torch.configs.shapes import get_shape
from repro_torch.launch import partition
from repro_torch.launch.mesh import make_serving_mesh, process_group
from repro_torch.launch.steps import make_train_step, opt_init
from repro_torch.models import backbone as bb
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.scheduler import ContinuousScheduler, SchedulerConfig
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Shard

rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
cfg = get_config("qwen2-0.5b").reduced()
params = bb.init_params(cfg, seed=0, device="cpu")
rng = np.random.RandomState(0)
lens = [8, 16, 32, 5, 11, 27, 8, 16, 32, 8]
reqs = [Request(tokens=rng.randint(0, cfg.vocab, L), max_new_tokens=4) for L in lens]
KW = dict(buckets=(8, 16, 32), max_slots=8, prefill_group=4, chunk=4)
INTS = ("buf", "gen", "done", "tok", "cache_len", "eos", "max_new")
checks = {}


def run(mesh, overlap=True):
    s = ContinuousScheduler(cfg, params, max_len=64, mesh=mesh, device="cpu",
                            sched=SchedulerConfig(overlap=overlap, **KW))
    rids = [s.submit(r) for r in reqs]
    outs = s.run()
    pool = tree_map(s._whole, s._pool)
    return [outs[r].tokens.tolist() for r in rids], pool, s


ref_toks, ref_pool, _ = run(None)
with process_group("gloo", world_size=world, rank=rank, init_method=init):
    mesh = make_serving_mesh(data=4, model=1)
    sh_toks, sh_pool, _ = run(mesh)
    checks["tokens_bit_identical"] = sh_toks == ref_toks
    checks["int_state_bit_identical"] = all(torch.equal(ref_pool[k], sh_pool[k]) for k in INTS)
    checks["cache_allclose"] = all(
        torch.allclose(ref_pool["cache"][k], sh_pool["cache"][k], rtol=1e-5, atol=1e-5)
        for k in ("k", "v"))
    sh2_toks, sh2_pool, _ = run(mesh)
    checks["sharded_deterministic"] = sh2_toks == sh_toks and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(sh_pool), tree_leaves(sh2_pool)))
    ser_toks, _, _ = run(mesh, overlap=False)
    checks["serialized_tokens_bit_identical"] = ser_toks == ref_toks

    tp = make_serving_mesh(data=2, model=2)
    tp_toks, _, tp_sched = run(tp)
    tp2_toks, _, _ = run(tp)
    checks["tp_deterministic"] = tp_toks == tp2_toks
    checks["tp_budgets"] = all(len(t) == 4 for t in tp_toks)
    checks["tp_params_model_sharded"] = any(
        isinstance(leaf.placements[1], Shard) for leaf in tree_leaves(tp_sched.params))

    # ---- evict / inject shard placement --------------------------------
    sched = ContinuousScheduler(cfg, params, max_len=64, mesh=mesh, device="cpu",
                                sched=SchedulerConfig(overlap=False, **KW))
    rid = sched.submit(Request(tokens=np.arange(8) % cfg.vocab, max_new_tokens=30))
    sched.step()
    slot = sched._slot_rid.index(rid)
    owner = slot // (KW["max_slots"] // 4)
    local_rows = sched._pool["buf"].to_local().shape[0]
    n_rows = torch.tensor([local_rows])
    torch.distributed.all_reduce(n_rows)
    checks["pool_slot_axis_sharded"] = local_rows == 2 and int(n_rows) == KW["max_slots"]
    depth = int(sched._local["cache_len"][slot - 2 * rank]) if rank == owner else -1
    depths = [None] * world
    torch.distributed.all_gather_object(depths, depth)
    checks["inject_lands_on_owning_shard"] = (
        depths[owner] == 8 + KW["chunk"]                      # prompt + 1 chunk
        and all(sched._local["cache_len"].tolist() == [0, 0]
                for r in range(world) if r == rank and r != owner))
    whole = sched._whole(sched._pool["buf"])
    mine = sched._pool["buf"].to_local()
    checks["shard_holds_its_rows"] = bool(torch.equal(mine, whole[2 * rank:2 * rank + 2]))
    sched.run()
    flat = sched._whole(sched._pool["cache_len"])
    checks["evict_resets_owning_shard"] = int(flat[slot]) == 0 and (
        rank != owner or int(sched._local["cache_len"][slot - 2 * rank]) == 0)

    # ---- a meshed engine routes equal lengths through the scheduler ----
    one = make_serving_mesh(data=4, model=1)
    eng = ServeEngine(cfg, params, max_len=64, mesh=one, device="cpu",
                      scheduler=SchedulerConfig(buckets=(8, 16, 32), max_slots=4,
                                                prefill_group=2, chunk=4))
    plain = ServeEngine(cfg, params, max_len=64, device="cpu")
    r9 = np.random.RandomState(9)
    eq = [Request(tokens=r9.randint(0, cfg.vocab, 16), max_new_tokens=4) for _ in range(3)]
    got = eng.generate(eq)
    checks["mesh_engine_routes_through_scheduler"] = eng._sched is not None and all(
        g.tokens.tolist() == plain.generate([q])[0].tokens.tolist()
        for q, g in zip(eq, got))

    # ---- one train step on (2, 2): FSDP + TP against one process --------
    shape = dataclasses.replace(get_shape("train_4k"), global_batch=4, seq_len=16)
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (4, 16), generator=gen) for k in ("tokens", "labels")}
    step = make_train_step(cfg, shape)
    p1, o1, m1 = step(params, opt_init(params), batch)
    tmesh = make_serving_mesh(data=2, model=2)
    sh = partition.param_shardings(params, tmesh, cfg=cfg, fsdp=True)
    specs = [s.spec for s in tree_leaves(sh)]
    checks["train_fsdp_tp_placements"] = any(
        "data" in s and "model" in s for s in specs)
    dp = partition.distribute(params, sh)
    bs = partition.batch_spec(tmesh, 2)
    p2, o2, m2 = step(dp, opt_init(dp), {k: bs.distribute(v) for k, v in batch.items()})
    loss2 = float(m2["loss"].full_tensor())
    checks["train_loss_within_1e-5"] = abs(loss2 - float(m1["loss"])) <= 1e-5
    errs = [float((b.full_tensor() - a).abs().max())
            for a, b in zip(tree_leaves(p1) + tree_leaves(o1),
                            tree_leaves(p2) + tree_leaves(o2))]
    checks["train_leaves_within_1e-5"] = max(errs) <= 1e-5
    checks["train_leaves_keep_placements"] = all(
        tuple(a.placements) == tuple(b.placements)
        for a, b in zip(tree_leaves(dp), tree_leaves(p2)))
    # two microbatches: each takes its share of every rank's rows
    step2 = make_train_step(cfg, shape, n_micro_override=2)
    q1, r1, n1 = step2(params, opt_init(params), batch)
    q2, r2, n2 = step2(dp, opt_init(dp), {k: bs.distribute(v) for k, v in batch.items()})
    checks["train_microbatches_within_1e-5"] = (
        abs(float(n2["loss"].full_tensor()) - float(n1["loss"])) <= 1e-5
        and max(float((b.full_tensor() - a).abs().max())
                for a, b in zip(tree_leaves(q1) + tree_leaves(r1),
                                tree_leaves(q2) + tree_leaves(r2))) <= 1e-5)

    # ---- ("pod", "data") rows split pod-major, as JAX's ----------------
    pd = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
    rows = torch.arange(8 * 3).reshape(8, 3)
    d = partition.NamedSharding(pd, [("pod", "data"), None]).distribute(rows)
    p, q = pd.get_coordinate()
    block = 2 * p + q
    checks["pod_major_rows"] = (torch.equal(d.to_local(), rows[2 * block:2 * block + 2])
                                and torch.equal(d.full_tensor(), rows))

if rank == 0:
    with open(out, "w") as f:
        json.dump(checks, f)
else:
    bad = [k for k, v in checks.items() if not v]
    assert not bad, (rank, bad)
"""

CLAIMS = ["tokens_bit_identical", "int_state_bit_identical", "cache_allclose",
          "sharded_deterministic", "serialized_tokens_bit_identical", "tp_deterministic",
          "tp_budgets", "tp_params_model_sharded", "pool_slot_axis_sharded",
          "inject_lands_on_owning_shard", "shard_holds_its_rows",
          "evict_resets_owning_shard", "mesh_engine_routes_through_scheduler",
          "train_fsdp_tp_placements", "train_loss_within_1e-5",
          "train_leaves_within_1e-5", "train_leaves_keep_placements",
          "train_microbatches_within_1e-5", "pod_major_rows"]


@pytest.fixture(scope="module")
def checks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_pool")
    out = tmp / "checks.json"
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", SCRIPT, str(r), str(RANKS),
                               f"file://{tmp}/rendezvous", str(out)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(RANKS)]
    logs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            logs.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    failed = [(i, rc, err[-3000:]) for i, (rc, err) in enumerate(logs) if rc]
    assert not failed, failed
    return json.loads(out.read_text())


def test_every_claim_was_checked(checks):
    assert sorted(checks) == sorted(CLAIMS)


@pytest.mark.parametrize("claim", CLAIMS)
def test_sharded_pool_claim(checks, claim):
    assert checks[claim], f"{claim}: {checks}"
