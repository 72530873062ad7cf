"""The port's meshed MoE (``repro_torch.nn.moe._moe_meshed``): expert
parallelism on the JAX package's placements, on 4 gloo ranks on the CPU.

Held against the port's own mesh-less layer and against the JAX package
on the same weights (the port's init bridged into JAX's layout).  Five
placements of reduced configs in float32 (``launch/partition.py``, JAX's
rules):

  * ``data``: a (4, 1) mesh, reduced moonshot-v1-16b-a3b (a shared
    expert): the experts replicated, each rank routing its own groups;
  * ``experts``: (2, 2), reduced mixtral-8x7b (E = 4 over the model
    axis): each rank runs its 2 experts, y summed over the model axis;
  * ``ff``: (2, 2), mixtral with 3 experts (E does not divide the model
    axis: expert-ff over it), each rank every expert on its ff slice;
  * ``expert_data``: (2, 2) under ``Strategy(expert_data_sharding=True)``,
    reduced arctic-480b (a dense residual): the experts over the data
    axis, ff over the model axis, an all-to-all each way;
  * ``pod_data``: a (2, 2, 1) ("pod", "data", "model") mesh under
    ``expert_data_sharding``: the experts over ("pod", "data"), one
    all-to-all over their joint group, pod-major.

For each, against the mesh-less run of the same weights and batch: the
routes (each routing call's experts and keep mask, every rank's groups)
equal; prefill logits within 1e-5 of their scale (a rank's products run at
another M-shape and partial sums add in another order, JAX's bar for the
sharded pool); the greedy tokens of 4 decode steps equal; the aux losses
within 1e-6; two meshed runs bitwise.  Against JAX's mesh-less
``prefill`` and jitted ``decode_step`` (its ``moe_apply`` at the same group
size, as in training): prefill logits within 1e-5 of their scale and the
greedy tokens equal, as tests/test_torch_moe_archs.py holds the mesh-less
port; the
prefill's aux losses (JAX's ``_run_superblocks`` with the prefill's
dropless capacity) within 1e-5, the bar of tests/test_torch_moe_train.py
(float32 means over another order).  The prefill routes in groups of 16
tokens (``moe_apply(group_size=16)`` in every run), so that the data ranks
hold whole groups of a batch of 8 x 16; a decode step's 8 tokens are one
group, which every rank gathers and routes.

One train step each under ``param_shardings(fsdp=True)``: mixtral with
expert_d_ff 256 (its expert leaves large enough for FSDP: d over the data
axis, E over the model axis) and arctic under ``expert_data_sharding``;
the loss and every updated leaf within 1e-5 of ``make_train_step`` on one
process, every leaf at its placement; and against JAX's
``make_train_step`` on the same weights and batch, the loss within 1e-5
and every new param and momentum leaf within 1e-5 of the leaf's scale
(tests/test_torch_moe_train.py's bars).

A ``ServeEngine`` refuses DTensor params without a ``mesh``.

The collectives, by a dispatch mode over the functional collectives:
serving gathers no expert block; FSDP training gathers expert blocks over
the data axis only; expert_data_sharding issues all-to-alls.

The ranks run once, in subprocesses sharing a ``file://`` store under
tmp_path, each on one torch thread; rank 0 writes the checks to JSON and
its outputs (whole tensors) to a file, while this process runs JAX on the
same weights; each claim is its own test below.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.shapes import get_shape as jax_get_shape  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import backbone as jbb  # noqa: E402
from repro.nn import moe as jmoe  # noqa: E402
from repro_torch.bridge import backbone_params_to_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import backbone as tbb  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RANKS = 4

SCRIPT = r"""
import dataclasses, functools, json, sys
import torch
torch.set_num_threads(1)
from repro_torch import sharded, tree_leaves, tree_map
from repro_torch.configs import get_config
from repro_torch.configs.shapes import get_shape
from repro_torch.launch import partition
from repro_torch.launch.mesh import make_serving_mesh, process_group
from repro_torch.launch.steps import Strategy, make_train_step, opt_init
from repro_torch.models import backbone as bb
from repro_torch.nn import moe
from repro_torch.serve.engine import ServeEngine
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
B, T, STEPS, GROUP = 8, 16, 4, 16
KINDS = ("all_gather_into_tensor", "all_reduce", "reduce_scatter_tensor", "all_to_all_single")
checks = {}
outputs = {}            # rank 0's whole outputs, held against JAX by the test


class Collectives(TorchDispatchMode):
    # each functional collective this rank issues: (op, output shape, group)
    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        res = func(*args, **(kwargs or {}))
        if func.namespace in ("_c10d_functional", "c10d_functional") \
                and func._opname in KINDS:
            group = [a for a in args if isinstance(a, str)][-1]
            self.seen.append((func._opname, tuple(res.shape), group))
        return res


def expert_shaped(shape, cfg):
    d, f = cfg.d_model, cfg.moe.expert_d_ff
    tails = {(d, f // k) for k in (1, 2, 4)} | {(f // k, d) for k in (1, 2, 4)}
    return len(shape) == 3 and tuple(shape[1:]) in tails


ROUTES = []
_routing = moe.moe_routing


def recorded(*a, **k):
    r = _routing(*a, **k)
    ROUTES.append((r["expert"].clone(), r["keep"].clone()))
    return r


moe.moe_routing = recorded
bb.moe_apply = functools.partial(moe.moe_apply, group_size=GROUP)


def whole(t):
    return t.full_tensor() if sharded.is_dtensor(t) else t


def serve(cfg, params, tokens, mesh=None):
    # prefill + STEPS greedy decode steps; (prefill logits, tokens, aux, routes)
    del ROUTES[:]
    aux = {}
    with sharded.host_replicated(mesh):
        batch = {"tokens": tokens}
        if mesh is not None:
            batch = {"tokens": partition.batch_spec(mesh, 2).distribute(tokens)}
        logits, cache, depth = bb.prefill(cfg, params, batch, max_len=T + STEPS + 1, aux=aux)
        first = whole(logits)
        tok = torch.argmax(first, dim=-1)
        toks = [tok]
        for _ in range(STEPS):
            t = tok[:, None]
            if mesh is not None:
                t = partition.batch_spec(mesh, 2).distribute(t)
            logits, cache = bb.decode_step(cfg, params, t, cache, depth)
            tok = torch.argmax(whole(logits), dim=-1)
            toks.append(tok)
            depth += 1
    aux = {k: float(whole(v)) for k, v in aux.items()}
    return first, torch.stack(toks, 1), aux, list(ROUTES)


def routes_equal(mesh, ref_routes, got_routes):
    # every rank's routing calls against the mesh-less run's, group by group:
    # a rank routing its own groups holds those at its row-split index
    if len(ref_routes) != len(got_routes):
        return False
    coord = mesh.get_coordinate()
    names = mesh.mesh_dim_names
    rows = [i for i, n in enumerate(names) if n in ("pod", "data")]
    ok = True
    for (re_, rk), (ge, gk) in zip(ref_routes, got_routes):
        g = ge.shape[0]
        start = 0
        if g != re_.shape[0]:
            idx = 0
            for i in rows:
                idx = idx * mesh.size(i) + coord[i]
            start = idx * g
        ok &= bool(torch.equal(re_[start:start + g], ge) and torch.equal(rk[start:start + g], gk))
    flags = [None] * world
    torch.distributed.all_gather_object(flags, ok)
    return all(flags)


def placement(name, cfg, mesh, strategy):
    params = bb.init_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab, (B, T), generator=gen)
    ref_first, ref_toks, ref_aux, ref_routes = serve(cfg, params, tokens)
    sh = partition.param_shardings(params, mesh, cfg=cfg, strategy=strategy)
    dp = partition.distribute(params, sh)
    with Collectives() as coll:
        first, toks, aux, routes = serve(cfg, dp, tokens, mesh)
    first2, toks2, aux2, _ = serve(cfg, dp, tokens, mesh)
    scale = float(ref_first.abs().max())
    checks[f"{name}_routes_equal"] = routes_equal(mesh, ref_routes, routes)
    checks[f"{name}_prefill_logits_within_1e-5"] = (
        float((first - ref_first).abs().max()) <= 1e-5 * scale)
    checks[f"{name}_decode_tokens_equal"] = bool(torch.equal(toks, ref_toks))
    checks[f"{name}_aux_within_1e-6"] = sorted(aux) == sorted(ref_aux) and all(
        abs(aux[k] - ref_aux[k]) <= 1e-6 for k in aux)
    checks[f"{name}_meshed_bitwise"] = (bool(torch.equal(first, first2))
                                        and bool(torch.equal(toks, toks2)) and aux == aux2)
    checks[f"{name}_no_expert_gather"] = not any(
        op.startswith("all_gather") and expert_shaped(shape, cfg)
        for op, shape, _ in coll.seen)
    outputs[name] = {"first": first, "tokens": toks, "aux": aux}
    return coll.seen


def train(name, cfg, mesh, strategy):
    params = bb.init_params(cfg, seed=0, device="cpu")
    shape = dataclasses.replace(get_shape("train_4k"), global_batch=B, seq_len=T)
    gen = torch.Generator().manual_seed(4)
    batch = {k: torch.randint(0, cfg.vocab, (B, T), generator=gen) for k in ("tokens", "labels")}
    step = make_train_step(cfg, shape)
    p1, o1, m1 = step(params, opt_init(params), batch)
    sh = partition.param_shardings(params, mesh, cfg=cfg, fsdp=True, strategy=strategy)
    dp = partition.distribute(params, sh)
    bs = partition.batch_spec(mesh, 2)
    with Collectives() as coll:
        p2, o2, m2 = step(dp, opt_init(dp), {k: bs.distribute(v) for k, v in batch.items()})
    checks[f"train_{name}_loss_within_1e-5"] = (
        abs(float(m2["loss"].full_tensor()) - float(m1["loss"])) <= 1e-5)
    errs = [float((b.full_tensor() - a).abs().max())
            for a, b in zip(tree_leaves(p1) + tree_leaves(o1), tree_leaves(p2) + tree_leaves(o2))]
    checks[f"train_{name}_leaves_within_1e-5"] = max(errs) <= 1e-5
    checks[f"train_{name}_leaves_keep_placements"] = all(
        tuple(a.placements) == tuple(b.placements)
        for a, b in zip(tree_leaves(dp), tree_leaves(p2)))
    outputs[f"train_{name}"] = {"loss": float(m2["loss"].full_tensor()),
                                "params": tree_map(whole, p2),
                                "momentum": tree_map(whole, o2["momentum"])}
    return sh, coll.seen


with process_group("gloo", world_size=world, rank=rank, init_method=init):
    data_only = make_serving_mesh(data=4, model=1)
    square = make_serving_mesh(data=2, model=2)
    moon = get_config("moonshot-v1-16b-a3b").reduced()
    mix = get_config("mixtral-8x7b").reduced()
    mix3 = dataclasses.replace(mix, moe=dataclasses.replace(mix.moe, n_experts=3))
    arc = get_config("arctic-480b").reduced()
    eds = Strategy(expert_data_sharding=True)

    placement("data", moon, data_only, None)
    placement("experts", mix, square, None)
    seen = placement("ff", mix3, square, None)
    sh3 = partition.param_shardings(bb.init_params(mix3, seed=0, device="meta"), square,
                                    cfg=mix3)
    checks["placements_as_named"] = (
        str(sh3["blocks"][0]["moe"]["gate"].spec) == str((None, None, "model")))
    seen = placement("expert_data", arc, square, eds)
    checks["expert_data_all_to_all"] = any(op == "all_to_all_single" for op, _, _ in seen)
    pod = init_device_mesh("cpu", (2, 2, 1), mesh_dim_names=("pod", "data", "model"))
    seen = placement("pod_data", arc, pod, eds)
    checks["pod_data_all_to_all"] = any(op == "all_to_all_single" for op, _, _ in seen)

    # an engine refuses DTensor params without their mesh
    params = bb.init_params(mix, seed=0, device="cpu")
    dp = partition.distribute(params, partition.param_shardings(params, square, cfg=mix))
    try:
        ServeEngine(mix, dp, max_len=2 * T, device="cpu")
        checks["engine_refuses_meshed_params_without_mesh"] = False
    except ValueError:
        checks["engine_refuses_meshed_params_without_mesh"] = True

    mixf = dataclasses.replace(mix, moe=dataclasses.replace(mix.moe, expert_d_ff=256))
    sh, seen = train("fsdp", mixf, square, None)
    data_group = square.get_group(0).group_name
    gathers = [g for op, shape, g in seen
               if op.startswith("all_gather") and expert_shaped(shape, mixf)]
    checks["train_fsdp_expert_leaves_fsdp_split"] = (
        str(sh["blocks"][0]["moe"]["gate"].spec) == str(("model", "data", None)))
    checks["train_fsdp_expert_gathers_over_data_only"] = (
        bool(gathers) and all(g == data_group for g in gathers))
    _, seen = train("expert_data", arc, square, eds)
    checks["train_expert_data_all_to_all"] = any(
        op == "all_to_all_single" for op, _, _ in seen)
    checks["train_expert_data_no_expert_gather"] = not any(
        op.startswith("all_gather") and expert_shaped(shape, arc) for op, shape, _ in seen)

if rank == 0:
    torch.save(outputs, out + ".pt")
    with open(out, "w") as f:
        json.dump(checks, f)
else:
    bad = [k for k, v in checks.items() if not v]
    assert not bad, (rank, bad)
"""

PLACEMENTS = ("data", "experts", "ff", "expert_data", "pod_data")
PER_PLACEMENT = ("routes_equal", "prefill_logits_within_1e-5", "decode_tokens_equal",
                 "aux_within_1e-6", "meshed_bitwise", "no_expert_gather",
                 "jax_prefill_logits_within_1e-5", "jax_decode_tokens_equal",
                 "jax_aux_within_1e-5")
TRAINS = ("fsdp", "expert_data")
CLAIMS = ([f"{p}_{c}" for p in PLACEMENTS for c in PER_PLACEMENT]
          + ["placements_as_named", "expert_data_all_to_all", "pod_data_all_to_all",
             "engine_refuses_meshed_params_without_mesh"]
          + [f"train_{n}_{c}" for n in TRAINS
             for c in ("loss_within_1e-5", "leaves_within_1e-5", "leaves_keep_placements",
                       "jax_loss_within_1e-5", "jax_leaves_within_1e-5")]
          + ["train_fsdp_expert_leaves_fsdp_split", "train_fsdp_expert_gathers_over_data_only",
             "train_expert_data_all_to_all", "train_expert_data_no_expert_gather"])
B, T, STEPS, GROUP, TOL = 8, 16, 4, 16, 1e-5


def _configs() -> dict:
    """Each run's (port config, JAX config), as the ranks build them."""
    def both(arch, **moe):
        cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
        if moe:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
            jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe))
        return cfg, jcfg

    return {"data": both("moonshot-v1-16b-a3b"), "experts": both("mixtral-8x7b"),
            "ff": both("mixtral-8x7b", n_experts=3), "expert_data": both("arctic-480b"),
            "pod_data": both("arctic-480b"), "train_fsdp": both("mixtral-8x7b", expert_d_ff=256),
            "train_expert_data": both("arctic-480b")}


def _jax_params(cfg):
    """The port's seeded init (the ranks' weights) in JAX's layout."""
    tree = backbone_params_to_numpy(tbb.init_params(cfg, seed=0, device="cpu"), cfg)
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _jax_serve(cfg, jcfg) -> dict:
    """JAX's mesh-less prefill (its logits and aux) and STEPS greedy
    decode steps on the ranks' weights and prompts."""
    jp = _jax_params(cfg)
    gen = torch.Generator().manual_seed(3)
    tokens = jnp.asarray(torch.randint(0, cfg.vocab, (B, T), generator=gen).numpy(),
                         jnp.int32)
    logits, cache, depth = jbb.prefill(jcfg, jp, {"tokens": tokens}, max_len=T + STEPS + 1)
    x, _ = jbb._embed_inputs(jcfg, jp, {"tokens": tokens})
    _, aux, _ = jbb._run_superblocks(jcfg, jp, x, window=jcfg.sliding_window, dropless=True)
    step = jax.jit(lambda p, t, c, n: jbb.decode_step(jcfg, p, t, c, n))
    tok = jnp.argmax(logits, -1)
    toks = [tok]
    for i in range(STEPS):
        out, cache = step(jp, tok[:, None], cache, depth + i)
        tok = jnp.argmax(out, -1)
        toks.append(tok)
    return {"first": np.asarray(logits), "tokens": np.stack([np.asarray(t) for t in toks], 1),
            "aux": {k: float(v) for k, v in aux.items()}}


def _jax_train(cfg, jcfg) -> dict:
    """JAX's ``make_train_step`` on the ranks' weights and batch."""
    jp = _jax_params(cfg)
    gen = torch.Generator().manual_seed(4)
    batch = {k: jnp.asarray(torch.randint(0, cfg.vocab, (B, T), generator=gen).numpy(),
                            jnp.int32) for k in ("tokens", "labels")}
    shape = dataclasses.replace(jax_get_shape("train_4k"), global_batch=B, seq_len=T)
    opt = {"momentum": jax.tree_util.tree_map(jnp.zeros_like, jp)}
    p, o, m = jax.jit(jsteps.make_train_step(jcfg, shape))(jp, opt, batch)
    return {"loss": float(m["loss"]), "params": p, "momentum": o["momentum"]}


def _leaves_within(jtree, ttree, cfg) -> bool:
    """Every leaf of the port's tree (in JAX's layout) within TOL of the
    JAX leaf's largest |value|."""
    ref = jax.tree_util.tree_leaves(jtree)
    got = jax.tree_util.tree_leaves(backbone_params_to_numpy(ttree, cfg))
    return len(ref) == len(got) and all(
        r.shape == g.shape and float(np.abs(g.astype(np.float64) - np.asarray(r)).max())
        <= TOL * max(float(np.abs(np.asarray(r)).max()), 1e-30)
        for r, g in zip(ref, got))


def _jax_runs() -> dict:
    """JAX's serving and training runs, on the ranks' weights and inputs,
    its ``moe_apply`` routing in the ranks' groups."""
    configs = _configs()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbb, "moe_apply", functools.partial(jmoe.moe_apply, group_size=GROUP))
        runs = {name: _jax_serve(*configs[name]) for name in PLACEMENTS}
        runs.update({f"train_{n}": _jax_train(*configs[f"train_{n}"]) for n in TRAINS})
    return runs


def _against_jax(outputs, refs) -> dict:
    """The meshed port's outputs (rank 0's, whole) against JAX's."""
    checks = {}
    for name in PLACEMENTS:
        ref, got = refs[name], outputs[name]
        first = got["first"].numpy()
        checks[f"{name}_jax_prefill_logits_within_1e-5"] = float(
            np.abs(first - ref["first"]).max()) <= TOL * float(np.abs(ref["first"]).max())
        checks[f"{name}_jax_decode_tokens_equal"] = bool(
            np.array_equal(got["tokens"].numpy(), ref["tokens"]))
        checks[f"{name}_jax_aux_within_1e-5"] = sorted(got["aux"]) == sorted(ref["aux"]) \
            and all(abs(got["aux"][k] - ref["aux"][k]) <= TOL for k in ref["aux"])
    for name in TRAINS:
        cfg = _configs()[f"train_{name}"][0]
        ref, got = refs[f"train_{name}"], outputs[f"train_{name}"]
        checks[f"train_{name}_jax_loss_within_1e-5"] = \
            abs(got["loss"] - ref["loss"]) <= TOL * max(1.0, abs(ref["loss"]))
        checks[f"train_{name}_jax_leaves_within_1e-5"] = (
            _leaves_within(ref["params"], got["params"], cfg)
            and _leaves_within(ref["momentum"], got["momentum"], cfg))
    return checks


@pytest.fixture(scope="module")
def checks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_mesh")
    out = tmp / "checks.json"
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", SCRIPT, str(r), str(RANKS),
                               f"file://{tmp}/rendezvous", str(out)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(RANKS)]
    logs = []
    try:
        refs = _jax_runs()
        for p in procs:
            _, err = p.communicate(timeout=300)
            logs.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    failed = [(i, rc, err[-3000:]) for i, (rc, err) in enumerate(logs) if rc]
    assert not failed, failed
    outputs = torch.load(f"{out}.pt", weights_only=False)
    return {**json.loads(out.read_text()), **_against_jax(outputs, refs)}


def test_every_claim_was_checked(checks):
    assert sorted(checks) == sorted(CLAIMS)


@pytest.mark.parametrize("claim", CLAIMS)
def test_moe_mesh_claim(checks, claim):
    assert checks[claim], f"{claim}: {checks}"
