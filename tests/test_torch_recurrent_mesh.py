"""The port's meshed Mamba, xLSTM cells and sequence-split decode attention
(``nn/ssm.py``, ``nn/xlstm.py``, ``kernels/decode_attention/ops.py``) on
the JAX package's placements, on 4 gloo ranks on the CPU.

Cases (reduced configs, float32; params by ``param_shardings``, the decode
cache of a mesh-less prefill at ``max_len`` 24 distributed by
``cache_shardings``, so the model axis divides its 24 slots):

  * ``jamba_seq``: jamba-1.5-large-398b on a (1, 4) mesh: d_inner split
    4 ways, its 2 kv heads do not divide the model axis, so the K/V cache
    splits its slots, and the ssm state splits d_state.  Before the
    repair this case lost the decode step's K/V write (written into a
    gathered copy of the sequence-split cache) and gave other tokens;
  * ``jamba_square``: jamba on (2, 2): the kv heads split;
  * ``xlstm_square``: xlstm-350m on (2, 2): 4 heads, whole on each rank's
    columns, the state's value axis split, m split over the heads;
  * ``xlstm_2head``: xlstm-350m with 2 heads on (1, 4): each head's 128
    columns split 4 ways, as xlstm-350m's 4 heads on a 16-way axis;
  * ``qwen_seq``: qwen2-0.5b on (1, 4): the sequence split alone.

Against the mesh-less port on the same weights and prompts (B = 4, T =
16): the meshed prefill's logits and the logits of 4 greedy decode steps
within 1e-5 of their scale (the bar of the MoE's mesh tests), except the
xLSTM's, held to tests/test_torch_xlstm.py's bar: 8 x JAX's own spread
one ulp away, or 1e-5 of the scale, whichever is wider; the tokens equal;
two meshed runs bitwise.  Against JAX's mesh-less ``prefill`` and jitted
``decode_step`` on the same weights (the port's init bridged) and
prompts, greedy: the logits within the same bars, the tokens equal (the
xLSTM's spread from JAX's run one ulp away, teacher-forced on JAX's
tokens).

One train step each of jamba and xlstm-350m under
``param_shardings(fsdp=True)`` on (2, 2), against ``make_train_step`` on
one process: the loss within 1e-5; every new momentum leaf within 1e-5 of
its layer's scale (tests/test_torch_jamba.py's gradient bar) or, for the
xLSTM, 1e-5 of JAX's or 8 x JAX's one-ulp spread where wider
(tests/test_torch_xlstm.py's: an xLSTM's gradients move by up to 2e-3 of
a leaf's scale when only the summation order changes, on a mesh that
splits no model axis too); every new param within 1e-5 of its layer's
scale plus lr times that bar; each leaf at its placement.  The same step
against JAX's jitted ``make_train_step`` on the same weights and batch:
the loss within 1e-5, every new momentum leaf within JAX's spread bars
(1e-5 of the layer's scale or 8 x JAX's one-ulp spread, whichever is
wider: both tests' ``spread_bars``) and every new param within 1e-5 of
its layer's scale plus lr times that bar.

The collectives (a dispatch mode over the functional collectives): no
all-gather outputs a Mamba or xLSTM param, whole or gathered over the
model axis, or a K/V cache leaf; in training such params are gathered
over the data group only.

The ranks run once, in subprocesses sharing a ``file://`` store under
tmp_path, each on one torch thread; rank 0 writes the checks to JSON and
its outputs to a file while this process runs JAX; each claim is its own
test below.
"""
import dataclasses
import json
import os
import re
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
from repro_torch.bridge import backbone_params_to_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import backbone as tbb  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RANKS = 4
B, T, STEPS, MAX_LEN, TOL, ULP_SPREAD = 4, 16, 4, 24, 1e-5, 8

SCRIPT = r"""
import dataclasses, json, sys
import torch
torch.set_num_threads(1)
from repro_torch import sharded, tree_leaves, tree_map
from repro_torch.configs import get_config
from repro_torch.configs.shapes import get_shape
from repro_torch.launch import partition
from repro_torch.launch.mesh import make_serving_mesh, process_group
from repro_torch.launch.steps import make_train_step, opt_init
from repro_torch.models import backbone as bb
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
B, T, STEPS, MAX_LEN = 4, 16, 4, 24
KINDS = ("all_gather_into_tensor", "all_reduce", "reduce_scatter_tensor", "all_to_all_single")
checks = {}
outputs = {}


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


def whole(t):
    return t.full_tensor() if sharded.is_dtensor(t) else t


def configs():
    xl = get_config("xlstm-350m").reduced()
    return {"jamba_seq": (get_config("jamba-1.5-large-398b").reduced(), (1, 4)),
            "jamba_square": (get_config("jamba-1.5-large-398b").reduced(), (2, 2)),
            "xlstm_square": (xl, (2, 2)),
            "xlstm_2head": (dataclasses.replace(xl, n_heads=2, n_kv_heads=2), (1, 4)),
            "qwen_seq": (get_config("qwen2-0.5b").reduced(), (1, 4))}


def recurrent_shapes(cfg, params, sh):
    # each Mamba / xLSTM param's shape whole and with its model split
    # gathered (its data split kept): what no all-gather may output;
    # and its block after the data-axis gather, which FSDP may
    full, model_whole, data_gathered = set(), set(), set()
    for p, s in zip(tree_leaves([b.get("mamba", b.get("cell")) for b in params["blocks"]
                                 if "mamba" in b or "cell" in b]),
                    tree_leaves([b.get("mamba", b.get("cell")) for b in sh["blocks"]
                                 if "mamba" in b or "cell" in b])):
        shape = tuple(p.shape)
        full.add(shape)
        mw, dg = list(shape), list(shape)
        for d, e in enumerate(s.spec):
            names = (e,) if isinstance(e, str) else tuple(e or ())
            for n in names:
                k = s.mesh.size(s.mesh.mesh_dim_names.index(n))
                if n == "model":
                    dg[d] //= k
                else:
                    mw[d] //= k
        if mw != list(shape):
            model_whole.add(tuple(mw))
        if dg != list(shape):
            data_gathered.add(tuple(dg))
    return full | model_whole, data_gathered


def kv_gathered(shape, cfg):
    # an all-gather output that is a K/V cache leaf, or one layer's, with
    # its slots whole
    return len(shape) >= 4 and shape[-1] == cfg.resolved_head_dim and shape[-3] == MAX_LEN


def decode(cfg, params, first, cache, depth, mesh=None):
    # STEPS greedy decode steps from prefill logits ``first``; (logits, tokens)
    tok = torch.argmax(first, dim=-1)
    toks, logits = [tok], []
    with sharded.host_replicated(mesh):
        for _ in range(STEPS):
            t = tok[:, None]
            if mesh is not None:
                t = partition.batch_spec(mesh, 2).distribute(t)
            lg, cache = bb.decode_step(cfg, params, t, cache, depth)
            lg = whole(lg)
            logits.append(lg)
            tok = torch.argmax(lg, dim=-1)
            toks.append(tok)
            depth += 1
    return torch.stack(logits, 1), torch.stack(toks, 1)


def serve(name, cfg, mesh):
    params = bb.init_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab, (B, T), generator=gen)
    first, cache, depth = bb.prefill(cfg, params, {"tokens": tokens}, max_len=MAX_LEN)
    saved = tree_map(lambda t: t.clone(), cache)      # decode_step writes in place
    ref_logits, ref_toks = decode(cfg, params, first, cache, depth)
    sh = partition.param_shardings(params, mesh, cfg=cfg)
    dp = partition.distribute(params, sh)
    csh = partition.cache_shardings(saved, mesh, batch=B, cfg=cfg)
    runs = []
    for _ in range(2):
        with Collectives() as coll, sharded.host_replicated(mesh):
            batch = {"tokens": partition.batch_spec(mesh, 2).distribute(tokens)}
            mfirst, _, _ = bb.prefill(cfg, dp, batch, max_len=MAX_LEN)
            mfirst = whole(mfirst)
            dc = partition.distribute(tree_map(lambda t: t.clone(), saved), csh)
            logits, toks = decode(cfg, dp, first, dc, depth, mesh)
        runs.append((mfirst, logits, toks, coll.seen))
    (mfirst, logits, toks, seen), again = runs
    checks[f"{name}_tokens_equal"] = bool(torch.equal(toks, ref_toks))
    checks[f"{name}_meshed_bitwise"] = all(bool(torch.equal(a, b))
                                           for a, b in zip(runs[0][:3], again[:3]))
    bad, _ = recurrent_shapes(cfg, params, sh)
    checks[f"{name}_no_param_or_kv_gather"] = not any(
        op.startswith("all_gather") and (shape in bad or kv_gathered(shape, cfg))
        for op, shape, _ in seen)
    outputs[name] = {"first": first, "logits": ref_logits, "tokens": ref_toks,
                     "mesh_first": mfirst, "mesh_logits": logits, "mesh_tokens": toks}
    if "k" in csh:
        outputs[name]["kv_spec"] = str(csh["k"].spec)


def train(name, cfg, mesh):
    params = bb.init_params(cfg, seed=0, device="cpu")
    shape = dataclasses.replace(get_shape("train_4k"), global_batch=B, seq_len=T)
    gen = torch.Generator().manual_seed(4)
    batch = {k: torch.randint(0, cfg.vocab, (B, T), generator=gen) for k in ("tokens", "labels")}
    step = make_train_step(cfg, shape)
    p1, o1, m1 = step(params, opt_init(params), batch)
    sh = partition.param_shardings(params, mesh, cfg=cfg, fsdp=True)
    dp = partition.distribute(params, sh)
    bs = partition.batch_spec(mesh, 2)
    with Collectives() as coll:
        p2, o2, m2 = step(dp, opt_init(dp), {k: bs.distribute(v) for k, v in batch.items()})
    checks[f"train_{name}_leaves_keep_placements"] = all(
        tuple(a.placements) == tuple(b.placements)
        for a, b in zip(tree_leaves(dp), tree_leaves(p2)))
    bad, data_gathered = recurrent_shapes(cfg, params, sh)
    data_group = mesh.get_group(0).group_name
    gathers = [(shape, g) for op, shape, g in coll.seen if op.startswith("all_gather")]
    checks[f"train_{name}_no_model_axis_param_gather"] = not any(s in bad for s, _ in gathers)
    checks[f"train_{name}_param_gathers_over_data_only"] = (
        bool(data_gathered) and all(g == data_group for s, g in gathers if s in data_gathered))
    outputs[f"train_{name}"] = {
        "loss": float(m1["loss"]), "mesh_loss": float(m2["loss"].full_tensor()),
        "params": p1, "momentum": o1["momentum"],
        "mesh_params": tree_map(whole, p2), "mesh_momentum": tree_map(whole, o2["momentum"])}


with process_group("gloo", world_size=world, rank=rank, init_method=init):
    meshes = {(1, 4): make_serving_mesh(data=1, model=4),
              (2, 2): make_serving_mesh(data=2, model=2)}
    for name, (cfg, shape) in configs().items():
        serve(name, cfg, meshes[shape])
    train("jamba", get_config("jamba-1.5-large-398b").reduced(), meshes[2, 2])
    train("xlstm", get_config("xlstm-350m").reduced(), meshes[2, 2])

if rank == 0:
    torch.save(outputs, out + ".pt")
    with open(out, "w") as f:
        json.dump(checks, f)
else:
    bad = [k for k, v in checks.items() if not v]
    assert not bad, (rank, bad)
"""

CASES = ("jamba_seq", "jamba_square", "xlstm_square", "xlstm_2head", "qwen_seq")
PER_CASE = ("prefill_logits_within_bar", "decode_logits_within_bar", "tokens_equal",
            "meshed_bitwise", "no_param_or_kv_gather", "jax_prefill_logits_within_bar",
            "jax_decode_logits_within_bar", "jax_tokens_equal")
TRAIN_CLAIMS = ("loss_within_1e-5", "leaves_within_bar", "leaves_keep_placements",
                "no_model_axis_param_gather", "param_gathers_over_data_only",
                "jax_loss_within_1e-5", "jax_leaves_within_bar")
LR = 1e-3                       # make_train_step's
CLAIMS = ([f"{c}_{k}" for c in CASES for k in PER_CASE]
          + [f"train_{n}_{k}" for n in ("jamba", "xlstm") for k in TRAIN_CLAIMS]
          + ["jamba_seq_cache_splits_the_sequence"])


def _configs() -> dict:
    """Each serving case's (port config, JAX config)."""
    def both(arch, **kw):
        cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
        return dataclasses.replace(cfg, **kw), dataclasses.replace(jcfg, **kw)

    return {"jamba_seq": both("jamba-1.5-large-398b"),
            "jamba_square": both("jamba-1.5-large-398b"),
            "xlstm_square": both("xlstm-350m"),
            "xlstm_2head": both("xlstm-350m", n_heads=2, n_kv_heads=2),
            "qwen_seq": both("qwen2-0.5b")}


def _ulp(tree):
    """The JAX tree with every float leaf nudged one ulp toward +inf."""
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.nextafter(np.asarray(a), np.float32(np.inf))), tree)


def _jax_serve(cfg, jcfg) -> dict:
    """JAX's mesh-less prefill and STEPS greedy decode steps on the ranks'
    weights and prompts, and for an xLSTM the same one ulp away (the
    spread of its logits, teacher-forced on the same tokens)."""
    jp = jax.tree_util.tree_map(
        jnp.asarray, backbone_params_to_numpy(tbb.init_params(cfg, seed=0, device="cpu"), cfg))
    gen = torch.Generator().manual_seed(3)
    tokens = jnp.asarray(torch.randint(0, cfg.vocab, (B, T), generator=gen).numpy(), jnp.int32)
    step = jax.jit(lambda p, t, c, n: jbb.decode_step(jcfg, p, t, c, n))
    runs, toks = [], None
    for p in ((jp, _ulp(jp)) if cfg.xlstm is not None else (jp,)):
        first, cache, depth = jbb.prefill(jcfg, p, {"tokens": tokens}, max_len=MAX_LEN)
        tok, logits, greedy = jnp.argmax(first, -1), [], []
        for i in range(STEPS):
            greedy.append(tok)
            out, cache = step(p, (tok if toks is None else toks[:, i])[:, None], cache,
                              depth + i)
            logits.append(np.asarray(out))
            tok = jnp.argmax(out, -1)
        greedy.append(tok)
        if toks is None:
            toks = jnp.stack(greedy, 1)
        runs.append((np.asarray(first), np.stack(logits, 1)))
    spread = [0.0, 0.0] if len(runs) == 1 else [
        float(np.abs(a - b).max()) for a, b in zip(runs[0], runs[1])]
    return {"first": runs[0][0], "logits": runs[0][1], "tokens": np.asarray(toks),
            "spread": spread}


def _layers(tree) -> dict:
    """{group: [leaf]} of a tree in JAX's layout: the leaves of blocks[j]
    (stacked over superblocks, so a layer) together, every other leaf
    alone (tests/test_torch_xlstm.py's groups)."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        key = jax.tree_util.keystr(path)
        m = re.match(r"\['blocks'\]\[(\d+)\]", key)
        out.setdefault(m.group(1) if m else key, []).append(np.asarray(leaf, np.float64))
    return out


def _jax_train(arch) -> dict:
    """JAX's ``make_train_step`` on the ranks' weights and batch: its loss,
    new params and momentum, and {layer group: bar} of the momentum: TOL
    of the layer's largest |value| or, where wider, ULP_SPREAD x how far
    the step moves the layer's momentum when every weight is nudged one
    ulp (tests/test_torch_jamba.py's and tests/test_torch_xlstm.py's
    ``spread_bars``)."""
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    jp = jax.tree_util.tree_map(
        jnp.asarray, backbone_params_to_numpy(tbb.init_params(cfg, seed=0, device="cpu"), cfg))
    gen = torch.Generator().manual_seed(4)
    batch = {k: jnp.asarray(torch.randint(0, cfg.vocab, (B, T), generator=gen).numpy(),
                            jnp.int32) for k in ("tokens", "labels")}
    shape = dataclasses.replace(jax_get_shape("train_4k"), global_batch=B, seq_len=T)
    step = jax.jit(jsteps.make_train_step(jcfg, shape))
    (p1, o1, m1), (_, nudged, _) = (
        step(p, {"momentum": jax.tree_util.tree_map(jnp.zeros_like, p)}, batch)
        for p in (jp, _ulp(jp)))
    ref, moved = _layers(o1["momentum"]), _layers(nudged["momentum"])
    bars = {g: max(TOL * max(float(np.abs(r).max()) for r in leaves),
                   ULP_SPREAD * max(float(np.abs(r - n).max()) for r, n in zip(leaves, moved[g])))
            for g, leaves in ref.items()}
    return {"loss": float(m1["loss"]), "params": p1, "momentum": o1["momentum"], "bars": bars}


def _scale_bars(tree) -> dict:
    """{layer group: TOL x the layer's largest |value|} of a tree in JAX's
    layout."""
    return {g: TOL * max(float(np.abs(r).max()) for r in leaves)
            for g, leaves in _layers(tree).items()}


def _within(ref, got, bars: dict, extra=None) -> bool:
    """Every leaf of ``got`` within its layer's bar (plus ``extra``'s) of
    ``ref``'s, both trees in JAX's layout."""
    a, b = _layers(ref), _layers(got)
    return sorted(a) == sorted(b) and all(
        r.shape == t.shape and float(np.abs(t - r).max()) <= bars[g] + (extra or {}).get(g, 0.0)
        for g in a for r, t in zip(a[g], b[g]))


def _step_within(ref, got, bars: dict) -> bool:
    """A train step's new momentum within ``bars`` of ``ref``'s and its new
    params within 1e-5 of their layer's scale plus lr times ``bars``
    (tests/test_torch_jamba.py's and tests/test_torch_xlstm.py's bars)."""
    return (_within(ref["momentum"], got["momentum"], bars)
            and _within(ref["params"], got["params"], _scale_bars(ref["params"]),
                        extra={g: LR * b for g, b in bars.items()}))


def _bar(ref, spread) -> float:
    return max(TOL * float(np.abs(ref).max()), ULP_SPREAD * spread)


def _checks(outputs, refs) -> dict:
    """The meshed port (rank 0's outputs) against the mesh-less port and
    against JAX's runs."""
    checks = {}
    for name in CASES:
        ref = refs[name]
        got = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
               for k, v in outputs[name].items()}
        fbar, dbar = _bar(got["first"], ref["spread"][0]), _bar(got["logits"], ref["spread"][1])
        checks[f"{name}_prefill_logits_within_bar"] = float(
            np.abs(got["mesh_first"] - got["first"]).max()) <= fbar
        checks[f"{name}_decode_logits_within_bar"] = float(
            np.abs(got["mesh_logits"] - got["logits"]).max()) <= dbar
        checks[f"{name}_jax_prefill_logits_within_bar"] = float(
            np.abs(got["mesh_first"] - ref["first"]).max()) <= _bar(ref["first"], ref["spread"][0])
        checks[f"{name}_jax_decode_logits_within_bar"] = float(
            np.abs(got["mesh_logits"] - ref["logits"]).max()) <= _bar(ref["logits"],
                                                                       ref["spread"][1])
        checks[f"{name}_jax_tokens_equal"] = bool(np.array_equal(got["mesh_tokens"],
                                                                 ref["tokens"]))
    for name, arch in (("jamba", "jamba-1.5-large-398b"), ("xlstm", "xlstm-350m")):
        got, jax_ref = outputs[f"train_{name}"], refs[f"train_{name}"]
        cfg = get_config(arch).reduced()
        port = {k: backbone_params_to_numpy(got[k], cfg) for k in ("params", "momentum")}
        mesh = {k: backbone_params_to_numpy(got[f"mesh_{k}"], cfg) for k in ("params", "momentum")}
        # against the one-process port: jamba at 1e-5 of the port's layer
        # scale, the xLSTM at JAX's spread bars (the summation order alone
        # moves its gradients further)
        bars = jax_ref["bars"] if name == "xlstm" else _scale_bars(port["momentum"])
        checks[f"train_{name}_loss_within_1e-5"] = abs(got["mesh_loss"] - got["loss"]) <= TOL
        checks[f"train_{name}_leaves_within_bar"] = _step_within(port, mesh, bars)
        checks[f"train_{name}_jax_loss_within_1e-5"] = (
            abs(got["mesh_loss"] - jax_ref["loss"]) <= TOL * max(1.0, abs(jax_ref["loss"])))
        checks[f"train_{name}_jax_leaves_within_bar"] = _step_within(
            jax_ref, mesh, jax_ref["bars"])
    checks["jamba_seq_cache_splits_the_sequence"] = (
        outputs["jamba_seq"]["kv_spec"] == str((None, "data", "model", None, None)))
    return checks


@pytest.fixture(scope="module")
def checks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("recurrent_mesh")
    out = tmp / "checks.json"
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", SCRIPT, str(r), str(RANKS),
                               f"file://{tmp}/rendezvous", str(out)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(RANKS)]
    logs = []
    try:
        runs = {}
        for name in CASES:            # the two jamba cases share weights and prompts
            cfg, jcfg = _configs()[name]
            if cfg not in runs:
                runs[cfg] = _jax_serve(cfg, jcfg)
        refs = {name: runs[_configs()[name][0]] for name in CASES}
        for name, arch in (("jamba", "jamba-1.5-large-398b"), ("xlstm", "xlstm-350m")):
            refs[f"train_{name}"] = _jax_train(arch)
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
    return {**json.loads(out.read_text()), **_checks(outputs, refs)}


def test_every_claim_was_checked(checks):
    assert sorted(checks) == sorted(CLAIMS)


@pytest.mark.parametrize("claim", CLAIMS)
def test_recurrent_mesh_claim(checks, claim):
    assert checks[claim], f"{claim}: {checks}"
