"""Spread of the AgileNN pipeline's report over seeds, in the JAX package
and in the PyTorch port, at ``tests/test_system.py``'s configuration
(16^2, remote 24 x 2, reference 32 x 3, ig_steps 4; 60 + 120 steps,
batch 32), on the CPU.

Per seed:
- ``jax``: the JAX package's ``run_full_pipeline(seed=s)``;
- ``jax_one_ulp``: the same stages with every float of stage A's initial
  extractor moved up one ulp (stage A written out here as the JAX
  package runs it; ``jax_stagewise_equal`` checks that, unperturbed, it
  gives ``jax``'s report exactly);
- ``port``: the port's ``run_full_pipeline(seed=s, init=...)`` from the
  same initial params (JAX's draws from ``PRNGKey(s)``, bridged), and
  ``port_one_ulp`` with the same one-ulp move;
- ``port_from_jax_stage_b``: the port's stages C and D alone, from JAX's
  stage-A weights and mapping.

``--trace`` adds, at the first seed, the two packages step by step:
the port's stage-A gradient and stage-C update computed from JAX's own
state at every step (teacher forcing), and the two free-running stage-A
trajectories' distance.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/train_report_spread.py \\
        --seeds 0 1 2 3 4 5 6 7 --trace --out train_spread.json
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.agilenn_cifar import AgileNNConfig as JaxConfig
from repro.configs.base import AgileSpec as JaxSpec
from repro.core import agile as jagile
from repro.core.channel_selection import permute_reference_stem as jpermute_stem
from repro.data.synthetic import ImageDatasetSpec as JaxDataSpec
from repro.data.synthetic import SyntheticImages as JaxImages
from repro.models import cnn as jcnn
from repro.nn.module import split_keys
from repro.optim.sgd import sgd_init as jsgd_init
from repro.optim.sgd import sgd_update as jsgd_update
from repro.train import agile_pipeline as jtrain
from repro_torch import tree_leaves, value_and_grad
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.agilenn_cifar import AgileNNConfig, AgileSpec
from repro_torch.core.agile import cross_entropy
from repro_torch.data.synthetic import ImageDatasetSpec, SyntheticImages
from repro_torch.models.cnn import extractor_apply, reference_nn_apply
from repro_torch.optim.sgd import sgd_init, sgd_update
from repro_torch.train import agile_pipeline as ttrain

_SYS = dict(image_size=16, remote_width=24, remote_blocks=2,
            reference_width=32, reference_blocks=3)
JCFG = JaxConfig(**_SYS, agile=JaxSpec(enabled=True, extractor_channels=24,
                                       k=5, rho=0.8, lam=0.3, ig_steps=4))
TCFG = AgileNNConfig(**_SYS, agile=AgileSpec(enabled=True, extractor_channels=24,
                                             k=5, rho=0.8, lam=0.3, ig_steps=4))
PRE, JOINT, BATCH, PRE_LR, JOINT_LR, TRACK_LR = 60, 120, 32, 0.05, 0.02, 0.01
KEYS = ("accuracy", "skewness", "disorder_rate", "reference_accuracy")
RUNS = ("jax", "jax_one_ulp", "port", "port_one_ulp", "port_from_jax_stage_b")


def jax_init(seed: int):
    """JAX's run_full_pipeline(seed) initial params, as numpy trees."""
    kk = split_keys(jax.random.PRNGKey(seed), ["pre", "joint"])
    k2 = split_keys(kk["pre"], ["ex", "ref"])
    init = {"ex": jcnn.extractor_init(k2["ex"], channels=24, n_layers=2),
            "ref": jcnn.reference_nn_init(k2["ref"], 24, 10,
                                          width=JCFG.reference_width,
                                          blocks=JCFG.reference_blocks)}
    init["joint"] = jagile.init_agile_params(JCFG, kk["joint"],
                                             extractor_params=init["ex"])
    return jax.tree_util.tree_map(np.asarray, init)


def one_ulp(tree):
    """Every float of the tree moved up one ulp."""
    return jax.tree_util.tree_map(
        lambda a: np.nextafter(a, np.float32(np.inf)).astype(a.dtype), tree)


def bridge(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def data_pair(seed: int):
    spec = dict(n_classes=10, image_size=JCFG.image_size, noise=0.35, seed=seed)
    return JaxImages(JaxDataSpec(**spec)), SyntheticImages(ImageDatasetSpec(**spec))


def _lr(base: float, i: int, steps: int) -> float:
    return base * (0.1 if i > steps * 0.7 else 1.0)


# ------------------------------------------------ the JAX package's steps ---
def _jax_ce(p, images, labels):
    logits = jcnn.reference_nn_apply(p["ref"], jcnn.extractor_apply(p["ex"], images))
    return jagile.cross_entropy(logits, labels), jnp.mean(
        (jnp.argmax(logits, -1) == labels).astype(jnp.float32))


@jax.jit
def jax_stage_a_step(p, o, images, labels, lr):
    """One step of the JAX package's ``pretrain_reference``."""
    (loss, acc), grads = jax.value_and_grad(_jax_ce, has_aux=True)(p, images, labels)
    p, o = jsgd_update(p, grads, o, lr=lr)
    return p, o, loss, acc, grads


def jax_stage_a(data, init):
    p = jax.tree_util.tree_map(jnp.asarray, {"ex": init["ex"], "ref": init["ref"]})
    o, acc = jsgd_init(p), 0.0
    for i in range(PRE):
        images, labels = data.batch(BATCH, seed=i)
        p, o, _, acc, _ = jax_stage_a_step(p, o, images, labels, _lr(PRE_LR, i, PRE))
    return p["ex"], p["ref"], float(acc)


def jax_stages(data, init):
    """JAX's run_full_pipeline stage by stage from ``init``; the report and
    stage B's (extractor, permuted reference, mapping)."""
    ex, ref, ref_acc = jax_stage_a(data, init)
    mapping = jtrain.run_channel_selection(JCFG, ex, ref, data, method="ig")
    stage_b = (ex, jpermute_stem(ref, mapping), mapping)
    params = jax.tree_util.tree_map(jnp.asarray, init["joint"])
    params = {**params, "extractor": ex, "mapping": jnp.asarray(mapping)}
    params, ref, _ = jtrain.joint_train(JCFG, params, stage_b[1], data, steps=JOINT,
                                        batch_size=BATCH, xai_method="ig")
    report = jtrain.evaluate(JCFG, jtrain.finalize_for_deployment(JCFG, params),
                             ref, data, xai_method="ig")
    report["reference_accuracy"] = ref_acc
    return {k: float(v) for k, v in report.items()}, stage_b


def port_run(seed: int, init_np):
    init = {k: params_from_numpy(v, device="cpu") for k, v in init_np.items()}
    return ttrain.run_full_pipeline(TCFG, seed=seed, init=init, device="cpu",
                                    pretrain_steps=PRE, joint_steps=JOINT,
                                    batch_size=BATCH)[2]


def port_from_stage_b(tdata, init_np, stage_b):
    ex, ref, mapping = stage_b
    params = {**bridge(init_np["joint"]), "extractor": bridge(ex),
              "mapping": tuple(int(p) for p in mapping)}
    params, ref, _ = ttrain.joint_train(TCFG, params, bridge(ref), tdata, steps=JOINT,
                                        batch_size=BATCH)
    return ttrain.evaluate(TCFG, ttrain.finalize_for_deployment(TCFG, params), ref,
                           tdata)


# ------------------------------------------------------------- the trace ---
def rel_diff(a, b) -> float:
    """Largest |a - b| over the leaves, each over the leaf's largest |a|."""
    return max(((x - y).abs().max() / x.abs().max().clamp_min(1e-30)).item()
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def update_rel(before, after, port) -> float:
    """Largest |port - after| over the leaves, each over JAX's largest
    |after - before| of the leaf (its update)."""
    return max(((t - a).abs().max() / (a - b).abs().max().clamp_min(1e-30)).item()
               for b, a, t in zip(tree_leaves(before), tree_leaves(after),
                                  tree_leaves(port)))


def port_stage_a_step(p, o, images, labels, lr):
    x, y = torch.as_tensor(images), torch.as_tensor(labels).long()
    (loss, _), grads = value_and_grad(lambda q: (cross_entropy(
        reference_nn_apply(q["ref"], extractor_apply(q["ex"], x)), y), None), p)
    p, o = sgd_update(p, grads, o, lr=lr)
    return p, o, loss, grads


def trace(seed: int):
    """Stage A: at every step the port's gradient from JAX's state, and the
    free-running port's params, against JAX's.  Stage C: at every step
    the port's ``joint_step`` from JAX's state (params, momenta, reference
    NN) against JAX's step, as a share of JAX's update of each leaf."""
    init = jax_init(seed)
    data, _ = data_pair(seed)
    jp = jax.tree_util.tree_map(jnp.asarray, {"ex": init["ex"], "ref": init["ref"]})
    jo = jsgd_init(jp)
    tp = bridge(jp)
    to = sgd_init(tp)
    stage_a = []
    for i in range(PRE):
        images, labels = data.batch(BATCH, seed=i)
        lr = _lr(PRE_LR, i, PRE)
        _, _, _, fgrads = port_stage_a_step(bridge(jp), bridge(jo), images, labels, lr)
        jp, jo, jloss, _, jgrads = jax_stage_a_step(jp, jo, images, labels, lr)
        tp, to, tloss, _ = port_stage_a_step(tp, to, images, labels, lr)
        stage_a.append({"step": i, "loss_jax": float(jloss), "loss_port_free": float(tloss),
                        "forced_grad_rel": rel_diff(bridge(jgrads), fgrads),
                        "free_params_rel": rel_diff(bridge(jp), tp)})
    ex, ref = jp["ex"], jp["ref"]
    mapping = jtrain.run_channel_selection(JCFG, ex, ref, data, method="ig")
    ref = jpermute_stem(ref, mapping)
    params = {**jax.tree_util.tree_map(jnp.asarray, init["joint"]), "extractor": ex}
    params.pop("mapping")
    jmap, tmap = jnp.asarray(mapping), tuple(int(p) for p in mapping)

    @jax.jit
    def joint_step(p, o, rp, ro, images, labels, lr):    # jtrain.joint_train's step
        def loss_fn(pp):
            return jagile.agile_loss(JCFG, {**pp, "mapping": jmap}, rp, images, labels,
                                     xai_method="ig")
        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        p, o = jsgd_update(p, grads, o, lr=lr)
        feats = jax.lax.stop_gradient(
            jagile.extract_features(JCFG, {**p, "mapping": jmap}, images))
        rgrads = jax.grad(lambda rpp: jagile.cross_entropy(
            jcnn.reference_nn_apply(rpp, feats), labels))(rp)
        rp, ro = jsgd_update(rp, rgrads, ro, lr=TRACK_LR)
        return p, o, rp, ro, loss

    o, ro = jsgd_init(params), jsgd_init(ref)
    stage_c = []
    for i in range(JOINT):
        images, labels = data.batch(BATCH, seed=20_000 + i)
        lr = _lr(JOINT_LR, i, JOINT)
        before = (bridge(params), bridge(ref))
        tp2, _, tr2, _, tloss, _ = ttrain.joint_step(
            TCFG, before[0], bridge(o), before[1], bridge(ro), torch.as_tensor(images),
            torch.as_tensor(labels).long(), mapping=tmap, lr=lr)
        params, o, ref, ro, jloss = joint_step(params, o, ref, ro, images, labels, lr)
        stage_c.append({"step": i, "loss_jax": float(jloss), "loss_port": float(tloss),
                        "update_rel_params": update_rel(before[0], bridge(params), tp2),
                        "update_rel_reference": update_rel(before[1], bridge(ref), tr2)})
    return {"stage_a": stage_a, "stage_c": stage_c}


def trace_summary(seed: int, tr: dict) -> dict:
    a, c = tr["stage_a"], tr["stage_c"]
    return {"seed": seed,
            "stage_a_forced_grad_rel_max": max(r["forced_grad_rel"] for r in a),
            "stage_a_free_params_rel": {r["step"]: r["free_params_rel"] for r in a
                                        if r["step"] in (0, 1, 2, 3, 4, 5, 10, 20, PRE - 1)},
            "stage_a_first_step_free_over_1e-3": next(
                (r["step"] for r in a if r["free_params_rel"] > 1e-3), None),
            "stage_c_loss_abs_max": max(abs(r["loss_jax"] - r["loss_port"]) for r in c),
            "stage_c_update_rel_params_max": max(r["update_rel_params"] for r in c),
            "stage_c_update_rel_reference_max": max(r["update_rel_reference"] for r in c)}


def spread(vals):
    return {"min": min(vals), "max": max(vals), "mean": statistics.fmean(vals),
            "stdev": statistics.stdev(vals) if len(vals) > 1 else 0.0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--threads", type=int, default=4, help="the port's CPU threads")
    ap.add_argument("--trace", action="store_true",
                    help="also trace both packages step by step at the first seed")
    ap.add_argument("--out", help="also write the record as JSON here")
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    record = {"config": {**_SYS, "ig_steps": 4, "pretrain_steps": PRE,
                         "joint_steps": JOINT, "batch_size": BATCH},
              "threads": args.threads, "rows": []}
    if args.trace:
        t0 = time.perf_counter()
        record["trace"] = trace(args.seeds[0])
        record["trace_summary"] = trace_summary(args.seeds[0], record["trace"])
        record["trace_summary"]["seconds"] = time.perf_counter() - t0
        print(json.dumps({"trace": record["trace_summary"]}), flush=True)
    for seed in args.seeds:
        t0 = time.perf_counter()
        init = jax_init(seed)
        data, tdata = data_pair(seed)
        jrep = {k: float(v) for k, v in jtrain.run_full_pipeline(
            JCFG, seed=seed, pretrain_steps=PRE, joint_steps=JOINT,
            batch_size=BATCH, xai_method="ig")[2].items()}
        jstage, stage_b = jax_stages(data, init)
        moved = {**init, "ex": one_ulp(init["ex"])}
        row = {"seed": seed, "jax": jrep, "jax_stagewise_equal": jstage == jrep,
               "jax_one_ulp": jax_stages(data, moved)[0],
               "port": port_run(seed, init), "port_one_ulp": port_run(seed, moved),
               "port_from_jax_stage_b": port_from_stage_b(tdata, init, stage_b)}
        row["seconds"] = time.perf_counter() - t0
        record["rows"].append(row)
        print(json.dumps(row), flush=True)
    rows = record["rows"]
    record["summary"] = {key: {name: spread([r[name][key] for r in rows])
                               for name in RUNS if key in rows[0][name]}
                         for key in KEYS}
    print(json.dumps({"summary": record["summary"]}))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
