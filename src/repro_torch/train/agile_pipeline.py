"""The staged AgileNN training pipeline (paper §3-§5), as
``repro.train.agile_pipeline``.

Stage A  pre-processing: train [extractor + reference NN] end-to-end with
         plain CE to high accuracy; freeze the reference NN; keep the
         extractor weights as the joint-training initialization (§3.2).
Stage B  Algorithm 1: rank channels by top-k likelihood under XAI
         importance; build the mapping permutation (§5).
Stage C  joint training of extractor + Local NN + Remote NN + alpha +
         quantizer with L = lam*L_pred + (1-lam)*(L_skew + L_dis) (§4.2).
Stage D  deployment: fold the mapping layer into the extractor (§5).

Every stage runs on its params' device; ``run_full_pipeline`` on CUDA
unless ``device="cpu"`` is passed.  On the card each stage runs in
``repro_torch.fp32_math()`` (TF32 off).  The mapping is the port's static
tuple.  Initial weights come from a ``torch.Generator`` seeded with
``seed``, or from ``init=`` (e.g. bridged from the JAX package, whose
``PRNGKey`` draws the port cannot reproduce).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch import fp32_math, resolve_device, tree_leaves, tree_to, value_and_grad
from repro_torch.configs.agilenn_cifar import AgileNNConfig
from repro_torch.core.agile import (
    agile_forward,
    agile_loss,
    cross_entropy,
    extract_features,
    init_agile_params,
    reference_predict_fn,
)
from repro_torch.core.channel_selection import (
    build_mapping_permutation,
    fold_permutation_into_conv,
    permute_reference_stem,
    topk_channel_counts,
)
from repro_torch.core.skewness import achieved_skewness, disorder_rate
from repro_torch.core.xai import evaluate_importance
from repro_torch.data.synthetic import ImageDatasetSpec, SyntheticImages
from repro_torch.models.cnn import (
    extractor_apply,
    extractor_init,
    reference_nn_apply,
    reference_nn_init,
)
from repro_torch.optim.sgd import sgd_init, sgd_update


def _device_of(tree) -> torch.device:
    return tree_leaves(tree)[0].device


def _batch(data: SyntheticImages, batch_size: int, seed: int, device):
    """(images float32, labels int64) of ``data.batch`` on ``device``."""
    images, labels = data.batch(batch_size, seed=seed)
    return (torch.as_tensor(images, device=device),
            torch.as_tensor(labels, device=device).long())


def _accuracy(logits, labels) -> torch.Tensor:
    return torch.mean((torch.argmax(logits, -1) == labels).float())


# ------------------------------------------------------------- stage A -----
def pretrain_reference(cfg: AgileNNConfig, data: SyntheticImages, seed: int = 0,
                       *, steps: int = 300, batch_size: int = 64,
                       lr: float = 0.05, log_every: int = 0,
                       init: Optional[dict] = None, device=None):
    """Returns (extractor_params, reference_params, final train accuracy).

    init: {"ex": extractor params, "ref": reference params} to start from
    (moved to ``device``); default a fresh draw from ``seed``."""
    device = resolve_device(device)
    if init is None:
        gen = torch.Generator().manual_seed(seed)
        init = {"ex": extractor_init(gen, channels=cfg.extractor_channels,
                                     n_layers=cfg.extractor_layers),
                "ref": reference_nn_init(gen, cfg.extractor_channels,
                                         cfg.n_classes, width=cfg.reference_width,
                                         blocks=cfg.reference_blocks)}
    params = tree_to({"ex": init["ex"], "ref": init["ref"]}, device)
    opt = sgd_init(params)

    def loss_fn(p, images, labels):
        logits = reference_nn_apply(p["ref"], extractor_apply(p["ex"], images))
        return cross_entropy(logits, labels), _accuracy(logits, labels).detach()

    acc = 0.0
    with fp32_math():
        for i in range(steps):
            images, labels = _batch(data, batch_size, i, device)
            cur_lr = lr * (0.1 if i > steps * 0.7 else 1.0)
            (loss, acc), grads = value_and_grad(
                lambda p: loss_fn(p, images, labels), params)
            params, opt = sgd_update(params, grads, opt, lr=cur_lr)
            if log_every and i % log_every == 0:
                print(f"[stage A] step {i} loss {float(loss):.3f} acc {float(acc):.3f}")
    return params["ex"], params["ref"], float(acc)


# ------------------------------------------------------------- stage B -----
def run_channel_selection(cfg: AgileNNConfig, extractor_params, ref_params,
                          data: SyntheticImages, *, n_batches: int = 8,
                          batch_size: int = 64, method: str = "ig") -> tuple:
    """Algorithm 1 over the training set; returns the mapping permutation
    (a static tuple)."""
    device = _device_of(ref_params)
    predict = reference_predict_fn(cfg, ref_params)
    counts = torch.zeros(cfg.extractor_channels, device=device)
    total = 0
    with fp32_math():
        for i in range(n_batches):
            images, labels = _batch(data, batch_size, 1000 + i, device)
            with torch.no_grad():
                feats = extractor_apply(extractor_params, images)
            imp = evaluate_importance(predict, feats, labels, method=method,
                                      steps=cfg.agile.ig_steps)
            counts = counts + topk_channel_counts(imp, cfg.agile.k)
            total += batch_size
    p = counts.cpu().numpy() / total
    ranking = np.argsort(-p, kind="stable")
    return build_mapping_permutation(ranking[:cfg.agile.k], cfg.extractor_channels)


# ------------------------------------------------------------- stage C -----
def joint_step(cfg: AgileNNConfig, params, opt, ref_params, ref_opt, images,
               labels, *, mapping: tuple, lr: float, ref_track_lr: float = 0.01,
               xai_method: str = "ig", ordering: str = "disorder",
               lam: "float | None" = None):
    """One step of stage C: an SGD step on the unified loss, then the
    reference NN's tracking step (one CE step on the fresh, detached
    features).  ``params`` holds no mapping.  Returns
    (params, opt, ref_params, ref_opt, loss, metrics).

    The loss, its gradient and the update run in a torch.profiler range
    named ``joint_step.agile_loss``."""
    def loss_fn(p):
        return agile_loss(cfg, {**p, "mapping": mapping}, ref_params, images,
                          labels, xai_method=xai_method, ordering=ordering,
                          lam=lam)

    with record_function("joint_step.agile_loss"):
        (loss, metrics), grads = value_and_grad(loss_fn, params)
        params, opt = sgd_update(params, grads, opt, lr=lr)
    with torch.no_grad():
        feats = extract_features(cfg, {**params, "mapping": mapping}, images)
    _, rgrads = value_and_grad(
        lambda rp: (cross_entropy(reference_nn_apply(rp, feats), labels), None),
        ref_params)
    ref_params, ref_opt = sgd_update(ref_params, rgrads, ref_opt, lr=ref_track_lr)
    return params, opt, ref_params, ref_opt, loss, metrics


def joint_train(cfg: AgileNNConfig, params, ref_params,
                data: SyntheticImages, *, steps: int = 400,
                batch_size: int = 64, lr: float = 0.02,
                ref_track_lr: float = 0.01,
                xai_method: str = "ig", log_every: int = 0,
                record_curve: bool = False, ordering: str = "disorder",
                lam: "float | None" = None):
    """Joint training with the unified loss.

    The reference NN is *tracked*: each step it takes one CE step on the
    current (detached) features so its predictions — and therefore the XAI
    importance evaluation — stay accurate while the extractor drifts.

    Returns (params, ref_params, history)."""
    params = dict(params)
    mapping = params.pop("mapping")   # integer permutation: not trainable
    device = _device_of(params)
    opt = sgd_init(params)
    ref_opt = sgd_init(ref_params)
    history = []
    with fp32_math():
        for i in range(steps):
            images, labels = _batch(data, batch_size, 20_000 + i, device)
            cur_lr = lr * (0.1 if i > steps * 0.7 else 1.0)
            params, opt, ref_params, ref_opt, loss, metrics = joint_step(
                cfg, params, opt, ref_params, ref_opt, images, labels,
                mapping=mapping, lr=cur_lr, ref_track_lr=ref_track_lr,
                xai_method=xai_method, ordering=ordering, lam=lam)
            if record_curve or (log_every and i % log_every == 0):
                row = {k: float(v) for k, v in metrics.items()}
                row["step"] = i
                row["loss"] = float(loss)
                history.append(row)
                if log_every and i % log_every == 0:
                    print(f"[stage C] step {i} loss {row['loss']:.3f} "
                          f"acc {row['accuracy']:.3f} skew_loss {row['loss_skewness']:.3f}")
    params["mapping"] = mapping
    return params, ref_params, history


# ------------------------------------------------------------- stage D -----
def finalize_for_deployment(cfg: AgileNNConfig, params):
    """Fold the mapping permutation into the extractor's last conv (the
    mapping layer is discarded, §5 Figure 12)."""
    out = dict(params)
    convs = list(out["extractor"]["convs"])
    convs[-1] = fold_permutation_into_conv(convs[-1], params["mapping"])
    out["extractor"] = {"convs": convs}
    out["mapping"] = tuple(range(cfg.extractor_channels))
    return out


# ----------------------------------------------------------- evaluation ----
def evaluate(cfg: AgileNNConfig, params, ref_params, data: SyntheticImages, *,
             n_batches: int = 4, batch_size: int = 128,
             xai_method: str = "ig", alpha_override=None):
    """Test-set metrics: accuracy, achieved skewness, disorder rate.  The
    forward is the deployment path (on CUDA the fused offload kernel)."""
    device = _device_of(ref_params)
    predict = reference_predict_fn(cfg, ref_params)
    accs, skews, disorders = [], [], []
    with fp32_math():
        for i in range(n_batches):
            images, labels = _batch(data, batch_size, 900_000 + i, device)
            with torch.no_grad():
                logits, internals = agile_forward(cfg, params, images,
                                                  alpha_override=alpha_override)
            imp = evaluate_importance(predict, internals["features"], labels,
                                      method=xai_method, steps=cfg.agile.ig_steps)
            accs.append(float(_accuracy(logits, labels)))
            skews.append(float(achieved_skewness(imp, cfg.agile.k)))
            disorders.append(float(disorder_rate(imp, cfg.agile.k)))
    return {"accuracy": float(np.mean(accs)),
            "skewness": float(np.mean(skews)),
            "disorder_rate": float(np.mean(disorders))}


def run_full_pipeline(cfg: AgileNNConfig, *, seed: int = 0,
                      pretrain_steps: int = 300, joint_steps: int = 400,
                      batch_size: int = 64, xai_method: str = "ig",
                      log_every: int = 0, noise: float = 0.35,
                      ordering: str = "disorder", lam: "float | None" = None,
                      random_channels: bool = False,
                      init: Optional[dict] = None, device=None):
    """End-to-end stages A-D on ``device`` (CUDA by default; raises when
    CUDA is absent and no device was named).  Returns (params, ref_params,
    report, history, data).

    init: {"ex", "ref", "joint"} initial params (the joint tree's
    extractor is replaced by stage A's, as in JAX); default fresh draws,
    stage A's from ``seed`` and the joint model's from ``seed + 1``."""
    device = resolve_device(device)
    data = SyntheticImages(ImageDatasetSpec(
        n_classes=cfg.n_classes, image_size=cfg.image_size, noise=noise, seed=seed))

    ex_params, ref_params, ref_acc = pretrain_reference(
        cfg, data, seed, steps=pretrain_steps, batch_size=batch_size,
        log_every=log_every, init=init, device=device)
    if random_channels:   # Figure-11 ablation: arbitrary initial channels
        rng = np.random.RandomState(seed + 1)
        sel = rng.permutation(cfg.extractor_channels)[:cfg.agile.k]
        mapping = build_mapping_permutation(sel, cfg.extractor_channels)
    else:
        mapping = run_channel_selection(cfg, ex_params, ref_params, data,
                                        method=xai_method)
    ref_params = permute_reference_stem(ref_params, mapping)
    params = (tree_to(init["joint"], device) if init is not None
              else init_agile_params(cfg, seed + 1, device=device))
    params = {**params, "extractor": ex_params, "mapping": mapping}
    params, ref_params, history = joint_train(
        cfg, params, ref_params, data, steps=joint_steps,
        batch_size=batch_size, xai_method=xai_method, log_every=log_every,
        ordering=ordering, lam=lam, record_curve=True)
    params = finalize_for_deployment(cfg, params)
    report = evaluate(cfg, params, ref_params, data, xai_method=xai_method)
    report["reference_accuracy"] = ref_acc
    return params, ref_params, report, history, data
