"""Quickstart on the PyTorch port: train AgileNN end-to-end (stages A-D)
on synthetic CIFAR-like data, then run the deployment-path offload
inference with full cost accounting (the port's counterpart of
``quickstart.py``).  Runs on the card unless ``--device cpu``.

  PYTHONPATH=src python examples/torch_quickstart.py [--steps 150]
"""
import argparse

from repro_torch import resolve_device
from repro_torch.configs.agilenn_cifar import AgileNNConfig
from repro_torch.configs.base import AgileSpec
from repro_torch.serve.offload import energy_per_inference, run_offload_inference
from repro_torch.train.agile_pipeline import run_full_pipeline


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--pretrain-steps", type=int, default=80)
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--rho", type=float, default=0.8)
    ap.add_argument("--xai", choices=("ig", "saliency"), default="ig")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)

    cfg = AgileNNConfig(
        image_size=16, remote_width=24, remote_blocks=2,
        reference_width=32, reference_blocks=3,
        agile=AgileSpec(enabled=True, extractor_channels=24, k=args.k,
                        rho=args.rho, lam=0.3, ig_steps=4))

    print("== AgileNN pipeline (stages A-D) ==")
    params, ref, report, history, data = run_full_pipeline(
        cfg, pretrain_steps=args.pretrain_steps, joint_steps=args.steps,
        batch_size=32, xai_method=args.xai, log_every=25,
        device=resolve_device(args.device))
    print(f"report: {report}")

    print("== deployment-path inference ==")
    images, labels = data.batch(16, seed=123_456)
    preds, cost = run_offload_inference(cfg, params, images)
    acc = float((preds == labels).mean())
    print(f"accuracy           : {acc:.3f}")
    for k, v in cost.as_dict.items():
        print(f"{k:18s}: {v:.4f}" if isinstance(v, float) else f"{k:18s}: {v}")
    print(f"energy_mJ          : {energy_per_inference(cfg, cost) * 1e3:.4f}")


if __name__ == "__main__":
    main()
