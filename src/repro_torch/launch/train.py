"""Training launcher of the port: the LM train step
(``launch/steps.py::make_train_step``, SGD-momentum, lr 1e-3) for a few
steps on one device.  The port of ``repro.launch.train``.

  python -m repro_torch.launch.train --arch qwen2-0.5b --local --steps 10
  python -m repro_torch.launch.train --arch qwen2-0.5b --local --steps 3 \\
      --device cpu                 # reduced config on the CPU

``--local`` trains the reduced config on batches of 4 x 32 tokens;
without it the config at full size takes ``--shape``'s global batch and
sequence (train_4k: 256 x 4,096, one microbatch for qwen2-0.5b, whose
activations alone outgrow one 80 GB card).  Step i's tokens and labels
are uniform draws of a ``torch.Generator`` seeded i (the VLM's patches
and the enc-dec's frames normal draws of one seeded 0), weights the port's
seed-0 draws.  Runs on ``--device`` (CUDA unless the CPU is named; without
CUDA and without ``--device cpu`` it raises as
``repro_torch.resolve_device`` does).  ``--dry-run`` runs
``launch.dryrun.run_one`` for ``--arch`` / ``--shape`` on the production
mesh (``--multi-pod``: the 512-rank one) on meta tensors and prints its
record, building no model.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.configs.shapes import get_shape
from repro_torch.launch.steps import make_train_step, opt_init
from repro_torch.models import backbone as bb

# the reduced run's batch, as the JAX launcher's
LOCAL_B, LOCAL_T = 4, 32


def make_batch(cfg, B: int, T: int, step: int, device) -> dict:
    """Step ``step``'s batch on ``device``: tokens and labels (B, T)
    uniform over the vocabulary from a CPU ``torch.Generator`` seeded
    ``step``; a VLM's patches (B, P, vision_dim) and an enc-dec's frames
    (B, F, d) normal draws of one seeded 0, the same every step (the JAX
    launcher draws them from its fixed key)."""
    gen = torch.Generator().manual_seed(step)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, T), generator=gen),
             "labels": torch.randint(0, cfg.vocab, (B, T), generator=gen)}
    extra = torch.Generator().manual_seed(0)
    if cfg.vlm is not None:
        batch["patches"] = torch.randn((B, cfg.vlm.n_patches, cfg.vlm.vision_dim),
                                       generator=extra)
    if cfg.encdec is not None:
        batch["frames"] = torch.randn((B, cfg.encdec.n_frames, cfg.d_model),
                                      generator=extra)
    return {k: v.to(device) for k, v in batch.items()}


def train(cfg, params, shape, steps: int, device) -> list[float]:
    """``steps`` train steps of ``make_train_step(cfg, shape, lr=1e-3)``
    from ``params`` on ``make_batch``'s batches; prints each step's loss
    and returns the losses."""
    opt = opt_init(params)
    step = make_train_step(cfg, shape, lr=1e-3)
    losses = []
    for i in range(steps):
        batch = make_batch(cfg, shape.global_batch, shape.seq_len, i, device)
        t0 = time.time()
        params, opt, metrics = step(params, opt, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        print(f"step {i} loss {loss:.4f} ({time.time() - t0:.2f}s)")
    return losses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true",
                    help="--dry-run on the (2, 16, 16) mesh")
    ap.add_argument("--dry-run", action="store_true",
                    help="run --arch / --shape on the production mesh on meta "
                         "tensors (launch.dryrun) and print its record")
    ap.add_argument("--local", action="store_true",
                    help="train the reduced config on 4 x 32 tokens")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)
    if args.dry_run:
        from repro_torch.launch import dryrun

        print(dryrun.run_one(args.arch, args.shape, multi_pod=args.multi_pod))
        return 0
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.local:
        cfg = cfg.reduced()
    shape = get_shape(args.shape)
    if args.local:
        shape = dataclasses.replace(shape, global_batch=LOCAL_B, seq_len=LOCAL_T)
    params = bb.init_params(cfg, seed=0, device=device)
    train(cfg, params, shape, args.steps, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
