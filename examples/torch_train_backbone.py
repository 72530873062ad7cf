"""End-to-end training driver on the PyTorch port: train a reduced
backbone LM on synthetic Markov token data for a few hundred steps with
AdamW + cosine schedule, checkpointing every N steps (the port's
counterpart of ``train_backbone.py``).  Runs on the card unless
``--device cpu``; the checkpoint goes to the system's temporary directory
unless ``--ckpt`` names a path ('' writes none).

  PYTHONPATH=src python examples/torch_train_backbone.py --arch llama3.2-1b --steps 200
"""
import argparse
import os
import tempfile
import time

from repro_torch import resolve_device, value_and_grad
from repro_torch.checkpoint.io import save_checkpoint
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.data.synthetic import SyntheticTokens, TokenDatasetSpec
from repro_torch.models import backbone as bb
from repro_torch.nn.module import param_count
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.schedules import clip_by_global_norm, cosine_schedule


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=ASSIGNED_ARCHS)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt.npz"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    # effective vocab 64 (< model vocab) keeps the Markov table learnable
    # in a few hundred steps
    data = SyntheticTokens(TokenDatasetSpec(vocab=min(64, cfg.vocab),
                                            seq_len=args.seq + 1, n_modes=4))
    params = bb.init_params(cfg, seed=0, device=device)
    opt = adamw_init(params)
    print(f"{cfg.name}: {param_count(params) / 1e6:.2f}M params on {device.type}")

    def step(p, o, tokens, lr):
        batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        (loss, _), grads = value_and_grad(lambda pp: bb.forward_loss(cfg, pp, batch), p)
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        p, o = adamw_update(p, grads, o, lr=lr, weight_decay=0.01)
        return p, o, loss, gnorm

    t0 = time.time()
    for i in range(args.steps):
        toks = data.batch(args.batch, seed=i)
        lr = float(cosine_schedule(i, base_lr=args.lr, warmup=20,
                                   total=args.steps))
        params, opt, loss, gnorm = step(params, opt, toks, lr)
        if i % 20 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss {float(loss):.4f} "
                  f"gnorm {float(gnorm):.2f} lr {lr:.2e} "
                  f"({(time.time() - t0):.1f}s)")
        if args.ckpt and (i + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt, params)
            print(f"  checkpoint -> {args.ckpt}")
    print("done.")


if __name__ == "__main__":
    main()
