"""Serve a small LLM backbone with batched requests on the PyTorch port:
prefill a batch of prompts, then decode tokens step by step (the paper's
Remote-NN role on the server; reduced config).  The port's counterpart of
``serve_split.py``; runs on the card unless ``--device cpu``.

  PYTHONPATH=src python examples/torch_serve_split.py --arch mixtral-8x7b --tokens 16
  PYTHONPATH=src python examples/torch_serve_split.py --device cpu
"""
import argparse
import time

import torch

from repro_torch import resolve_device, tree_leaves
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.launch.serve import plain_batch
from repro_torch.models import backbone as bb


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=ASSIGNED_ARCHS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    params = bb.init_params(cfg, seed=0, device=device)
    batch = plain_batch(cfg, device, B=args.batch, T=args.prompt_len)

    print(f"== prefill ({args.arch} reduced, B={args.batch}, "
          f"T={args.prompt_len}, {device.type}) ==")
    t0 = time.time()
    logits, cache, total_T = bb.prefill(
        cfg, params, batch, max_len=args.prompt_len + args.tokens + 8)
    print(f"prefill: {time.time() - t0:.2f}s, cache leaves: "
          f"{len(tree_leaves(cache))}")

    tok = torch.argmax(logits, -1)[:, None]
    out_tokens = [tok]
    cl = total_T
    t0 = time.time()
    for _ in range(args.tokens):
        logits, cache = bb.decode_step(cfg, params, tok, cache, cl)
        tok = torch.argmax(logits, -1)[:, None]
        out_tokens.append(tok)
        cl += 1
    gen = torch.cat(out_tokens, dim=1).cpu().numpy()
    dt = time.time() - t0
    print(f"decoded {args.tokens} tokens x {args.batch} reqs in {dt:.2f}s "
          f"({args.tokens * args.batch / dt:.1f} tok/s on {device.type})")
    print("generations (greedy, untrained weights):")
    for b in range(args.batch):
        print(f"  req{b}: {gen[b].tolist()}")


if __name__ == "__main__":
    main()
