"""AgileNN split serving on an LM backbone, on the PyTorch port: train
the token-level extractor + local head + remote backbone jointly with the
skewness losses, then report the offload payload and local / remote /
combined accuracy (the port's counterpart of ``agile_lm_demo.py``).  Runs
on the card unless ``--device cpu``.

  PYTHONPATH=src python examples/torch_agile_lm_demo.py --arch qwen2-0.5b --steps 120
"""
import argparse
import dataclasses

import torch

from repro_torch import resolve_device, value_and_grad
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.configs.base import AgileSpec
from repro_torch.core.agile_lm import (
    _token_importance,
    agile_lm_forward,
    agile_lm_loss,
    extract_token_features,
    init_agile_lm_params,
    offload_payload_bits,
)
from repro_torch.core.skewness import achieved_skewness, disorder_rate
from repro_torch.data.synthetic import SyntheticTokens, TokenDatasetSpec
from repro_torch.optim.adamw import adamw_init, adamw_update


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=ASSIGNED_ARCHS)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--k", type=int, default=6)
    ap.add_argument("--rho", type=float, default=0.7)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(
        get_config(args.arch).reduced(),
        agile=AgileSpec(enabled=True, extractor_channels=32, k=args.k,
                        rho=args.rho, lam=0.4, ig_steps=4))
    data = SyntheticTokens(TokenDatasetSpec(vocab=32, seq_len=12, n_modes=2))
    device = resolve_device(args.device)
    params = init_agile_lm_params(cfg, 0, device=device)
    opt = adamw_init(params)

    def step(p, o, toks):
        (loss, m), g = value_and_grad(
            lambda pp: agile_lm_loss(cfg, pp, toks[:, :-1], toks[:, -1]), p)
        p, o = adamw_update(p, g, o, lr=5e-3, weight_decay=0.0)
        return p, o, loss, m

    for i in range(args.steps):
        toks = torch.as_tensor(data.batch(16, seed=i), device=device)
        params, opt, loss, m = step(params, opt, toks)
        if i % 30 == 0:
            print(f"step {i:4d} loss {float(loss):.3f} "
                  f"acc {float(m['accuracy']):.3f} "
                  f"skew_loss {float(m['loss_skewness']):.4f} "
                  f"alpha {float(m['alpha']):.3f}")

    # evaluation
    toks = torch.as_tensor(data.batch(128, seed=777_777), device=device)
    tokens, labels = toks[:, :-1], toks[:, -1].long()
    with torch.no_grad():
        logits, internals = agile_lm_forward(cfg, params, tokens, train=False)
    acc = float(torch.mean((torch.argmax(logits, -1) == labels).float()))
    acc_local = float(torch.mean(
        (torch.argmax(internals["local_logits"], -1) == labels).float()))
    acc_remote = float(torch.mean(
        (torch.argmax(internals["remote_logits"], -1) == labels).float()))
    feats = extract_token_features(params, tokens)
    imp = _token_importance(cfg, params["reference"], feats, labels, steps=4)
    print(f"\ncombined acc {acc:.3f} | local-only {acc_local:.3f} | "
          f"remote-only {acc_remote:.3f}")
    print(f"achieved skewness {float(achieved_skewness(imp, cfg.agile.k)):.3f} "
          f"(target {cfg.agile.rho}) | disorder rate "
          f"{float(disorder_rate(imp, cfg.agile.k)):.3f}")
    bits = offload_payload_bits(cfg, params, tokens[:1])
    print(f"offload payload per request: {bits} bits "
          f"({(32 - cfg.agile.k) * 32} fp32 bits uncompressed -> "
          f"{bits / ((32 - cfg.agile.k) * 32):.2f}x)")


if __name__ == "__main__":
    main()
