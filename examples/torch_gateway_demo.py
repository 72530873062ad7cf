"""A 32-client weak-device fleet driving the offload gateway on the
PyTorch port (the port's counterpart of ``gateway_demo.py``).

Every client runs the AgileNN local path (extractor + top-k split +
quantize + LZW) on an STM32-class device model, ships its feature
payload over a WiFi / narrowband / lossy-WiFi link mix, and the gateway
batches arrivals into fixed-width Remote-NN calls.  Run twice (static
rate, then adaptive rate against a latency SLO) and compare the per-link
latency, payload and device-energy accounting.  Runs on the card unless
``--device cpu``.

  PYTHONPATH=src python examples/torch_gateway_demo.py --clients 32 --slo-ms 30
"""
import argparse

from repro_torch import resolve_device
from repro_torch.configs.agilenn_cifar import gateway_demo_config
from repro_torch.core.agile import init_agile_params
from repro_torch.serve.gateway import Fleet, GatewayConfig, OffloadGateway, mixed_fleet


def run_once(cfg, params, args, slo_ms):
    specs = mixed_fleet(args.clients, n_requests=args.requests,
                        slo_ms=slo_ms)
    fleet = Fleet(cfg, params, specs, seed=args.seed)
    gw = OffloadGateway(cfg, params, fleet,
                        GatewayConfig(batch_width=args.batch_width))
    return fleet, gw.run()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=32)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch-width", type=int, default=8)
    ap.add_argument("--slo-ms", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)

    cfg = gateway_demo_config()
    params = init_agile_params(cfg, args.seed, device=resolve_device(args.device))

    print(f"== static rate ({args.clients} clients x {args.requests} reqs, "
          f"pool width {args.batch_width}) ==")
    _, static = run_once(cfg, params, args, None)
    for k, v in static.summary().items():
        print(f"  {k}: {v}")

    print(f"== adaptive rate (SLO {args.slo_ms:g} ms) ==")
    fleet, adaptive = run_once(cfg, params, args, args.slo_ms)
    for k, v in adaptive.summary().items():
        print(f"  {k}: {v}")
    print("  final rate-ladder level per client:",
          [c.controller.level for c in fleet.clients])

    s, a = static.summary(), adaptive.summary()
    print(f"adaptive vs static: payload {a['payload_bytes_mean']:.1f}B vs "
          f"{s['payload_bytes_mean']:.1f}B, device energy "
          f"{a['device_energy_mj']:.3f}mJ vs {s['device_energy_mj']:.3f}mJ")


if __name__ == "__main__":
    main()
