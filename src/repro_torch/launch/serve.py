"""Serving launcher of the port: prefill + decode loop for an
architecture, a request queue through the continuous scheduler or the
streaming frontend, or a multi-client offload-gateway fleet run.  The
port of ``repro.launch.serve``: the same flags, scope errors, printed
lines and metric names, on one device.

  python -m repro_torch.launch.serve --arch qwen2-0.5b --tokens 32
  python -m repro_torch.launch.serve --arch qwen2-0.5b --local --tokens 8 \\
      --device cpu                 # reduced config on the CPU
  python -m repro_torch.launch.serve --arch qwen2-0.5b --queue 24 \\
      --lengths 64,256,512         # continuous-batching scheduler
  python -m repro_torch.launch.serve --arch qwen2-0.5b --queue 16 \\
      --lengths 64,256,512 --prefix-cache --kv-tier-mb 8
  python -m repro_torch.launch.serve --gateway 32 --requests 4 \\
      --slo-ms 40                  # simulated weak-device fleet -> gateway
  python -m repro_torch.launch.serve --gateway 32 --deadline-ms 150 \\
      --faults "blackout:0.05:0.2;burst;corrupt:0:1:0.3" --fault-seed 7
  python -m repro_torch.launch.serve --arch qwen2-0.5b --queue 24 \\
      --stream --max-queue 8 --priority mixed --preempt \\
      --journal journal.jsonl      # streaming frontend + request journal

Everything runs on ``--device`` (CUDA unless the CPU is named; without
CUDA and without ``--device cpu`` it raises as
``repro_torch.resolve_device`` does).  Weights are the port's seed-0
draws (``init_params(seed=0)``, ``init_agile_params(seed=0)``), not the
JAX package's; a queue's requests are drawn by ``np.random.RandomState(0)``
exactly as the JAX launcher draws them, so one argv gives both packages
the same queue, and the plain mode's prompt (and patches / frames) by a
``torch.Generator`` seeded 0.

Flags are scope-checked at parse time, as in the JAX launcher: a flag that
only applies to one mode is an argparse error (exit 2).

``--queue N --mesh DATA[,MODEL]`` serves the queue on a (DATA, MODEL)
mesh, one process a rank (torch's SPMD model): the slot pool shards over
DATA ranks and the params go tensor-parallel over MODEL
(``serve/scheduler.py``).  With ``--device cpu`` the ranks are DATA x MODEL
gloo processes spawned here; on CUDA they are NCCL processes, one a GPU,
and fewer visible GPUs than ranks raise (the mesh is never shrunk).  A
one-rank mesh runs in this process.  Rank 0 prints and dumps the metrics.
``--dry-run`` runs ``launch.dryrun.run_one`` for ``--arch`` / ``--shape``
(``--multi-pod``: the 512-rank mesh) and prints its record.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.configs.agilenn_cifar import gateway_demo_config
from repro_torch.core.agile import init_agile_params
from repro_torch.models import backbone as bb
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.faults import FaultInjector, parse_faults
from repro_torch.serve.frontend import (
    FirstToken,
    FrontendConfig,
    Overloaded,
    Priority,
    StreamingFrontend,
)
from repro_torch.serve.gateway import Fleet, GatewayConfig, OffloadGateway, mixed_fleet
from repro_torch.serve.recovery import RequestJournal
from repro_torch.serve.scheduler import SchedulerConfig
from repro_torch.serve.telemetry import Telemetry

# the plain mode's batch, as the JAX launcher's
PLAIN_B, PLAIN_T = 2, 16


def _dump_telemetry(tel, args) -> None:
    """End-of-run reporting, one path for every mode: the registry's
    Prometheus-style text goes to stderr, and --metrics-json /
    --trace-out persist the flat dump and the Chrome trace (load the
    trace in Perfetto / chrome://tracing)."""
    if getattr(args, "rank", 0):
        return                       # a meshed run's other ranks dump nothing
    text = tel.metrics.prometheus_text()
    if text:
        sys.stderr.write(text)
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(tel.metrics.to_dict(), f, indent=1, default=str)
        print(f"wrote {args.metrics_json}", file=sys.stderr)
    if args.trace_out:
        tel.trace.write(args.trace_out)
        print(f"wrote {args.trace_out} "
              f"({len(tel.trace.spans)} spans)", file=sys.stderr)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def mesh_dims(spec: str) -> tuple[int, int]:
    """--mesh DATA[,MODEL] as (data, model)."""
    dims = [int(x) for x in spec.split(",")]
    return dims[0], (dims[1] if len(dims) > 1 else 1)


def _serve_queue(cfg, params, args, tel, device, mesh=None) -> int:
    """Mixed-length request queue through the ServeEngine scheduler."""
    lengths = tuple(int(x) for x in args.lengths.split(","))
    rng = np.random.RandomState(0)
    shared = np.zeros((0,), np.int32)
    if args.prefix_cache:
        # shared-prefix workload: every prompt opens with the same
        # "system prompt" (page-aligned so it populates whole cache
        # pages) and diverges in its tail
        page = SchedulerConfig().page_size
        n_pages = max(1, max(lengths) // page)
        shared = rng.randint(0, cfg.vocab, n_pages * page)
    max_len = len(shared) + max(lengths) + args.tokens + 8
    eng = ServeEngine(cfg, params, max_len=max_len, telemetry=tel, device=device,
                      mesh=mesh, scheduler=SchedulerConfig(
                          buckets=tuple(len(shared) + b for b in lengths),
                          overlap=not args.serialized,
                          prefix_cache=args.prefix_cache,
                          kv_tier_mb=args.kv_tier_mb))
    reqs = [Request(tokens=np.concatenate(
                        [shared, rng.randint(0, cfg.vocab,
                                             rng.choice(lengths))]),
                    max_new_tokens=args.tokens)
            for _ in range(args.queue)]
    t0 = time.time()
    outs = eng.generate(reqs)
    _sync(device)
    dt = time.time() - t0
    toks = sum(len(c.tokens) for c in outs)
    topo = (f" on a ({mesh.shape[0]},{mesh.shape[1]}) mesh"
            if mesh is not None else "")
    print(f"served {len(reqs)} mixed-length requests{topo} "
          f"({toks} tokens) in {dt:.2f}s -> {toks / dt:.1f} tok/s")
    # end-of-run stats (prefix-cache tiers included) all flow through the
    # metrics dump
    m = tel.metrics
    m.gauge("serve.requests").set(len(reqs))
    m.gauge("serve.tokens").set(toks)
    m.gauge("serve.wall_s").set(dt)
    m.gauge("serve.tokens_per_s").set(toks / dt)
    eng.scheduler.export_metrics()
    _dump_telemetry(tel, args)
    return 0


def _serve_stream(cfg, params, args, tel, device, mesh=None) -> int:
    """Mixed-length queue through the overload-robust streaming frontend
    (bounded admission, priority classes, typed rejections)."""
    lengths = tuple(int(x) for x in args.lengths.split(","))
    rng = np.random.RandomState(0)
    prios = (list(Priority) if args.priority == "mixed"
             else [Priority.parse(args.priority)])
    journal = None
    if args.journal:
        journal = RequestJournal(args.journal, telemetry=tel)
    fe = StreamingFrontend(
        cfg, params,
        frontend=FrontendConfig(max_queue=args.max_queue,
                                slo_ms=args.slo_ms),
        sched=SchedulerConfig(buckets=lengths,
                              overlap=not args.serialized,
                              preempt=args.preempt),
        max_len=max(lengths) + args.tokens + 8, telemetry=tel,
        journal=journal, device=device, mesh=mesh)
    born = {}
    n_rej = 0
    t0 = time.time()
    for i in range(args.queue):
        req = Request(tokens=rng.randint(0, cfg.vocab, rng.choice(lengths)),
                      max_new_tokens=args.tokens)
        try:
            rid = fe.submit(req, prios[i % len(prios)])
            born[rid] = time.monotonic()
        except Overloaded as e:
            n_rej += 1
            print(f"  request {i}: {e}")
    results = fe.run()
    _sync(device)
    dt = time.time() - t0
    ttft = sorted((ev.t - born[ev.rid]) * 1e3 for ev in fe.events
                  if isinstance(ev, FirstToken))
    n_tok = sum(len(toks) for _, toks in results.values())
    by = {s: sum(st == s for st, _ in results.values())
          for s in ("served", "shed")}
    print(f"stream: {args.queue} requests (classes "
          f"{'/'.join(p.name.lower() for p in prios)}, "
          f"max_queue {args.max_queue}) -> "
          f"{by['served']} served, {by['shed']} shed, {n_rej} rejected; "
          f"{n_tok} tokens in {dt:.2f}s -> {n_tok / dt:.1f} tok/s"
          + (f"; ttft p50 {ttft[len(ttft) // 2]:.1f} ms" if ttft else ""))
    if journal is not None:
        journal.close()
        print(f"wrote {args.journal} ({len(journal.events)} journal "
              f"events)", file=sys.stderr)
    m = tel.metrics
    m.gauge("stream.tokens").set(n_tok)
    m.gauge("stream.wall_s").set(dt)
    m.gauge("stream.tokens_per_s").set(n_tok / dt)
    if ttft:
        m.gauge("stream.ttft_p50_ms").set(ttft[len(ttft) // 2])
    fe.sched.export_metrics()
    _dump_telemetry(tel, args)
    return 0


def _serve_gateway(args, tel, device) -> int:
    """Drive a simulated weak-device fleet through the offload gateway."""
    cfg = gateway_demo_config()
    params = init_agile_params(cfg, 0, device=device)
    specs = mixed_fleet(args.gateway, n_requests=args.requests,
                        slo_ms=args.slo_ms, deadline_ms=args.deadline_ms)
    fleet = Fleet(cfg, params, specs, seed=0)
    faults = (FaultInjector(parse_faults(args.faults), seed=args.fault_seed)
              if args.faults else None)
    report = OffloadGateway(
        cfg, params, fleet, GatewayConfig(batch_width=args.batch_width),
        faults=faults, telemetry=tel).run()
    mode = ("static rate" if args.slo_ms is None
            else f"adaptive rate, SLO {args.slo_ms:g} ms")
    if args.faults:
        mode += f", faults '{args.faults}' seed {args.fault_seed}"
    print(f"gateway: {args.gateway} clients x {args.requests} reqs "
          f"({mode}), pool width {args.batch_width}")
    # the report summary lands in the registry and flows out through the
    # same metrics dump every other mode uses
    m = tel.metrics
    for k, v in report.summary().items():
        if isinstance(v, dict):
            for sub, sv in v.items():
                m.gauge(f"gateway.{k}", channel=sub).set(sv)
        else:
            m.gauge(f"gateway.{k}").set(v)
    _dump_telemetry(tel, args)
    return 0


def plain_batch(cfg, device, *, B: int = PLAIN_B, T: int = PLAIN_T) -> dict:
    """The plain mode's batch, drawn by a torch.Generator seeded 0 on the
    CPU: tokens (B, T), and a VLM's patches / an enc-dec's frames (normal
    draws), on ``device``."""
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, T), generator=gen)}
    if cfg.vlm is not None:
        batch["patches"] = torch.randn((B, cfg.vlm.n_patches, cfg.vlm.vision_dim),
                                       generator=gen)
    if cfg.encdec is not None:
        batch["frames"] = torch.randn((B, cfg.encdec.n_frames, cfg.d_model),
                                      generator=gen)
    return {k: v.to(device) for k, v in batch.items()}


def serve_plain(cfg, params, batch, args, tel) -> np.ndarray:
    """Prefill ``batch``, then ``args.tokens`` greedy decode steps, as the
    JAX launcher's loop.  Returns the (B, args.tokens + 1) tokens: the
    prefill's argmax, then each step's."""
    B, T = batch["tokens"].shape
    with tel.span("prefill", track="engine", B=B, T=T):
        logits, cache, total_T = bb.prefill(cfg, params, batch,
                                            max_len=T + args.tokens + 8)
    tok = torch.argmax(logits, -1)[:, None]
    out = [tok]
    cl = total_T
    dev = tok.device
    _sync(dev)
    t0 = time.time()
    with tel.span("decode", track="engine", tokens=args.tokens):
        for _ in range(args.tokens):
            logits, cache = bb.decode_step(cfg, params, tok, cache, cl)
            tok = torch.argmax(logits, -1)[:, None]
            out.append(tok)
            cl += 1
        _sync(dev)
    dt = time.time() - t0
    tel.metrics.gauge("serve.tokens_per_s").set(args.tokens * B / dt)
    print(f"decoded {args.tokens} tokens x {B} in {dt:.2f}s")
    return torch.cat(out, dim=1).cpu().numpy()


# every mode-scoped flag: (flag, argparse dest, mode that enables it).
# checked against the parser defaults at parse time so that a flag which
# cannot take effect fails fast instead of being silently ignored
_SCOPED_FLAGS = (
    ("--lengths", "lengths", "queue"),
    ("--mesh", "mesh", "queue"),
    ("--serialized", "serialized", "queue"),
    ("--prefix-cache", "prefix_cache", "queue"),
    ("--kv-tier-mb", "kv_tier_mb", "queue"),
    ("--stream", "stream", "queue"),
    ("--priority", "priority", "stream"),
    ("--max-queue", "max_queue", "stream"),
    ("--preempt", "preempt", "stream"),
    ("--journal", "journal", "stream"),
    ("--requests", "requests", "gateway"),
    ("--batch-width", "batch_width", "gateway"),
    ("--deadline-ms", "deadline_ms", "gateway"),
    ("--faults", "faults", "gateway"),
    ("--fault-seed", "fault_seed", "gateway"),
)


def _validate_flags(ap, args) -> None:
    """Parse-time scope check: reject flag combinations that would be
    silently inapplicable (each scoped flag must ride with the mode flag
    that reads it).  --slo-ms is dual-scope: gateway rate control or the
    streaming frontend's admission budget."""
    if args.gateway and args.queue:
        ap.error("--gateway and --queue are separate modes; pick one")
    on = {"queue": bool(args.queue), "gateway": bool(args.gateway),
          "stream": bool(args.queue and args.stream)}
    for flag, dest, scope in _SCOPED_FLAGS:
        if getattr(args, dest) != ap.get_default(dest) and not on[scope]:
            need = {"queue": "--queue N", "gateway": "--gateway N",
                    "stream": "--stream (with --queue N)"}[scope]
            ap.error(f"{flag} only applies with {need}")
    if args.slo_ms is not None and not (on["gateway"] or on["stream"]):
        ap.error("--slo-ms only applies with --gateway N or with "
                 "--queue N --stream")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--multi-pod", action="store_true",
                    help="--dry-run on the (2, 16, 16) mesh")
    ap.add_argument("--dry-run", action="store_true",
                    help="run --arch / --shape on the production mesh on meta "
                         "tensors (launch.dryrun) and print its record")
    ap.add_argument("--local", action="store_true",
                    help="serve the reduced config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' runs on the CPU)")
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--queue", type=int, default=0, metavar="N",
                    help="serve N mixed-length requests through the "
                         "continuous-batching scheduler")
    ap.add_argument("--lengths", default="8,16,32",
                    help="comma-separated prompt-length mix for --queue")
    ap.add_argument("--mesh", default=None, metavar="DATA[,MODEL]",
                    help="serving mesh for --queue: the decode slot pool "
                         "shards over DATA ranks, params go tensor-"
                         "parallel over MODEL (default: unsharded)")
    ap.add_argument("--serialized", action="store_true",
                    help="disable the overlapped prefill/decode pipeline "
                         "(A/B baseline: host syncs every round)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share prompt-prefix KV pages across --queue "
                         "admissions (the queue's prompts then open with "
                         "a common system prompt); hits seed resident "
                         "pages and prefill only the suffix")
    ap.add_argument("--kv-tier-mb", type=float, default=0.0,
                    help="host cold-tier budget (MiB) for prefix pages "
                         "demoted off the device, compressed with the "
                         "quantize+bit-pack payload codec (0: demoted "
                         "pages are dropped)")
    ap.add_argument("--stream", action="store_true",
                    help="serve --queue through the overload-robust "
                         "streaming frontend (typed per-token events, "
                         "bounded admission, priority shedding)")
    ap.add_argument("--priority", default="interactive",
                    choices=["interactive", "batch", "best-effort",
                             "mixed"],
                    help="admission class for --stream requests "
                         "('mixed' cycles all three)")
    ap.add_argument("--max-queue", type=int, default=None, metavar="N",
                    help="bound on admitted-but-unscheduled requests for "
                         "--stream; past it submissions are rejected "
                         "with a retry-after hint (default: unbounded)")
    ap.add_argument("--preempt", action="store_true",
                    help="let --stream suspend the lowest-priority pooled "
                         "request when an interactive arrival would "
                         "otherwise wait for a free slot; the victim "
                         "re-enters its class queue with its generated-"
                         "so-far tokens preserved and resumes bit-"
                         "identically")
    ap.add_argument("--journal", default=None, metavar="PATH",
                    help="append-only crash-consistent request journal "
                         "for --stream (crc32-framed JSONL of submit/"
                         "admit/chunk/preempt/finish events); replayable "
                         "via repro_torch.serve.recovery.recover")
    ap.add_argument("--gateway", type=int, default=0, metavar="N",
                    help="simulate N weak-device clients through the "
                         "multi-client offload gateway")
    ap.add_argument("--requests", type=int, default=4,
                    help="inferences per gateway client")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="latency SLO: with --gateway, enables adaptive "
                         "rate control; with --stream, the queueing-"
                         "delay budget past which admission rejects")
    ap.add_argument("--batch-width", type=int, default=8,
                    help="gateway Remote-NN feature slot pool width")
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="scripted fault schedule for the gateway run: "
                         "';'-separated events, ':'-separated fields "
                         "(simulated seconds) — blackout[:t0:t1], "
                         "burst[:t0:t1[:pgb:pbg]] (Gilbert-Elliott burst "
                         "loss), degrade[:t0:t1[:scale[:loss]]], "
                         "devstall[:t0:t1[:s]], gwstall[:t0:t1[:s]], "
                         "corrupt[:t0:t1[:p]], stampede[:t0:t1[:f]] "
                         "(client arrivals compressed f-fold); e.g. "
                         "'blackout:0.05:0.2;burst;corrupt:0:1:0.3'")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed for the fault schedule's RNG streams "
                         "(same spec + seed replays identical faults)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline for gateway clients: the "
                         "radio stops retrying past it, late arrivals are "
                         "shed at admission, and the device degrades to "
                         "its Local-NN logits (default: no deadline)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome-trace JSON of the run's spans "
                         "(open in Perfetto / chrome://tracing); applies "
                         "to every mode")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write the end-of-run metrics registry as flat "
                         "JSON (the Prometheus-style text always goes to "
                         "stderr); applies to every mode")
    return ap


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    _validate_flags(ap, args)
    if args.gateway == 0 and args.arch is None:
        ap.error("--arch is required (unless --gateway N is given)")
    if args.dry_run and not args.gateway:
        from repro_torch.launch import dryrun

        print(dryrun.run_one(args.arch, args.shape, multi_pod=args.multi_pod))
        return 0
    device = resolve_device(args.device)
    if args.mesh:
        return _serve_meshed(args, sys.argv[1:] if argv is None else list(argv), device)
    return _serve(args, device)


def _serve(args, device, mesh=None) -> int:
    tel = Telemetry(enabled=True)

    if args.gateway:
        return _serve_gateway(args, tel, device)

    cfg = get_config(args.arch)
    if args.local:
        cfg = cfg.reduced()
    params = bb.init_params(cfg, seed=0, device=device)

    if args.queue:
        if args.stream:
            return _serve_stream(cfg, params, args, tel, device, mesh)
        return _serve_queue(cfg, params, args, tel, device, mesh)

    serve_plain(cfg, params, plain_batch(cfg, device), args, tel)
    _dump_telemetry(tel, args)
    return 0


def _serve_meshed(args, argv, device) -> int:
    """--queue on a --mesh DATA[,MODEL]: one rank in this process, more as
    spawned processes (gloo on the CPU, NCCL on CUDA, one GPU a rank)."""
    data, model = mesh_dims(args.mesh)
    ranks = data * model
    if device.type == "cuda" and torch.cuda.device_count() < ranks:
        raise RuntimeError(f"--mesh {args.mesh} needs {ranks} CUDA devices, "
                           f"{torch.cuda.device_count()} are visible")
    backend = "nccl" if device.type == "cuda" else "gloo"
    if ranks == 1:
        return _serve_rank(0, argv, 1, None, backend)
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_serve_rank, args=(argv, ranks, f"file://{tmp}/rendezvous",
                                              backend),
                           nprocs=ranks, start_method="spawn")
    return 0


def _serve_rank(rank: int, argv, ranks: int, init_method, backend: str) -> int:
    """One rank of a meshed --queue run: its process group, the mesh, the
    queue; ranks other than 0 print nothing and write no dump."""
    from repro_torch.launch.mesh import make_serving_mesh, process_group

    args = parser().parse_args(argv)
    args.rank = rank
    if rank:
        sys.stdout = open(os.devnull, "w")     # noqa: SIM115 - the rank's life
    if backend == "gloo":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // ranks))
    data, model = mesh_dims(args.mesh)
    with process_group(backend, world_size=ranks, rank=rank, init_method=init_method):
        device = torch.device("cuda", torch.cuda.current_device()) \
            if backend == "nccl" else torch.device("cpu")
        return _serve(args, device, make_serving_mesh(data=data, model=model))


if __name__ == "__main__":
    sys.exit(main())
