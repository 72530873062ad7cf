"""The port's launchers (``repro_torch.launch.serve`` / ``train``) on the
CPU, against the JAX package's (``repro.launch.serve`` / ``train``).

- The 16 inapplicable-flag argvs of JAX's ``tests/test_frontend.py`` make
  the port's ``main`` exit 2.
- ``--mesh``, ``--dry-run`` and ``--multi-pod`` run: ``--queue 4 --mesh 2``
  on the CPU spawns 2 gloo ranks and serves every request on the (2, 1)
  mesh; ``--dry-run`` prints ``launch.dryrun.run_one``'s record (the
  256-rank mesh, meta tensors) and builds no model; ``--multi-pod``
  without ``--dry-run`` changes nothing, as in the JAX launchers; on CUDA
  a mesh of more ranks than visible GPUs raises.
- Plain mode: ``serve_plain`` on reduced qwen2-0.5b gives the greedy
  tokens of JAX's launcher loop (``serve.py``'s prefill and jitted
  ``decode_step``) on the same prompt and weights.
- ``--queue`` with the prefix cache and a cold-tier budget: the same
  requests (``np.random.RandomState(0)`` in both), the same greedy
  tokens, and metrics dumps that agree on every name (JAX's ``jit.*``
  compile counters have no torch counterpart) and on every value that is
  not a wall time; the trace is Chrome-trace JSON with spans.
- ``--gateway 4 --requests 2`` (static, and a chaos run) on JAX's bridged
  ``PRNGKey(0)`` weights: JAX's summary on its simulated fields (all but
  ``clients_per_s``, a wall-time rate).
- ``--stream``: every request served, shed or rejected, and the journal
  recovered with no request lost.
- ``launch.train --local`` over 2 steps: JAX's jitted step's losses
  within 1e-5 on the same weights and batches.

The weights are the port's seed-0 init moved to JAX by
``bridge.backbone_params_to_numpy`` (JAX's own init costs compiles that
the comparison does not need); the gateway's are JAX's, bridged.
"""
import argparse
import ast
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.agilenn_cifar import gateway_demo_config as jax_gateway_config  # noqa: E402
from repro.configs.base import InputShape as JaxShape  # noqa: E402
from repro.core.agile import init_agile_params as jax_init_agile  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import backbone as jbb  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.serve.telemetry import Telemetry as JaxTelemetry  # noqa: E402
from repro_torch.bridge import backbone_params_to_numpy, params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import get_shape  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import backbone as bb  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.serve.frontend import StreamingFrontend  # noqa: E402
from repro_torch.serve.recovery import RequestJournal, recover  # noqa: E402
from repro_torch.serve.scheduler import SchedulerConfig  # noqa: E402
from repro_torch.serve.telemetry import Telemetry  # noqa: E402

# values of the metrics dump that are wall times (or rates over one); of a
# histogram of wall times only the count is compared
WALL = {"serve.wall_s", "serve.tokens_per_s", "stream.wall_s", "stream.tokens_per_s",
        "stream.ttft_p50_ms", "gateway.clients_per_s", "gateway.codec_ms"}
# JAX's jitted train step's loss against the port's: float32 sums in another order
LOSS_TOL = 1e-5

# tests/test_frontend.py:396-413, as they stand
INAPPLICABLE = [
    ["--arch", "qwen2-0.5b", "--prefix-cache"],
    ["--arch", "qwen2-0.5b", "--serialized"],
    ["--slo-ms", "40"],
    ["--arch", "qwen2-0.5b", "--local", "--slo-ms", "40"],
    ["--arch", "qwen2-0.5b", "--queue", "4", "--max-queue", "2"],
    ["--arch", "qwen2-0.5b", "--queue", "4", "--priority", "batch"],
    ["--arch", "qwen2-0.5b", "--queue", "4", "--slo-ms", "40"],
    ["--arch", "qwen2-0.5b", "--preempt"],
    ["--arch", "qwen2-0.5b", "--queue", "4", "--preempt"],
    ["--arch", "qwen2-0.5b", "--journal", "j.jsonl"],
    ["--arch", "qwen2-0.5b", "--queue", "4", "--journal", "j.jsonl"],
    ["--gateway", "4", "--preempt"],
    ["--faults", "stampede"],
    ["--arch", "qwen2-0.5b", "--deadline-ms", "100"],
    ["--gateway", "4", "--queue", "4"],
    ["--gateway", "4", "--mesh", "2"],
]


@pytest.mark.parametrize("argv", INAPPLICABLE, ids=" ".join)
def test_launcher_rejects_inapplicable_flags(argv, monkeypatch):
    """Scoped flags outside their mode are parse-time errors (argparse
    exits 2), before any device is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as ei:
        serve.main(argv)
    assert ei.value.code == 2


def _meta_only(monkeypatch):
    """The dry-run draws no weight: only meta params may be built."""
    real = bb.init_params

    def init_params(cfg, seed=0, **kw):
        if kw.get("device") != "meta":
            pytest.fail("a model was built")
        return real(cfg, seed, **kw)

    monkeypatch.setattr(bb, "init_params", init_params)


def _dry_record(text: str) -> dict:
    rec = ast.literal_eval(text.strip().splitlines()[-1])
    assert {"arch", "shape", "mesh", "kind", "lower_s", "strategy", "compile_s",
            "memory", "collectives", "roofline"} <= set(rec)
    assert rec["memory"]["argument_bytes"] > 0 and rec["memory"]["peak_bytes"] is None
    return rec


@pytest.mark.parametrize("argv", [
    ["--arch", "qwen2-0.5b", "--local", "--queue", "4", "--mesh", "2"],
    ["--arch", "qwen2-0.5b", "--dry-run"],
    ["--arch", "qwen2-0.5b", "--multi-pod"],
    ["--arch", "qwen2-0.5b", "--shape", "prefill_32k", "--dry-run", "--device", "cpu"],
], ids=" ".join)
def test_mesh_flags_wait_for_7b_before_any_model(argv, capfd, monkeypatch):
    """Each argv runs on the CPU: the meshed queue on 2 spawned gloo ranks
    (rank 0 prints), the dry-runs without a model, and ``--multi-pod``
    alone as the plain reduced launch."""
    if "--dry-run" in argv:
        _meta_only(monkeypatch)
    extra = [] if "--dry-run" in argv else ["--device", "cpu"]
    extra += ["--local"] if "--multi-pod" in argv else []
    assert serve.main(argv + extra) == 0
    out = capfd.readouterr().out
    if "--mesh" in argv:
        assert "served 4 mixed-length requests on a (2,1) mesh (32 tokens)" in out
    elif "--dry-run" in argv:
        rec = _dry_record(out)
        shape = argv[argv.index("--shape") + 1] if "--shape" in argv else "decode_32k"
        assert (rec["arch"], rec["shape"], rec["mesh"]) == ("qwen2-0.5b", shape, "16x16")
        assert rec["roofline"]["chips"] == 256 and rec["collectives"]["total_bytes"] > 0
    else:
        assert "decoded 8 tokens x 2" in out


@pytest.mark.parametrize("argv", [["--arch", "qwen2-0.5b", "--dry-run"],
                                  ["--arch", "qwen2-0.5b", "--local", "--multi-pod"]],
                         ids=" ".join)
def test_train_dry_run_waits_for_7b(argv, capfd, monkeypatch):
    """``launch.train --dry-run`` prints train_4k's record on the 256-rank
    mesh (FSDP + TP) with no model built; ``--multi-pod`` without it trains
    the reduced config."""
    if "--dry-run" in argv:
        _meta_only(monkeypatch)
        assert train.main(argv) == 0
        rec = _dry_record(capfd.readouterr().out)
        assert (rec["shape"], rec["kind"], rec["mesh"]) == ("train_4k", "train", "16x16")
        assert rec["collectives"]["counts"]["reduce-scatter"] > 0
    else:
        assert train.main(argv + ["--steps", "1", "--device", "cpu"]) == 0
        assert "step 0 loss" in capfd.readouterr().out


@pytest.fixture(scope="module")
def model():
    """Reduced qwen2-0.5b: the port's seed-0 params and the same weights in
    JAX's layout."""
    cfg, jcfg = get_config("qwen2-0.5b").reduced(), jax_get_config("qwen2-0.5b").reduced()
    params = bb.init_params(cfg, seed=0, device="cpu")
    jparams = jax.tree_util.tree_map(jnp.asarray, backbone_params_to_numpy(params, cfg))
    return cfg, jcfg, params, jparams


def _args(argv) -> argparse.Namespace:
    ap = serve.parser()
    args = ap.parse_args(argv + ["--device", "cpu"])
    serve._validate_flags(ap, args)
    return args


def test_plain_mode_gives_jax_loop_tokens(model):
    cfg, jcfg, params, jparams = model
    args = _args(["--arch", "qwen2-0.5b", "--local", "--tokens", "6"])
    batch = serve.plain_batch(cfg, torch.device("cpu"))
    got = serve.serve_plain(cfg, params, batch, args, Telemetry(enabled=True))
    # serve.py's loop (prefill, then the jitted decode_step, greedy)
    B, T = batch["tokens"].shape
    logits, cache, total_T = jbb.prefill(jcfg, jparams,
                                         {"tokens": jnp.asarray(batch["tokens"].numpy())},
                                         max_len=T + args.tokens + 8)
    decode = jax.jit(lambda p, t, c, n: jbb.decode_step(jcfg, p, t, c, n))
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    want, cl = [tok], total_T
    for _ in range(args.tokens):
        logits, cache = decode(jparams, tok, cache, cl)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        want.append(tok)
        cl += 1
    assert got.shape == (B, args.tokens + 1)
    np.testing.assert_array_equal(got, np.concatenate([np.asarray(w) for w in want], 1))


def _capture(monkeypatch, cls):
    """Wrap ``cls.generate`` to keep each call's requests and tokens."""
    kept = []
    real = cls.generate

    def generate(self, requests):
        outs = real(self, requests)
        kept.append(([np.asarray(r.tokens).tolist() for r in requests],
                     [np.asarray(c.tokens).tolist() for c in outs]))
        return outs

    monkeypatch.setattr(cls, "generate", generate)
    return kept


def _comparable(dump: dict) -> dict:
    """The dump without JAX's compile counters, wall times as their
    histogram's count (None for a scalar)."""
    return {k: (v.get("count") if isinstance(v, dict) else None) if k in WALL else v
            for k, v in dump.items() if not k.startswith("jit.")}


def test_queue_mode_matches_jax(model, monkeypatch, tmp_path, capsys):
    cfg, jcfg, params, jparams = model
    argv = ["--arch", "qwen2-0.5b", "--local", "--queue", "6", "--tokens", "4",
            "--lengths", "8,16,32", "--prefix-cache", "--kv-tier-mb", "8"]
    args = _args(argv + ["--metrics-json", str(tmp_path / "m.json"),
                         "--trace-out", str(tmp_path / "t.json")])
    kept = _capture(monkeypatch, engine.ServeEngine)
    assert serve._serve_queue(cfg, params, args, Telemetry(enabled=True),
                              torch.device("cpu")) == 0
    port_line = capsys.readouterr().out
    jargs = _args(argv + ["--metrics-json", str(tmp_path / "jm.json")])
    jkept = _capture(monkeypatch, jengine.ServeEngine)
    assert jserve._serve_queue(jcfg, jparams, jargs, JaxTelemetry(enabled=True)) == 0
    assert kept == jkept                  # the same requests and greedy tokens
    assert port_line.startswith("served 6 mixed-length requests (24 tokens) in ")
    got = _comparable(json.loads((tmp_path / "m.json").read_text()))
    want = _comparable(json.loads((tmp_path / "jm.json").read_text()))
    assert got == want
    assert got["prefix.page_hits"] > 0
    trace = json.loads((tmp_path / "t.json").read_text())
    assert trace["traceEvents"] and all("ph" in ev for ev in trace["traceEvents"])


@pytest.mark.parametrize("argv", [
    ["--gateway", "4", "--requests", "2"],
    ["--gateway", "4", "--requests", "2", "--deadline-ms", "150", "--faults",
     "blackout:0.05:0.2;burst;corrupt:0:1:0.3", "--fault-seed", "7"],
], ids=["static", "chaos"])
def test_gateway_mode_summary_matches_jax(argv, monkeypatch):
    jp = jax_init_agile(jax_gateway_config(), jax.random.PRNGKey(0))
    bridged = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    monkeypatch.setattr(serve, "init_agile_params", lambda cfg, seed, device: bridged)
    args = _args(argv)
    tel, jtel = Telemetry(enabled=True), JaxTelemetry(enabled=True)
    assert serve._serve_gateway(args, tel, torch.device("cpu")) == 0
    assert jserve._serve_gateway(args, jtel) == 0
    got, want = (_comparable(t.metrics.to_dict()) for t in (tel, jtel))
    assert got == want
    assert got["gateway.requests"] == 8


def test_stream_mode_accounts_for_every_request_and_recovers(tmp_path, capsys):
    journal = tmp_path / "j.jsonl"
    assert serve.main(["--arch", "qwen2-0.5b", "--local", "--queue", "8", "--tokens", "3",
                       "--stream", "--max-queue", "4", "--priority", "mixed", "--preempt",
                       "--journal", str(journal), "--device", "cpu"]) == 0
    line = [s for s in capsys.readouterr().out.splitlines() if s.startswith("stream:")][0]
    counts = line.split("-> ")[1].split(";")[0].split(", ")
    n = {c.split(" ")[1]: int(c.split(" ")[0]) for c in counts}
    assert n["served"] + n["shed"] + n["rejected"] == 8 and n["served"] > 0
    events = RequestJournal.read(str(journal))
    cfg = get_config("qwen2-0.5b").reduced()
    fe = StreamingFrontend(cfg, bb.init_params(cfg, seed=0, device="cpu"),
                           sched=SchedulerConfig(buckets=(8, 16, 32)), max_len=43,
                           device="cpu")
    merged = recover(fe, events)
    submitted = {rec["rid"] for rec in events if rec["ev"] == "submit"}
    assert len(submitted) == n["served"] + n["shed"] and submitted <= set(merged)


def test_train_local_losses_match_jax(model, capsys):
    cfg, jcfg, params, jparams = model
    shape = train.dataclasses.replace(get_shape("train_4k"), global_batch=train.LOCAL_B,
                                      seq_len=train.LOCAL_T)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)      # the CPU's embedding backward is bitwise on one thread
    try:
        losses = train.train(cfg, params, shape, 2, torch.device("cpu"))
    finally:
        torch.set_num_threads(threads)
    assert "step 1 loss" in capsys.readouterr().out
    step = jax.jit(jsteps.make_train_step(
        jcfg, JaxShape("train_4k", train.LOCAL_T, train.LOCAL_B, "train"), lr=1e-3))
    p, opt = jparams, {"momentum": jax.tree_util.tree_map(jnp.zeros_like, jparams)}
    for i, loss in enumerate(losses):
        batch = {k: jnp.asarray(v.numpy()) for k, v in
                 train.make_batch(cfg, train.LOCAL_B, train.LOCAL_T, i, "cpu").items()}
        p, opt, metrics = step(p, opt, batch)
        assert abs(loss - float(metrics["loss"])) <= LOSS_TOL, (i, loss, metrics["loss"])


def test_train_main_runs_each_family_locally(capsys):
    """--local for a VLM and an enc-dec: their batches carry patches /
    frames, and every loss is finite."""
    for arch in ("internvl2-1b", "whisper-tiny"):
        assert train.main(["--arch", arch, "--local", "--steps", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("step 0 loss") == 2 and "nan" not in out


def test_mesh_on_cuda_needs_its_gpus(monkeypatch):
    """On CUDA ``--mesh D,M`` takes D x M GPUs, one NCCL rank each: with
    fewer visible it raises, naming the count, before any model is built;
    it never shrinks the mesh."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(bb, "init_params", lambda *a, **k: pytest.fail("a model was built"))
    with pytest.raises(RuntimeError, match="needs 4 CUDA devices, 1 are visible"):
        serve.main(["--arch", "qwen2-0.5b", "--local", "--queue", "4", "--mesh", "2,2"])
