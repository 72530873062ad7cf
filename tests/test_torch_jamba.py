"""The port's Mamba hybrid on the CPU against the JAX package: the
depthwise causal ``conv1d`` (``nn/linear.py``), the Mamba block's chunked
scan, its returned state and its one-token decode step (``nn/ssm.py``),
then reduced jamba-1.5-large-398b (one superblock: attention at index 0
and 7 Mamba blocks, MoE FFNs at the odd layers with 4 experts top-2,
dense SwiGLU at the even ones; d 256, float32) on bridged weights:
``forward_loss`` and every gradient leaf, one ``make_train_step``,
``prefill`` / ``decode_step`` with the K/V and ``mamba_conv`` /
``mamba_ssm`` caches, ``init_cache`` and the greedy tokens of
``ServeEngine.generate``; within the port, remat on and off bitwise and
the chunked scan against its sequential oracle ``mamba_reference``.  The
refusals a hybrid keeps, as in JAX: ``cache_window(long_context=True)``
leaves its context whole, ``prefill_chunk`` and a bucketed ``prefill``
refuse it, and the continuous scheduler keeps it off its mixed path.

The model's weights are the port's seeded init, moved to JAX in its
layout by ``bridge.backbone_params_to_numpy`` (the tree of JAX's own
init, leaf for leaf, ``conv_w`` transposed back to (d_conv, 1, d_inner))
and back into the port by ``backbone_params_from_numpy``.  JAX's gradient
is read off one jitted ``make_train_step`` (its ``jax.value_and_grad``):
with zero momentum in and no weight decay, the momentum out is the
gradient itself.  The tests run on one torch thread (the CPU embedding
backward is not deterministic across threads, and remat's bitwise check
needs it).

Tolerances, each with its reason:
- module outputs and states, the loss and its metrics at 1e-5: float32
  sums in another order (JAX's log-step ``associative_scan`` within a
  chunk against the port's sequential loop; XLA:CPU's exp differs from
  torch.exp by an ulp in some entries, and the decays compound it);
- the model's gradients, caches and logits: within 1e-5 of their layer's
  scale, or within ULP_SPREAD times JAX's own spread one ulp away,
  whichever is wider (``spread_close``; a layer is the leaves of one
  sublayer, the embedding, the final norm and the readout each alone).
  The spread is how far JAX's float32 result moves when every weight is
  nudged one ulp.  Measured port-to-JAX on the CPU: 3.7-6.1e-6 of the
  layer's scale in every layer (the worst leaf, dt_proj's, at 1.4e-5 of
  its own scale: the softplus step's gradient runs through every decay of
  the scan), against bars of 2.1-3.8e-5 (JAX's spread x 8 is the wider);
- a train step's new params at 1e-5 of their layer's scale plus lr times
  the momentum's bar;
- the chunked scan against the sequential oracle at 2e-4, prefill then
  decode against the oracle at 3e-4: the reference's own bars
  (``tests/test_recurrent.py``);
- greedy tokens exactly.
"""
import dataclasses
import functools
import re

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import InputShape as JaxShape  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import backbone as jbb  # noqa: E402
from repro.nn import linear as jlin  # noqa: E402
from repro.nn import ssm as jssm  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch import tree_leaves, tree_map, value_and_grad  # noqa: E402
from repro_torch.bridge import backbone_params_from_numpy, backbone_params_to_numpy  # noqa: E402
from repro_torch.configs import ASSIGNED_ARCHS, get_config, list_configs  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import backbone as tbb  # noqa: E402
from repro_torch.nn import linear as tlin  # noqa: E402
from repro_torch.nn import ssm as tssm  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.scheduler import supports_continuous_batching  # noqa: E402

TOL, CHUNK_TOL, DECODE_TOL, ULP_SPREAD = 1e-5, 2e-4, 3e-4, 8
ARCH = "jamba-1.5-large-398b"
B, T, PROMPT, NEW, DECODE, MAX_LEN = 2, 24, 12, 6, 4, 40
STEP_KW = dict(lr=0.05, momentum=0.9, weight_decay=0.0, n_micro_override=1)
# tests/test_recurrent.py's Mamba cases: (B, T, d, chunk)
MAMBA_CASES = [(2, 19, 32, 8), (1, 16, 16, 16), (1, 7, 8, 4)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: remat's bitwise check needs it, these shapes gain
    nothing from the pool, and under several test workers each pool
    oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.RandomState(seed).standard_normal(shape)).astype(np.float32)


def close(ref, got, tol=TOL):
    """got (a tensor) within tol abs + rel of ref (a JAX or numpy array)."""
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


def _mamba_params(d: int, seed: int = 2):
    """The port's ``mamba_init`` at width d from ``seed`` and JAX's copy of
    it, moved by the bridge (JAX's eager init costs seconds of compiling;
    ``test_jamba_layers_and_params`` holds the two inits' trees equal)."""
    p = tssm.mamba_init(torch.Generator().manual_seed(seed), d)
    one_layer = dataclasses.replace(get_config("qwen2-0.5b").reduced(), n_layers=1)
    tree = backbone_params_to_numpy({"blocks": [{"mamba": p}]}, one_layer)
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), tree["blocks"][0]["mamba"]), p


def _ulp(tree):
    """The JAX tree with every float leaf nudged one ulp toward +inf."""
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.nextafter(np.asarray(a), np.float32(np.inf))), tree)


def _layers(tree) -> dict:
    """{group: [(key, leaf)]} of a tree in JAX's layout: the leaves of
    blocks[j] together, every other leaf alone."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        key = jax.tree_util.keystr(path)
        m = re.match(r"\['blocks'\]\[(\d+)\]", key)
        out.setdefault(m.group(1) if m else key, []).append((key, np.asarray(leaf, np.float64)))
    return out


def spread_bars(ref, nudged) -> dict:
    """{group: absolute bar}: max(TOL x the group's largest |value|,
    ULP_SPREAD x its largest change one ulp away) over ``_layers``."""
    a, b = _layers(ref), _layers(nudged)
    return {g: max(TOL * max(float(np.abs(r).max()) for _, r in leaves),
                   ULP_SPREAD * max(float(np.abs(r - n).max())
                                    for (_, r), (_, n) in zip(leaves, b[g])))
            for g, leaves in a.items()}


def spread_close(ref, got, bars: dict, extra: dict | None = None) -> None:
    """Every leaf of ``got`` (JAX's layout) within its group's bar (plus
    ``extra``'s) of ``ref``'s."""
    a, b = _layers(ref), _layers(got)
    assert sorted(a) == sorted(b)
    for g, leaves in a.items():
        bar = bars[g] + (extra or {}).get(g, 0.0)
        for (key, r), (gkey, t) in zip(leaves, b[g]):
            assert key == gkey and r.shape == t.shape, (key, gkey)
            err = float(np.abs(t - r).max())
            assert err <= bar, f"{key}: {err:.3e} > {bar:.3e}"


# --------------------------------------------------------------- modules ---
@pytest.mark.parametrize("padding,groups,stride", [("SAME", 1, 1), ("SAME", 2, 2),
                                                   ("VALID", 6, 1), ("VALID", 1, 2)])
def test_conv1d_matches_jax(padding, groups, stride):
    """``conv1d`` in both paddings, grouped (groups = C: depthwise) and
    strided, within 1e-5 of JAX's ``conv1d_apply`` on its own weights
    transposed WIO -> OIW; the port's ``conv1d_init`` draws (out, in /
    groups, kernel) at JAX's fan (kernel x in / groups)."""
    C, O, K = 6, 12 if groups < 6 else 6, 4
    jp = jlin.conv1d_init(jax.random.PRNGKey(1), C // groups, O, K)
    jp["b"] = jnp.asarray(_normal((O,), 3, 0.1))
    x = _normal((2, 11, C), 4)
    want = jlin.conv1d_apply(jp, jnp.asarray(x), stride=stride, padding=padding,
                             feature_group_count=groups)
    p = {"w": torch.tensor(np.asarray(jp["w"]).transpose(2, 1, 0)),
         "b": torch.tensor(np.asarray(jp["b"]))}
    close(want, tlin.conv1d(p, torch.tensor(x), stride=stride, padding=padding,
                            groups=groups))
    tp = tlin.conv1d_init(torch.Generator().manual_seed(0), C, O, K, groups=groups)
    assert tuple(tp["w"].shape) == (O, C // groups, K) and torch.equal(tp["b"], torch.zeros(O))
    assert float(tp["w"].abs().max()) <= 2 * (2.0 / (K * C // groups)) ** 0.5
    with pytest.raises(ValueError, match="padding"):
        tlin.conv1d(p, torch.tensor(x), padding="CAUSAL", groups=groups)


@pytest.mark.parametrize("B_,T_,d,chunk", MAMBA_CASES)
def test_mamba_apply_matches_jax(B_, T_, d, chunk):
    """The block over a sequence (T off the chunk, on it, and past it) and
    its returned state (the last 3 pre-conv inputs, the SSM state) within
    1e-5 of JAX's; within the port the chunked scan gives the sequential
    oracle's output at the reference's bar."""
    jp, p = _mamba_params(d)
    x = _normal((B_, T_, d), 5, 0.5)
    jy, jst = jax.jit(functools.partial(jssm.mamba_apply, chunk=chunk, return_state=True))(
        jp, jnp.asarray(x))
    y, st = tssm.mamba_apply(p, torch.tensor(x), chunk=chunk, return_state=True)
    close(jy, y)
    assert sorted(st) == sorted(jst) == ["conv", "ssm"]
    for name in st:
        assert tuple(st[name].shape) == jst[name].shape
        close(jst[name], st[name])
    torch.testing.assert_close(y, tssm.mamba_reference(p, torch.tensor(x)), atol=CHUNK_TOL,
                               rtol=CHUNK_TOL)


@pytest.mark.parametrize("T_", [2, 12], ids=["T-under-conv", "T12"])
def test_mamba_decode_matches_jax(T_):
    """tests/test_recurrent.py's prefill -> decode handoff: the state after
    T tokens (T = 2 < d_conv - 1 keeps a zero row in the conv state), then
    3 decode steps, each output and state within 1e-5 of JAX's; within the
    port the steps give the oracle's outputs at the reference's 3e-4."""
    d = 16
    jp, p = _mamba_params(d)
    x = _normal((1, T_ + 3, d), 6, 0.5)
    _, jst = jax.jit(functools.partial(jssm.mamba_apply, return_state=True))(
        jp, jnp.asarray(x[:, :T_]))
    _, st = tssm.mamba_apply(p, torch.tensor(x[:, :T_]), return_state=True)
    if T_ == 2:
        assert float(st["conv"][:, 0].abs().max()) == 0.0
    full = tssm.mamba_reference(p, torch.tensor(x))
    step = jax.jit(jssm.mamba_decode_apply)
    for t in range(T_, T_ + 3):
        jy, jst = step(jp, jnp.asarray(x[:, t:t + 1]), jst)
        y, st = tssm.mamba_decode_apply(p, torch.tensor(x[:, t:t + 1]), st)
        close(jy, y)
        for name in st:
            close(jst[name], st[name])
        torch.testing.assert_close(y, full[:, t:t + 1], atol=DECODE_TOL, rtol=DECODE_TOL)


@pytest.mark.parametrize("B_,T_,d,chunk", [(2, 200, 32, 128), (1, 5, 16, 128)],
                         ids=["card-T", "short"])
def test_port_mamba_chunked_matches_its_reference(B_, T_, d, chunk):
    """Within the port: the chunked scan over 128-token chunks at T = 200
    (phase 19a's sequence, off the chunk, on a narrow block) and at T = 5
    (one short chunk) gives ``mamba_reference``'s output at 2e-4, and its
    state the oracle's state."""
    _, p = _mamba_params(d, seed=4)
    x = torch.tensor(_normal((B_, T_, d), 7, 0.5))
    y, st = tssm.mamba_apply(p, x, chunk=chunk, return_state=True)
    torch.testing.assert_close(y, tssm.mamba_reference(p, x), atol=CHUNK_TOL, rtol=CHUNK_TOL)
    state = tssm.mamba_decode_init_state(B_, 2 * d, 16, 4)
    for t in range(T_):
        _, state = tssm.mamba_decode_apply(p, x[:, t:t + 1], state)
    for name in state:
        torch.testing.assert_close(st[name], state[name], atol=CHUNK_TOL, rtol=CHUNK_TOL)


def test_mamba_init_draws_and_dtypes():
    """``mamba_init``: S4D-real A_log = log(1 .. d_state) on every channel,
    dt_bias the inverse softplus of a step in [0.001, 0.1], D ones, all
    float32 in a bf16 block; conv_w (d_inner, 1, d_conv) he-normal over
    d_conv, conv_b zeros, the projections in the block's dtype."""
    d, ds = 64, 16
    p = tssm.mamba_init(torch.Generator().manual_seed(0), d, d_state=ds,
                        dtype=torch.bfloat16)
    di = 2 * d
    assert torch.equal(p["A_log"], torch.log(torch.arange(1, ds + 1).float()).expand(di, ds))
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert float(dt.min()) >= 0.001 - 1e-6 and float(dt.max()) <= 0.1 + 1e-6
    assert torch.equal(p["D"], torch.ones(di))
    assert all(p[k].dtype == torch.float32 for k in ("A_log", "dt_bias", "D"))
    assert tuple(p["conv_w"].shape) == (di, 1, 4) and p["conv_w"].dtype == torch.bfloat16
    assert float(p["conv_w"].float().abs().max()) <= 2 * (2.0 / 4) ** 0.5
    assert torch.equal(p["conv_b"], torch.zeros(di, dtype=torch.bfloat16))
    assert tuple(p["x_proj"]["w"].shape) == (di, d // 16 + 2 * ds)
    assert tuple(p["dt_proj"]["w"].shape) == (d // 16, di)
    assert all(p[k]["w"].dtype == torch.bfloat16 for k in ("in_proj", "out_proj"))


# ----------------------------------------------------------------- model ---
@pytest.fixture(scope="module")
def model():
    """Reduced jamba from the port's seed-0 init, in JAX's layout and
    bridged back into the port; JAX's train step with forward_loss's
    metrics (jitted once) from zero momentum (its momentum out: the
    gradient) at the weights and one ulp away, and from momentum 0.1; its
    engine's greedy tokens of an equal-length queue and the engine's
    jitted prefill."""
    jcfg = jax_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    tree = backbone_params_to_numpy(tbb.init_params(cfg, seed=0, device="cpu"), cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    rng = np.random.RandomState(6)
    batch = {k: rng.randint(0, cfg.vocab, (B, T)).astype(np.int32)
             for k in ("tokens", "labels")}
    train_step = jsteps.make_train_step(jcfg, JaxShape("t", T, B, "train"), **STEP_KW)
    # the train step and forward_loss's metrics in one program: one trace
    # and one compile where two would cost about 3 s more
    jstep = jax.jit(lambda p, o, b: (train_step(p, o, b), jbb.forward_loss(jcfg, p, b)[1]))
    zero = jax.tree_util.tree_map(jnp.zeros_like, jp)
    (_, jgrad_opt, jm), jmetrics = jstep(jp, {"momentum": zero}, batch)
    (_, jgrad_ulp, _), _ = jstep(_ulp(jp), {"momentum": zero}, batch)
    some = jax.tree_util.tree_map(lambda p: 0.1 * jnp.ones_like(p), jp)
    (jp2, jopt2, jm2), _ = jstep(jp, {"momentum": some}, batch)
    prompts = np.random.RandomState(7).randint(0, cfg.vocab, (B, PROMPT)).astype(np.int32)
    jeng = JaxServeEngine(jcfg, jp, max_len=MAX_LEN)
    jtokens = [c.tokens.tolist() for c in jeng.generate(
        [JaxRequest(tokens=p, max_new_tokens=NEW) for p in prompts])]
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, batch=batch, jgrad=jgrad_opt["momentum"],
                grad_bars=spread_bars(jgrad_opt["momentum"], jgrad_ulp["momentum"]),
                jm={**jmetrics, **jm}, jp2=jp2, jopt2=jopt2, jloss2=jm2["loss"], prompts=prompts,
                jtokens=jtokens, jprefill=jeng._prefill, tree=tree,
                params=backbone_params_from_numpy(tree, cfg, device="cpu"))


def test_jamba_config_and_assigned_archs():
    """The full config is JAX's field for field (the port's dtype torch's
    bfloat16); ``reduced()`` keeps one superblock of 8 layers with 4
    experts; ``ASSIGNED_ARCHS`` is the JAX package's list, every name
    registered in the port."""
    from repro.configs import ASSIGNED_ARCHS as JAX_ASSIGNED

    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    for f in dataclasses.fields(jcfg):
        a, b = getattr(jcfg, f.name), getattr(cfg, f.name)
        assert (dataclasses.asdict(a) == dataclasses.asdict(b)
                if dataclasses.is_dataclass(a) else a == b), f.name
    assert cfg.dtype == torch.bfloat16 and cfg.n_superblocks == 9
    red = cfg.reduced()
    assert (red.n_layers, red.d_model, red.moe.n_experts, red.moe.top_k) == (8, 256, 4, 2)
    assert ASSIGNED_ARCHS == JAX_ASSIGNED and set(ASSIGNED_ARCHS) <= set(list_configs())


def test_jamba_layers_and_params(model):
    """The reduced config's superblock: attention at 0 and Mamba at 1-7,
    MoE FFNs at the odd layers and dense ones at the even; the port's init
    in JAX's layout is the tree of JAX's own init (every key path, shape
    and dtype), and the bridge maps it into the port and back bitwise."""
    cfg, params = model["cfg"], model["params"]
    specs = tbb.sublayer_specs(cfg)
    assert [s["kind"] for s in specs] == ["attn"] + ["mamba"] * 7
    assert [s["ffn"] for s in specs] == ["dense", "moe"] * 4
    assert specs == jbb.sublayer_specs(model["jcfg"])
    assert tuple(params["blocks"][1]["mamba"]["conv_w"].shape) == (512, 1, 4)
    shapes = jax.eval_shape(lambda: jbb.init_params(model["jcfg"], jax.random.PRNGKey(0)))
    want = [(jax.tree_util.keystr(k), v.shape, v.dtype)
            for k, v in jax.tree_util.tree_leaves_with_path(shapes)]
    got = [(jax.tree_util.keystr(k), v.shape, v.dtype)
           for k, v in jax.tree_util.tree_leaves_with_path(model["tree"])]
    assert got == want
    back = jax.tree_util.tree_leaves(backbone_params_to_numpy(params, cfg))
    assert all(np.array_equal(a, b)
               for a, b in zip(jax.tree_util.tree_leaves(model["tree"]), back))


def test_jamba_loss_and_every_grad_leaf_match_jax(model):
    """forward_loss and its metrics (ce, the MoE load-balance loss and
    dropped fraction, averaged over the 4 MoE layers) within 1e-5 of
    JAX's, and every gradient leaf within its layer's bar
    (``spread_bars``), finite in every layer."""
    cfg = model["cfg"]
    (loss, m), grads = value_and_grad(
        lambda p: tbb.forward_loss(cfg, p, model["batch"]), model["params"])
    np.testing.assert_allclose(float(loss), float(model["jm"]["loss"]), atol=TOL, rtol=TOL)
    assert sorted(m) == ["ce", "dropped_fraction", "load_balance_loss"]
    for k in m:
        np.testing.assert_allclose(float(m[k].detach()), float(model["jm"][k]), atol=TOL,
                                   rtol=TOL)
    spread_close(model["jgrad"], backbone_params_to_numpy(grads, cfg), model["grad_bars"])
    for blk in grads["blocks"]:
        assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(blk))
    assert float(grads["blocks"][1]["mamba"]["A_log"].abs().max()) > 0


def test_jamba_remat_on_and_off_bitwise(model):
    """Each layer's checkpointed recompute runs the same arithmetic (the
    scan's loop and the MoE routing of the first pass): the loss and every
    gradient bitwise equal with remat on and off."""
    cfg = model["cfg"]
    runs = [value_and_grad(lambda p: tbb.forward_loss(cfg, p, model["batch"], remat=r),
                           model["params"]) for r in (True, False)]
    (l_on, _), g_on = runs[0]
    (l_off, _), g_off = runs[1]
    assert torch.equal(l_on, l_off)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g_on), tree_leaves(g_off)))


def test_jamba_train_step_matches_jax(model):
    """One SGD-momentum step (one microbatch, momentum 0.1 in): the loss
    within 1e-5, the new momentum at the gradients' bars, new params within
    1e-5 of their layer's scale plus lr x the momentum's bar."""
    cfg = model["cfg"]
    step = tsteps.make_train_step(cfg, InputShape("t", T, B, "train"), **STEP_KW)
    opt = {"momentum": tree_map(lambda p: 0.1 * torch.ones_like(p), model["params"])}
    p, opt, m = step(model["params"], opt, model["batch"])
    np.testing.assert_allclose(float(m["loss"]), float(model["jloss2"]), atol=TOL, rtol=TOL)
    bars = model["grad_bars"]
    spread_close(model["jopt2"]["momentum"], backbone_params_to_numpy(opt["momentum"], cfg),
                 bars)
    spread_close(model["jp2"], backbone_params_to_numpy(p, cfg),
                 spread_bars(model["jp2"], model["jp2"]),
                 extra={g: STEP_KW["lr"] * b for g, b in bars.items()})


def _jax_cache(c: dict, like: dict) -> dict:
    """JAX's cache with its K/V (n_sb, 1, B, S, H, D) in the port's (L, B,
    S, H, D) shape."""
    return {k: np.asarray(v).reshape(tuple(like[k].shape)) for k, v in c.items()}


def test_jamba_prefill_and_decode_match_jax(model):
    """Prefill of B x 12 tokens, then 4 decode steps teacher-forced on
    JAX's greedy tokens: the logits, the K/V and every Mamba state of the
    cache within ``spread_bars`` of JAX's after each (JAX run again one ulp
    away, on the same tokens); the cache's keys, dtypes and shapes are
    JAX's (K/V as (L, B, S, H, D)), updated in place."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    toks = model["prompts"]
    jprefill = model["jprefill"]   # the JAX engine's jitted prefill, compiled already
    jstep = jax.jit(functools.partial(jbb.decode_step, jcfg))
    runs = [jprefill(p, {"tokens": jnp.asarray(toks)}, max_len=MAX_LEN)[:2]
            for p in (model["jp"], _ulp(model["jp"]))]
    tl, tc, tT = tbb.prefill(cfg, model["params"], {"tokens": torch.as_tensor(toks)},
                             max_len=MAX_LEN)
    assert tT == PROMPT
    assert sorted(tc) == sorted(runs[0][1]) == ["k", "mamba_conv", "mamba_ssm", "v"]
    for k, v in runs[0][1].items():
        assert str(tc[k].dtype)[6:] == str(v.dtype)
        assert tc[k].numel() == v.size and (k in "kv" or tuple(tc[k].shape) == v.shape)
    assert tuple(tc["k"].shape) == (1, B, MAX_LEN, cfg.n_kv_heads, cfg.resolved_head_dim)
    ptr = tc["mamba_ssm"].data_ptr()
    for i in range(DECODE + 1):
        (jl, jc), (ul, uc) = runs
        ref = {"logits": jl, **_jax_cache(jc, tc)}
        got = {"logits": tl.numpy(), **{k: v.clone().numpy() for k, v in tc.items()}}
        spread_close(ref, got, spread_bars(ref, {"logits": ul, **_jax_cache(uc, tc)}))
        if i == DECODE:
            break
        tok = jnp.argmax(jl, -1)[:, None]
        runs = [jstep(p, tok, c, PROMPT + i) for p, (_, c) in
                zip((model["jp"], _ulp(model["jp"])), runs)]
        tl, tc = tbb.decode_step(cfg, model["params"], torch.as_tensor(np.array(tok)), tc,
                                 PROMPT + i)
    assert tc["mamba_ssm"].data_ptr() == ptr


def test_jamba_generate_matches_jax(model):
    """Greedy ``ServeEngine.generate`` on equal-length prompts: the tokens
    equal JAX's; the continuous scheduler keeps a hybrid off its mixed
    path (a deadline raises ValueError, as in JAX)."""
    cfg = model["cfg"]
    assert not supports_continuous_batching(cfg)
    eng = ServeEngine(cfg, model["params"], max_len=MAX_LEN, device="cpu")
    out = eng.generate([Request(tokens=p, max_new_tokens=NEW) for p in model["prompts"]])
    assert [c.tokens.tolist() for c in out] == model["jtokens"]
    assert all(len(c.tokens) == NEW for c in out)
    with pytest.raises(ValueError, match="deadlines"):
        eng.generate([Request(tokens=model["prompts"][0], max_new_tokens=2,
                              deadline_s=1.0)])


def test_jamba_init_cache_matches_jax(model):
    """``init_cache``: JAX's keys and dtypes, the Mamba states at JAX's
    shapes (n_sb, 7, B, ...) and the K/V as (L, B, S, H, D), all zeros,
    whatever long_context (a hybrid keeps its whole context)."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    for lc in (False, True):
        jc = jbb.init_cache(jcfg, 3, 20, long_context=lc)
        tc = tbb.init_cache(cfg, 3, 20, long_context=lc, device="cpu")
        assert sorted(tc) == sorted(jc) == ["k", "mamba_conv", "mamba_ssm", "v"]
        for k in jc:
            assert str(tc[k].dtype)[6:] == str(jc[k].dtype)
            np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]).reshape(tc[k].shape))
        assert tuple(tc["mamba_conv"].shape) == jc["mamba_conv"].shape == (1, 7, 3, 3, 512)
        assert tuple(tc["mamba_ssm"].shape) == jc["mamba_ssm"].shape == (1, 7, 3, 512, 16)
        assert tuple(tc["k"].shape) == (1, 3, 20, cfg.n_kv_heads, cfg.resolved_head_dim)


def test_jamba_cache_window_and_chunked_prefill_refuse(model):
    """``cache_window(long_context=True)`` leaves a hybrid's context whole,
    as JAX's does; ``prefill_chunk`` and a bucketed ``prefill`` refuse it
    with ValueError (JAX asserts)."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    long = cfg.long_context_window + 100
    for lc in (False, True):
        assert tbb.cache_window(cfg, long, long_context=lc) == long
        assert jbb.cache_window(jcfg, long, long_context=lc) == long
    toks = torch.zeros((1, 4), dtype=torch.long)
    cache = tbb.init_cache(cfg, 1, 16, device="cpu")
    with pytest.raises(ValueError, match="Mamba blocks"):
        tbb.prefill_chunk(cfg, model["params"], toks, cache, 0, attend_width=4)
    with pytest.raises(AssertionError):
        jbb.prefill_chunk(jcfg, model["jp"], jnp.zeros((1, 4), jnp.int32), {}, 0,
                          attend_width=4)
    with pytest.raises(ValueError, match="attention-only"):
        tbb.prefill(cfg, model["params"], {"tokens": toks}, lengths=torch.tensor([4]))
    with pytest.raises(AssertionError):
        jbb.prefill(jcfg, model["jp"], {"tokens": jnp.zeros((1, 4), jnp.int32)},
                    lengths=jnp.asarray([4]))
