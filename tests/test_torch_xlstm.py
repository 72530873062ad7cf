"""The port's xLSTM on the CPU against the JAX package: the mLSTM's chunked
and sequential forms, the mLSTM and sLSTM cells and their one-token
decode steps (``nn/xlstm.py``), then reduced xlstm-350m (one superblock
of 7 mLSTM + 1 sLSTM layers, d 256, 4 heads, float32) on bridged weights:
``forward_loss`` and every gradient leaf, one ``make_train_step``,
``prefill`` / ``decode_step`` and the greedy tokens of
``ServeEngine.generate`` (equal lengths, and a mixed-length queue, which
groups by length as in JAX); within the port, remat on and off bitwise and
the chunked mLSTM against its sequential oracle.  The repairs that xLSTM
configs need: ``cache_window(long_context=True)`` skips them, as JAX's
does, and ``prefill_chunk`` and a bucketed ``prefill`` refuse them.

The model's weights are the port's seeded init, moved to JAX in its
layout by ``bridge.backbone_params_to_numpy`` (the tree of JAX's own
init, leaf for leaf) and back into the port by
``backbone_params_from_numpy``: JAX's init costs seconds of compiling
that the comparison does not need.  JAX's gradient is read off one
jitted ``make_train_step`` (its ``jax.value_and_grad``): with zero
momentum in and no weight decay, the momentum out is the gradient itself.
That one compile serves the gradient and the train-step cases, on
seeded numpy inputs.

Tolerances, each with its reason:
- module outputs and states, the loss at 1e-5: float32 sums in another
  order;
- the model's gradients, caches and logits: within 1e-5 of scale, or
  within ULP_SPREAD times JAX's own spread one ulp away, whichever is
  wider (``spread_close``).  The spread is how far JAX's float32 result
  moves when every weight is nudged one ulp, tensor by tensor (a
  gradient by its layer: the largest |value| of the layer's leaves is the
  scale, the embedding, the final norm and the readout each their own).
  Rounding is magnified through the cells: at this batch JAX's own
  float32 gradient is 9.8e-4 of its layer's scale from a float64 run of
  the port (3.5e-5 at T = 20, 4.7e-5 at T = 12, 6.4e-5 at T = 40), far
  past 1e-5, and its one-ulp spread is 6.8e-4.  The port's float32
  gradient is 1.4-2.8x as far from float64 as JAX's, because torch's CPU
  float32 GEMM rounds wider than XLA's (6.3e-7 against 3.7e-7 of scale
  on a (40, 256) x (256, 256) product; with its products rounded exactly
  the port's hidden states are nearer float64 than JAX's), and one ulp's
  spread understates JAX's own error by up to 1.45x: so the two can part
  by about (1 + 2.8) x 1.45 = 5.5 spreads.  Measured port-to-JAX over T
  in {12, 20, 24, 40}: 1.5-5.7 spreads, layer by layer.
  The input gate's bias gets almost no gradient (a
  shift of every log input gate cancels between the mLSTM's numerator and
  normaliser), so its own scale is rounding noise in both packages, and
  the layer's scale is used;
- a train step's new params at 1e-5 of their layer's scale plus lr times
  the momentum's bar;
- the chunked mLSTM against the sequential one at 2e-4, the reference's
  own bar (``tests/test_recurrent.py``); full sequence against one token
  at a time at 5e-4 (mLSTM) and 5e-5 (sLSTM), the same file's;
- greedy tokens exactly.
"""
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
from repro.nn import xlstm as jx  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch import tree_leaves, tree_map, value_and_grad  # noqa: E402
from repro_torch.bridge import backbone_params_from_numpy, backbone_params_to_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import backbone as tbb  # noqa: E402
from repro_torch.nn import xlstm as tx  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

TOL, CHUNK_TOL, ULP_SPREAD = 1e-5, 2e-4, 8
MLSTM_DECODE_TOL, SLSTM_DECODE_TOL = 5e-4, 5e-5
ARCH = "xlstm-350m"
B, T, PROMPT, NEW, DECODE, MAX_LEN = 2, 24, 12, 6, 8, 40
STEP_KW = dict(lr=0.05, momentum=0.9, weight_decay=0.0, n_micro_override=1)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: these small shapes gain nothing from the pool,
    and under several test workers each pool oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _t(tree):
    return jax.tree_util.tree_map(torch.tensor, _np(tree))


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.RandomState(seed).standard_normal(shape)).astype(np.float32)


def close(ref, got, tol=TOL):
    """got (a tensor) within tol abs + rel of ref (a JAX or numpy array)."""
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


def _ulp(tree):
    """The JAX tree with every float leaf nudged one ulp toward +inf."""
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.nextafter(np.asarray(a), np.float32(np.inf))), tree)


def _layers(tree) -> dict:
    """{group: [(key, leaf)]} of a tree in JAX's layout: the leaves of
    blocks[j] (stacked over superblocks, so a layer) together, every other
    leaf alone."""
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


def _gates(B_, T_, H, D, seed):
    """q, k, v (B, T, H, D) and the log gates (B, T, H), the forget gate
    near remembering, as tests/test_recurrent.py draws them."""
    q, k, v = (_normal((B_, T_, H, D), seed + i) for i in range(3))
    li = _normal((B_, T_, H), seed + 3)
    lf = np.asarray(jax.nn.log_sigmoid(3.0 + jnp.asarray(_normal((B_, T_, H), seed + 4))))
    return q, k, v, li, lf


# --------------------------------------------------------------- modules ---
@pytest.mark.parametrize("B_,T_,H,D,chunk", [(2, 17, 2, 8, 8), (1, 32, 4, 16, 16)],
                         ids=["padded", "unpadded"])
def test_mlstm_chunked_and_sequential_match_jax(B_, T_, H, D, chunk):
    """The chunked mLSTM's output and final state (C, n, m) and the
    sequential oracle's output within 1e-5 of JAX's, T off the chunk (a
    padded tail) and on it."""
    args = _gates(B_, T_, H, D, 10)
    jy, jst = jx.mlstm_chunked(*map(jnp.asarray, args), chunk=chunk)
    y, st = tx.mlstm_chunked(*map(torch.tensor, args), chunk=chunk)
    close(jy, y)
    for name in "Cnm":
        close(jst[name], st[name])
    close(jx.mlstm_sequential(*map(jnp.asarray, args)),
          tx.mlstm_sequential(*map(torch.tensor, args)))


@pytest.mark.parametrize("B_,T_,H,D,chunk", [(2, 17, 2, 8, 8), (2, 200, 4, 16, 64)],
                         ids=["reference-shape", "card-T"])
def test_port_mlstm_chunked_matches_its_sequential(B_, T_, H, D, chunk):
    """Within the port, at the reference's bar: the chunked mLSTM gives the
    sequential oracle's output; also at T = 200 over 64-token chunks, phase
    18a's sequence on narrow heads."""
    args = [torch.tensor(a) for a in _gates(B_, T_, H, D, 20)]
    y, _ = tx.mlstm_chunked(*args, chunk=chunk)
    torch.testing.assert_close(y, tx.mlstm_sequential(*args), atol=CHUNK_TOL,
                               rtol=CHUNK_TOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_cell_apply_and_decode_match_jax(kind):
    """A cell over a sequence (its output and final state), then token by
    token from the empty state through its decode step: every output and
    state within 1e-5 of JAX's; within the port the steps give the full
    sequence's output at the reference's bars."""
    Bc, Tc, d, H = 2, 11, 32, 4
    init, apply, step = ((jx.mlstm_init, jx.mlstm_apply, jx.mlstm_decode_apply)
                         if kind == "mlstm" else
                         (jx.slstm_init, jx.slstm_apply, jx.slstm_decode_apply))
    jp = init(jax.random.PRNGKey(2), d, H)
    p = _t(jp)
    x = _normal((Bc, Tc, d), 30, 0.5)
    kw = dict(chunk=4) if kind == "mlstm" else {}
    jy, jst = apply(jp, jnp.asarray(x), n_heads=H, return_state=True, **kw)
    t_apply = tx.mlstm_apply if kind == "mlstm" else tx.slstm_apply
    y, st = t_apply(p, torch.tensor(x), n_heads=H, return_state=True, **kw)
    close(jy, y)
    assert sorted(st) == sorted(jst)
    for name in st:
        close(jst[name], st[name])
    if kind == "mlstm":
        jstate = jx.mlstm_decode_init_state(Bc, H, d // H)
        state = tx.mlstm_decode_init_state(Bc, H, d // H)
        t_step = tx.mlstm_decode_apply
    else:
        jstate = jx.slstm_decode_init_state(Bc, d)
        state = tx.slstm_decode_init_state(Bc, d)
        t_step = tx.slstm_decode_apply
    for name in state:
        close(jstate[name], state[name])
    step = jax.jit(functools.partial(step, n_heads=H))
    steps = []
    for t in range(Tc):
        jyt, jstate = step(jp, jnp.asarray(x[:, t:t + 1]), jstate)
        yt, state = t_step(p, torch.tensor(x[:, t:t + 1]), state, n_heads=H)
        close(jyt, yt)
        steps.append(yt)
    for name in state:
        close(jstate[name], state[name])
    bar = MLSTM_DECODE_TOL if kind == "mlstm" else SLSTM_DECODE_TOL
    torch.testing.assert_close(torch.cat(steps, 1), y, atol=bar, rtol=bar)


def test_slstm_recurrent_weight_init():
    """The sLSTM's recurrent weight is drawn normal with std 1 / sqrt(d)
    (``dense_init(std=)``, JAX's normal branch), its input projection
    lecun-normal with a zero bias; the mLSTM's forget-gate bias starts at
    3.0."""
    d = 512
    gen = torch.Generator().manual_seed(0)
    p = tx.slstm_init(gen, d, 4)
    assert p["wr"]["w"].shape == (d, 4 * d) and "b" not in p["wr"]
    assert abs(float(p["wr"]["w"].std()) * d ** 0.5 - 1.0) < 0.01
    assert float(p["wx"]["w"].abs().max()) <= 2.0 / d ** 0.5     # truncated at 2 std
    assert torch.equal(p["wx"]["b"], torch.zeros(4 * d))
    m = tx.mlstm_init(gen, 64, 4)
    assert torch.equal(m["wf"]["b"], torch.full((4,), 3.0))
    assert torch.equal(m["wi"]["b"], torch.zeros(4))


# ----------------------------------------------------------------- model ---
@pytest.fixture(scope="module")
def model():
    """Reduced xlstm-350m from the port's seed-0 init, in JAX's layout and
    bridged back into the port; JAX's train
    step (jitted once) from zero momentum (its momentum out: the gradient)
    at the weights and one ulp away, and from momentum 0.1, and its greedy
    tokens of an equal-length and a mixed-length queue through one
    engine."""
    jcfg = jax_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    tree = backbone_params_to_numpy(tbb.init_params(cfg, seed=0, device="cpu"), cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    rng = np.random.RandomState(6)
    batch = {k: rng.randint(0, cfg.vocab, (B, T)).astype(np.int32)
             for k in ("tokens", "labels")}
    jstep = jax.jit(jsteps.make_train_step(jcfg, JaxShape("t", T, B, "train"), **STEP_KW))
    zero = jax.tree_util.tree_map(jnp.zeros_like, jp)
    _, jgrad_opt, jm = jstep(jp, {"momentum": zero}, batch)
    _, jgrad_ulp, _ = jstep(_ulp(jp), {"momentum": zero}, batch)
    some = jax.tree_util.tree_map(lambda p: 0.1 * jnp.ones_like(p), jp)
    jp2, jopt2, jm2 = jstep(jp, {"momentum": some}, batch)
    prompts = np.random.RandomState(7).randint(0, cfg.vocab, (4, PROMPT)).astype(np.int32)
    equal = [(p, NEW) for p in prompts[:B]]
    mixed = [(prompts[0], NEW), (prompts[1][:7], 4), (prompts[2], 3), (prompts[3][:7], NEW)]
    jeng = JaxServeEngine(jcfg, jp, max_len=MAX_LEN)
    jtokens = {name: [c.tokens.tolist() for c in jeng.generate(
        [JaxRequest(tokens=p, max_new_tokens=n) for p, n in reqs])]
        for name, reqs in (("equal", equal), ("mixed", mixed))}
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, batch=batch, jgrad=jgrad_opt["momentum"],
                grad_bars=spread_bars(jgrad_opt["momentum"], jgrad_ulp["momentum"]),
                jloss=jm["loss"], jp2=jp2, jopt2=jopt2, jloss2=jm2["loss"],
                prompts=prompts, queues={"equal": equal, "mixed": mixed},
                jtokens=jtokens, tree=tree,
                params=backbone_params_from_numpy(tree, cfg, device="cpu"))


def test_xlstm_layers_and_params(model):
    """The reduced config's one superblock: 7 mLSTM cells and the sLSTM at
    index 7, no FFN (no ffn_norm), an untied readout; the port's init in
    JAX's layout is the tree of JAX's own init (every key path, shape and
    dtype), and the bridge maps it into the port and back bitwise."""
    cfg, params = model["cfg"], model["params"]
    specs = tbb.sublayer_specs(cfg)
    assert [s["kind"] for s in specs] == ["mlstm"] * 7 + ["slstm"]
    assert specs == jbb.sublayer_specs(model["jcfg"])
    assert all(sorted(b) == ["cell", "norm"] for b in params["blocks"])
    assert "lm_head" in params and cfg.n_layers == 8
    shapes = jax.eval_shape(lambda: jbb.init_params(model["jcfg"], jax.random.PRNGKey(0)))
    want = [(jax.tree_util.keystr(k), v.shape, v.dtype)
            for k, v in jax.tree_util.tree_leaves_with_path(shapes)]
    got = [(jax.tree_util.keystr(k), v.shape, v.dtype)
           for k, v in jax.tree_util.tree_leaves_with_path(model["tree"])]
    assert got == want
    back = jax.tree_util.tree_leaves(backbone_params_to_numpy(params, cfg))
    assert all(np.array_equal(a, b)
               for a, b in zip(jax.tree_util.tree_leaves(model["tree"]), back))


def test_xlstm_loss_and_every_grad_leaf_match_jax(model):
    """forward_loss within 1e-5 of JAX's, its metrics JAX's keys (ce = the
    loss, no MoE), and every gradient leaf within its layer's bar
    (``spread_bars``), finite and nonzero in every layer."""
    cfg = model["cfg"]
    (loss, m), grads = value_and_grad(
        lambda p: tbb.forward_loss(cfg, p, model["batch"]), model["params"])
    np.testing.assert_allclose(float(loss), float(model["jloss"]), atol=TOL, rtol=TOL)
    assert sorted(m) == ["ce", "dropped_fraction", "load_balance_loss"]
    assert float(m["ce"].detach()) == float(loss) and float(m["load_balance_loss"]) == 0.0
    spread_close(model["jgrad"], backbone_params_to_numpy(grads, cfg), model["grad_bars"])
    for blk in grads["blocks"]:
        assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(blk))
        assert float(blk["cell"]["norm"]["scale"].abs().max()) > 0


def test_xlstm_remat_on_and_off_bitwise(model):
    """Each layer's checkpointed recompute runs the same arithmetic: the
    loss and every gradient bitwise equal with remat on and off."""
    cfg = model["cfg"]
    runs = [value_and_grad(lambda p: tbb.forward_loss(cfg, p, model["batch"], remat=r),
                           model["params"]) for r in (True, False)]
    (l_on, _), g_on = runs[0]
    (l_off, _), g_off = runs[1]
    assert torch.equal(l_on, l_off)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g_on), tree_leaves(g_off)))


def test_xlstm_train_step_matches_jax(model):
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
    p_bars = spread_bars(model["jp2"], model["jp2"])
    spread_close(model["jp2"], backbone_params_to_numpy(p, cfg), p_bars,
                 extra={g: STEP_KW["lr"] * b for g, b in bars.items()})


def test_xlstm_prefill_and_decode_match_jax(model):
    """Prefill of B x 12 tokens, then 8 decode steps teacher-forced on
    JAX's greedy tokens: the logits and every cell state of the cache (in
    JAX's shapes and dtypes) within ``spread_bars`` of JAX's after each
    (JAX run again one ulp away, on the same tokens); the cache is
    updated in place."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    toks = model["prompts"][:B]
    jprefill = jax.jit(functools.partial(jbb.prefill, jcfg), static_argnames=("max_len",))
    jstep = jax.jit(functools.partial(jbb.decode_step, jcfg))
    runs = [jprefill(p, {"tokens": jnp.asarray(toks)}, max_len=MAX_LEN)[:2]
            for p in (model["jp"], _ulp(model["jp"]))]
    tl, tc, tT = tbb.prefill(cfg, model["params"], {"tokens": torch.as_tensor(toks)},
                             max_len=MAX_LEN)
    assert tT == PROMPT
    assert sorted(tc) == sorted(runs[0][1])
    for k, v in runs[0][1].items():
        assert tuple(tc[k].shape) == v.shape and str(tc[k].dtype)[6:] == str(v.dtype)
    ptr = tc["mlstm_C"].data_ptr()
    for i in range(DECODE + 1):
        (jl, jc), (ul, uc) = runs
        ref = {"logits": jl, **jc}
        got = {"logits": tl, **{k: v.clone() for k, v in tc.items()}}
        spread_close(ref, {k: v.numpy() for k, v in got.items()},
                     spread_bars(ref, {"logits": ul, **uc}))
        if i == DECODE:
            break
        tok = jnp.argmax(jl, -1)[:, None]
        runs = [jstep(p, tok, c, PROMPT + i) for p, (_, c) in
                zip((model["jp"], _ulp(model["jp"])), runs)]
        tl, tc = tbb.decode_step(cfg, model["params"], torch.as_tensor(np.array(tok)), tc,
                                 PROMPT + i)
    assert tc["mlstm_C"].data_ptr() == ptr


@pytest.mark.parametrize("queue", ["equal", "mixed"])
def test_xlstm_generate_matches_jax(model, queue):
    """Greedy ``ServeEngine.generate``: the tokens equal JAX's on
    equal-length prompts and on a mixed-length queue with per-request
    budgets (no continuous scheduler for a recurrent arch: one
    equal-length call per prompt length, as in JAX); a deadline raises
    ValueError, as in JAX."""
    eng = ServeEngine(model["cfg"], model["params"], max_len=MAX_LEN, device="cpu")
    reqs = [Request(tokens=p, max_new_tokens=n) for p, n in model["queues"][queue]]
    out = eng.generate(reqs)
    assert [c.tokens.tolist() for c in out] == model["jtokens"][queue]
    assert [len(c.tokens) for c in out] == [n for _, n in model["queues"][queue]]
    with pytest.raises(ValueError, match="deadlines"):
        eng.generate([Request(tokens=reqs[0].tokens, max_new_tokens=2, deadline_s=1.0)])


def test_xlstm_init_cache_matches_jax(model):
    """``init_cache`` holds JAX's per-kind state tensors, at its shapes and
    dtypes, zeros with the m's at -1e30, whatever the context and
    long_context."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    jc = jbb.init_cache(jcfg, 3, 20, long_context=True)
    tc = tbb.init_cache(cfg, 3, 20, long_context=True, device="cpu")
    assert sorted(tc) == sorted(jc) == sorted(
        [f"mlstm_{n}" for n in "Cnm"] + [f"slstm_{n}" for n in "hcnm"])
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape and tc[k].dtype == torch.float32
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))


def test_xlstm_cache_window_and_chunked_prefill_refuse(model):
    """``cache_window(long_context=True)`` leaves an xLSTM's (and a
    hybrid's) context whole, as JAX's does, and still windows a dense arch;
    ``prefill_chunk`` and a bucketed ``prefill`` refuse an xLSTM with
    ValueError (JAX asserts)."""
    import dataclasses

    from repro.configs.base import HybridSpec as JaxHybridSpec
    from repro_torch.configs.base import HybridSpec

    jcfg, cfg = model["jcfg"], model["cfg"]
    long = cfg.long_context_window + 100
    for j, t in ((jcfg, cfg),
                 (dataclasses.replace(jax_get_config("qwen2-0.5b"), hybrid=JaxHybridSpec()),
                  dataclasses.replace(get_config("qwen2-0.5b"), hybrid=HybridSpec())),
                 (jax_get_config("qwen2-0.5b"), get_config("qwen2-0.5b"))):
        for lc in (False, True):
            assert (tbb.cache_window(t, long, long_context=lc)
                    == jbb.cache_window(j, long, long_context=lc))
    assert tbb.cache_window(cfg, long, long_context=True) == long
    assert tbb.cache_window(get_config("qwen2-0.5b"), long, long_context=True) < long
    toks = torch.zeros((1, 4), dtype=torch.long)
    cache = tbb.init_cache(cfg, 1, 16, device="cpu")
    with pytest.raises(ValueError, match="recurrent cells"):
        tbb.prefill_chunk(cfg, model["params"], toks, cache, 0, attend_width=4)
    with pytest.raises(AssertionError):
        jbb.prefill_chunk(jcfg, model["jp"], jnp.zeros((1, 4), jnp.int32), {}, 0,
                          attend_width=4)
    with pytest.raises(ValueError, match="attention-only"):
        tbb.prefill(cfg, model["params"], {"tokens": toks}, lengths=torch.tensor([4]))
