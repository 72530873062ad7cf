"""The port's MoE layer on the CPU against the JAX package, on bridged
weights and the same seeded inputs: ``moe_apply`` at a capacity that
drops slots and at the inference (dropless) capacities, with JAX's
``keep`` mask and dropped fraction exactly; both against
``moe_reference``; top-k ties in ``jax.lax.top_k``'s order; and how the
port serves an MoE arch (equal-length calls, refusals).  The MoE archs
themselves: ``test_torch_moe_archs.py``.

Tolerances, each with its reason:
- MoE outputs and the load-balance loss at 1e-5: float32 sums run in
  another order (XLA's one-hot einsums against the port's gathers and
  per-slot sums);
- keep masks and dropped fractions exactly (the fraction's mean is taken
  as XLA:CPU takes it, by the float32 reciprocal of the count).
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.nn import moe as jmoe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import backbone as tbb  # noqa: E402
from repro_torch.nn import moe as tmoe  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

TOL = 1e-5
KEY = jax.random.PRNGKey(1)
D, F, E = 16, 32, 4
MAX_LEN = 40


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree))


def jax_keep(p, x, *, top_k, capacity_factor, group_size, min_capacity=4):
    """``repro.nn.moe.moe_apply``'s routing lines (:68-94), which it does
    not return: the (K, G, S) keep mask of its slot-major positions."""
    Bx, Tx, d = x.shape
    N = Bx * Tx
    S = jmoe._pick_group_size(N, group_size)
    G = N // S
    logits = jnp.einsum("gsd,de->gse", x.reshape(G, S, d).astype(jnp.float32),
                        p["router"]["w"].astype(jnp.float32))
    _, expert_idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), top_k)
    capacity = min(max(min_capacity, int(capacity_factor * S * top_k / E)), S)
    onehot = jax.nn.one_hot(jnp.moveaxis(expert_idx, -1, 0), E, dtype=jnp.float32)
    oh_km = onehot.transpose(1, 0, 2, 3).reshape(G, top_k * S, E)
    pos = jnp.cumsum(oh_km, axis=1) - oh_km
    pos = jnp.sum(pos * oh_km, axis=-1).reshape(G, top_k, S).transpose(1, 0, 2)
    return np.asarray(pos < capacity)


@pytest.fixture(scope="module")
def layer():
    """JAX's moe_init (d 16, d_ff 32, 4 experts), bridged, and inputs whose
    shared mean skews the routing (so a 1.25 capacity drops slots)."""
    jp = jmoe.moe_init(KEY, D, F, E)
    rng = np.random.RandomState(3)
    x = (rng.standard_normal((3, 8, D)) + 1.5 * rng.standard_normal(D)).astype(np.float32)
    return jp, _torch(_np(jp)), x


# capacity factors: the configured training one (drops here), E / k (the
# inference capacity for E <= 8) and 4.0 (for wide MoEs); group sizes 24
# (one group) and 8 (three groups)
@pytest.mark.parametrize("cf,gs,top_k", [(1.25, 4096, 2), (1.25, 8, 2), (2.0, 4096, 2),
                                         (4.0, 8, 2), (1.25, 4096, 1), (4 / 3, 8, 3)])
def test_moe_apply_matches_jax(layer, cf, gs, top_k):
    jp, tp, x = layer
    yj, auxj = jmoe.moe_apply(jp, jnp.asarray(x), top_k=top_k, capacity_factor=cf,
                              group_size=gs)
    yt, auxt = tmoe.moe_apply(tp, torch.as_tensor(x), top_k=top_k, capacity_factor=cf,
                              group_size=gs)
    r = tmoe.moe_routing(tp, torch.as_tensor(x), top_k=top_k, capacity_factor=cf,
                         group_size=gs)
    keep = r["keep"].reshape(r["G"], top_k, r["S"]).permute(1, 0, 2).numpy()
    np.testing.assert_array_equal(keep, jax_keep(jp, jnp.asarray(x), top_k=top_k,
                                                 capacity_factor=cf, group_size=gs))
    assert float(auxt["dropped_fraction"]) == float(auxj["dropped_fraction"])
    if cf == 1.25 and top_k == 2:
        assert float(auxt["dropped_fraction"]) > 0.0
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(auxt["load_balance_loss"]),
                               float(auxj["load_balance_loss"]), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("gs,top_k", [(4096, 2), (8, 3)])
def test_moe_apply_matches_reference_dropless(layer, gs, top_k):
    """At a capacity no expert fills, the grouped dispatch is the
    per-expert loop (the port's and JAX's)."""
    jp, tp, x = layer
    yt, aux = tmoe.moe_apply(tp, torch.as_tensor(x), top_k=top_k, capacity_factor=8.0,
                             group_size=gs)
    assert float(aux["dropped_fraction"]) == 0.0
    yr = tmoe.moe_reference(tp, torch.as_tensor(x), top_k=top_k)
    np.testing.assert_allclose(yt.numpy(), yr.numpy(), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(yr.numpy(), np.asarray(jmoe.moe_reference(
        jp, jnp.asarray(x), top_k=top_k)), atol=TOL, rtol=TOL)


def test_top_k_ties_take_the_lower_index():
    """Rows with tied probabilities pick experts in jax.lax.top_k's order;
    a router of equal columns ties every expert for every token."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1],
                      [0.3, 0.2, 0.3, 0.2], [0.0, 0.5, 0.0, 0.5]], np.float32)
    for k in (1, 2, 3):
        vj, ij = jax.lax.top_k(jnp.asarray(probs), k)
        vt, it = tmoe.top_k_stable(torch.as_tensor(probs), k)
        assert it.tolist() == np.asarray(ij).tolist()
        assert vt.tolist() == np.asarray(vj).tolist()
    jp = jmoe.moe_init(KEY, D, F, E)
    jp["router"]["w"] = jnp.zeros_like(jp["router"]["w"])
    x = np.random.RandomState(4).standard_normal((2, 4, D)).astype(np.float32)
    r = tmoe.moe_routing(_torch(_np(jp)), torch.as_tensor(x), top_k=2,
                         capacity_factor=1.0)
    assert (r["G"], r["S"], r["capacity"]) == (1, 8, 4)
    assert (r["experts"] == torch.tensor([0, 1])).all()
    keep = r["keep"].reshape(1, 2, 8).permute(1, 0, 2).numpy()
    np.testing.assert_array_equal(keep, jax_keep(jp, jnp.asarray(x), top_k=2,
                                                 capacity_factor=1.0, group_size=4096))
    assert keep.sum() == 8                  # 4 slots for each of experts 0, 1
    yj, auxj = jmoe.moe_apply(jp, jnp.asarray(x), top_k=2, capacity_factor=1.0)
    yt, auxt = tmoe.moe_apply(_torch(_np(jp)), torch.as_tensor(x), top_k=2,
                              capacity_factor=1.0)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=TOL, rtol=TOL)
    assert float(auxt["dropped_fraction"]) == float(auxj["dropped_fraction"]) == 0.5


def test_moe_serving_routes_and_refusals():
    """Mixed prompt lengths take one equal-length call per length (the
    scheduler rules MoE out); chunked prefill refuses MoE; bucketed
    prefill (lengths) runs.  A hybrid of the same MoE arch (attention and
    a Mamba block, both with MoE FFNs), once refused, now runs: its
    ``init_cache`` holds JAX's keys and shapes (K/V as (L, B, S, H, D)),
    and a decode step from a prefill gives the logits of a prefill one
    token longer, within the reference's prefill -> decode bar for Mamba
    (3e-4)."""
    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    params = tbb.init_params(cfg, 0, device="cpu")
    assert all(t.dtype == torch.float32 for t in params["blocks"][0]["moe"].values()
               if isinstance(t, torch.Tensor))
    eng = ServeEngine(cfg, params, max_len=MAX_LEN, device="cpu")
    rng = np.random.RandomState(7)
    reqs = [Request(tokens=rng.randint(0, cfg.vocab, n), max_new_tokens=3)
            for n in (5, 9, 5)]
    outs = eng.generate(reqs)
    for r, c in zip(reqs, outs):
        alone = ServeEngine(cfg, params, max_len=MAX_LEN, device="cpu").generate(
            [Request(tokens=r.tokens, max_new_tokens=3)])[0]
        assert c.tokens.tolist() == alone.tokens.tolist()
    cache = tbb.init_cache(cfg, 1, 16, device="cpu")
    with pytest.raises(ValueError, match="no MoE"):
        tbb.prefill_chunk(cfg, params, torch.zeros((1, 4), dtype=torch.long), cache, 0,
                          attend_width=4)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab, (2, 8)))
    logits, _, _ = tbb.prefill(cfg, params, {"tokens": toks},
                               lengths=torch.tensor([8, 5]))
    assert torch.isfinite(logits).all()
    from repro_torch.configs.base import HybridSpec
    from repro.configs import get_config as jax_get_config
    from repro.configs.base import HybridSpec as JaxHybridSpec
    from repro.models import backbone as jbb
    hybrid = dataclasses.replace(cfg, hybrid=HybridSpec(period=2))
    jhybrid = dataclasses.replace(jax_get_config("moonshot-v1-16b-a3b").reduced(),
                                  hybrid=JaxHybridSpec(period=2))
    assert tbb.sublayer_specs(hybrid) == jbb.sublayer_specs(jhybrid) == [
        {"kind": "attn", "ffn": "moe"}, {"kind": "mamba", "ffn": "moe"}]
    hp = tbb.init_params(hybrid, 0, device="cpu")
    jc = jbb.init_cache(jhybrid, 2, 16)
    tc = tbb.init_cache(hybrid, 2, 16, device="cpu")
    assert sorted(tc) == sorted(jc)
    assert all(tc[k].numel() == jc[k].size and str(tc[k].dtype)[6:] == str(jc[k].dtype)
               for k in jc)
    _, cache, T = tbb.prefill(hybrid, hp, {"tokens": toks}, max_len=16)
    step, _ = tbb.decode_step(hybrid, hp, toks[:, -1:], cache, T)
    full, _, _ = tbb.prefill(hybrid, hp, {"tokens": torch.cat([toks, toks[:, -1:]], 1)},
                             max_len=16)
    torch.testing.assert_close(step, full, atol=3e-4, rtol=3e-4)
