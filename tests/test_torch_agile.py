"""The port's AgileNN deployment slice on the CPU: against the JAX package
on bridged params and seeded numpy images (logits at atol = rtol = 1e-5,
indices bit-exact on shared features, payload bytes and costs equal), and
the port's own bit-identity claims (split halves == one forward, fused ==
two-pass)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.agilenn_cifar import gateway_demo_config as jax_config  # noqa: E402
from repro.core import agile as jagile  # noqa: E402
from repro.kernels.offload_fused.ref import offload_fused_ref as jax_fused_ref  # noqa: E402
from repro.models.cnn import extractor_apply as jax_extractor  # noqa: E402
from repro.serve import offload as joffload  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.compress.quantize import dequantize  # noqa: E402
from repro_torch.configs.agilenn_cifar import gateway_demo_config  # noqa: E402
from repro_torch.core import agile  # noqa: E402
from repro_torch.kernels.offload_fused.ops import fused_offload  # noqa: E402
from repro_torch.serve import offload  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
JCFG, CFG = jax_config(), gateway_demo_config()


@pytest.fixture(scope="module")
def params():
    """(JAX params, the port's params bridged from them), shuffled mapping."""
    jp = jagile.init_agile_params(JCFG, jax.random.PRNGKey(7))
    jp["mapping"] = jnp.asarray(
        np.random.RandomState(3).permutation(JCFG.extractor_channels), jnp.int32)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")


def _images(B, seed=0):
    return np.random.RandomState(seed).standard_normal(
        (B, CFG.image_size, CFG.image_size, 3)).astype(np.float32)


def test_config_matches_jax():
    assert dataclasses.asdict(CFG) == dataclasses.asdict(JCFG)


def test_init_agile_params_tree_matches_jax(params):
    """Same tree and shapes as the JAX init (after the HWIO->OIHW bridge),
    deterministic in the seed."""
    _, bridged = params
    p = agile.init_agile_params(CFG, 0, device="cpu")
    q = agile.init_agile_params(CFG, 0, device="cpu")
    shapes = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: tuple(a.shape) if hasattr(a, "shape") else a, t)
    assert shapes(p) == shapes({**bridged, "mapping": p["mapping"]})
    assert p["mapping"] == tuple(range(CFG.extractor_channels))
    for a, b in zip(jax.tree_util.tree_leaves(p), jax.tree_util.tree_leaves(q)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


@pytest.mark.parametrize("use_fused", [True, False])
def test_agile_forward_matches_jax(params, use_fused):
    jp, tp = params
    x = _images(4)
    lj, ij = jagile.agile_forward(JCFG, jp, jnp.asarray(x), train=False,
                                  use_fused=use_fused)
    lt, it = agile.agile_forward(CFG, tp, x, use_fused=use_fused)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    for key in ("features", "local_logits", "remote_logits", "alpha"):
        np.testing.assert_allclose(it[key].numpy(), np.asarray(ij[key]), **TOL)


def test_offload_indices_bitexact_on_shared_features(params):
    """On the same extractor output, the port's offload pass gives the JAX
    indices bit for bit; end to end (each package's own extractor) the
    fraction of indices that flip is reported."""
    jp, tp = params
    x = _images(6, seed=1)
    raw = jax_extractor(jp["extractor"], jnp.asarray(x))
    perm = tuple(int(p) for p in np.asarray(jp["mapping"]))
    want = jax_fused_ref(raw, jp["quant"]["centers"], perm, CFG.agile.k)
    got = fused_offload(torch.from_numpy(np.array(raw)), tp["quant"]["centers"],
                        perm=tp["mapping"], k=CFG.agile.k)
    for w, g in zip(want, got):
        assert np.asarray(w).tobytes() == g.numpy().tobytes()

    idx_j = np.asarray(jagile.offload_payload_arrays(JCFG, jp, jnp.asarray(x)))
    idx_t = agile.offload_payload_arrays(CFG, tp, x).numpy()
    flips = float(np.mean(idx_j != idx_t))
    print(f"end-to-end index flips: {flips:.3e} of {idx_j.size}")
    assert idx_t.dtype == np.int32 and idx_t.shape == idx_j.shape


@pytest.mark.parametrize("B", [1, 3, 6])
def test_measure_payload_matches_jax(params, B):
    jp, tp = params
    x = _images(B, seed=B)
    bytes_j, idx_j = joffload.measure_payload(JCFG, jp, jnp.asarray(x))
    bytes_t, idx_t = offload.measure_payload(CFG, tp, x)
    if np.array_equal(idx_j, idx_t):
        assert bytes_t == bytes_j
    assert offload.measure_payload(CFG, tp, x, use_fused=False)[0] == bytes_t


def test_run_offload_inference_matches_jax(params):
    jp, tp = params
    x = _images(5, seed=2)
    preds_j, cost_j = joffload.run_offload_inference(JCFG, jp, jnp.asarray(x))
    preds_t, cost_t = offload.run_offload_inference(CFG, tp, x)
    np.testing.assert_array_equal(preds_t, np.asarray(preds_j))
    assert dataclasses.asdict(cost_t) == dataclasses.asdict(cost_j)
    assert (offload.energy_per_inference(CFG, cost_t)
            == joffload.energy_per_inference(JCFG, cost_j))
    for feat_hw in (4, 24):
        assert (offload.remote_nn_macs(CFG, feat_hw)
                == joffload.remote_nn_macs(JCFG, feat_hw))
        assert (offload.local_path_macs(CFG, feat_hw)
                == joffload.local_path_macs(JCFG, feat_hw))


def test_split_halves_equal_one_forward(params):
    """device_forward -> dequantize -> remote_forward is bit-identical to
    agile_forward, and device_forward_fn is device_forward."""
    _, tp = params
    x = _images(3, seed=4)
    logits, _ = agile.agile_forward(CFG, tp, x)
    local_logits, f_remote, idx = agile.device_forward(CFG, tp, x)
    split = agile.remote_forward(CFG, tp, dequantize(tp["quant"], idx),
                                 local_logits)
    assert torch.equal(split, logits)
    for a, b in zip(agile.device_forward_fn(CFG, tp)(tp, x),
                    (local_logits, f_remote, idx)):
        assert torch.equal(a, b)
    assert torch.equal(agile.agile_predict(CFG, tp, x)[0], logits)


def test_fused_equals_two_pass(params):
    _, tp = params
    x = _images(3, seed=5)
    l1, i1 = agile.agile_forward(CFG, tp, x, use_fused=True)
    l2, i2 = agile.agile_forward(CFG, tp, x, use_fused=False)
    assert torch.equal(l1, l2) and torch.equal(i1["features"], i2["features"])
    for a, b in zip(agile.device_forward(CFG, tp, x, use_fused=True),
                    agile.device_forward(CFG, tp, x, use_fused=False)):
        assert torch.equal(a, b)
