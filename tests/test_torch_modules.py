"""The port's layers and models on the CPU against the JAX package, on the
same seeded numpy inputs and bridged weights, at atol = rtol = 1e-5 fp32
(the sums run in another order in the two frameworks)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.compress import quantize as jq  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.nn import linear as jlinear  # noqa: E402
from repro.nn import norm as jnorm  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.compress import quantize as tq  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.nn import linear as tlinear  # noqa: E402
from repro_torch.nn import norm as tnorm  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
KEY = jax.random.PRNGKey(11)


def _np(shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).standard_normal(shape)
            ).astype(np.float32)


def _bridge(jax_params):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_params),
                             device="cpu")


def _close(jax_out, torch_out):
    np.testing.assert_allclose(torch_out.numpy(), np.asarray(jax_out), **TOL)


@pytest.mark.parametrize("H", [8, 9])
@pytest.mark.parametrize("kernel,stride", [(1, 1), (3, 1), (3, 2), (1, 2)])
def test_conv2d_same_padding_matches_jax(H, kernel, stride):
    p = jlinear.conv2d_init(KEY, 5, 7, kernel=kernel)
    p["b"] = jnp.asarray(_np((7,), 1))
    x = _np((2, H, H + 1, 5))
    want = jlinear.conv2d_apply(p, jnp.asarray(x), stride=stride)
    got = tlinear.conv2d(_bridge(p), torch.from_numpy(x), stride=stride)
    assert got.shape == want.shape
    _close(want, got)


@pytest.mark.parametrize("H,stride", [(8, 1), (8, 2), (7, 2)])
def test_depthwise_conv_matches_jax(H, stride):
    mid = 16
    p = jlinear.conv2d_init(KEY, 1, mid, kernel=3, use_bias=False)
    x = _np((2, H, H, mid), 2)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), p["w"], window_strides=(stride, stride),
        padding="SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=mid)
    got = tlinear.conv2d(_bridge(p), torch.from_numpy(x), stride=stride,
                         groups=mid)
    _close(want, got)


def test_dense_matches_jax():
    p = jlinear.dense_init(KEY, 12, 10)
    p["b"] = jnp.asarray(_np((10,), 3))
    x = _np((4, 12), 4)
    _close(jlinear.dense_apply(p, jnp.asarray(x)),
           tlinear.dense(_bridge(p), torch.from_numpy(x)))


@pytest.mark.parametrize("norm", ["groupnorm", "rmsnorm", "layernorm"])
def test_norms_match_jax(norm):
    C = 32
    p = {"scale": jnp.asarray(_np((C,), 5)), "bias": jnp.asarray(_np((C,), 6))}
    x = _np((2, 3, 3, C), 7, scale=3.0) + 1.5
    xj, xt, pt = jnp.asarray(x), torch.from_numpy(x), _bridge(p)
    if norm == "groupnorm":
        want = jnorm.groupnorm_apply(p, xj, groups=8)
        got = tnorm.groupnorm(pt, xt, groups=8)
        # per pixel over channel groups, not over H x W
        flat = torch.nn.functional.group_norm(
            xt.permute(0, 3, 1, 2), 8, pt["scale"], pt["bias"]).permute(0, 2, 3, 1)
        assert not torch.allclose(flat, got, **TOL)
    elif norm == "rmsnorm":
        want = jnorm.rmsnorm_apply({"scale": p["scale"]}, xj)
        got = tnorm.rmsnorm({"scale": pt["scale"]}, xt)
    else:
        want = jnorm.layernorm_apply(p, xj)
        got = tnorm.layernorm(pt, xt)
    _close(want, got)


def test_extractor_matches_jax():
    p = jcnn.extractor_init(KEY, channels=24, n_layers=2)
    x = _np((3, 16, 16, 3), 8)
    want = jcnn.extractor_apply(p, jnp.asarray(x))
    got = tcnn.extractor_apply(_bridge(p), torch.from_numpy(x))
    assert got.is_contiguous()
    _close(want, got)


@pytest.mark.parametrize("hidden", [0, 6])
def test_local_nn_matches_jax(hidden):
    p = jcnn.local_nn_init(KEY, 5, 10, hidden=hidden)
    x = _np((3, 4, 4, 5), 9)
    _close(jcnn.local_nn_apply(p, jnp.asarray(x)),
           tcnn.local_nn_apply(_bridge(p), torch.from_numpy(x)))


@pytest.mark.parametrize("H,blocks,width", [(4, 2, 64), (6, 3, 32), (5, 2, 64)])
def test_remote_nn_matches_jax(H, blocks, width):
    """Widths of 4+ channels per GroupNorm group: with 2 (width 16) the
    per-pixel variance of two values cancels, and both frameworks' own
    rounding grows past 1e-5 on some inputs."""
    p = jcnn.remote_nn_init(KEY, 19, 10, width=width, blocks=blocks)
    x = _np((2, H, H, 19), 10)
    _close(jax.jit(jcnn.remote_nn_apply)(p, jnp.asarray(x)),
           tcnn.remote_nn_apply(_bridge(p), torch.from_numpy(x)))


def test_mac_counters_match_jax():
    for args in [(96, 3, 24, 2), (16, 3, 24, 2), (32, 3, 8, 3)]:
        assert tcnn.extractor_macs(*args) == jcnn.extractor_macs(*args)
    for args in [(5, 10, 24, 0), (5, 10, 4, 7)]:
        assert tcnn.local_nn_macs(*args) == jcnn.local_nn_macs(*args)


def test_quantizer_matches_jax():
    centers = np.array(jq.quantizer_init(8)["centers"])
    # the two linspaces round differently by a few ulp
    np.testing.assert_allclose(tq.quantizer_init(8)["centers"].numpy(),
                               centers, rtol=0, atol=1e-6)
    pj, pt = {"centers": jnp.asarray(centers)}, {"centers": torch.from_numpy(centers)}
    x = _np((3, 4, 4, 19), 12, scale=3.0)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    idx = tq.hard_indices(pt, xt)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jq.hard_indices(pj, xj)))
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(tq.dequantize(pt, idx).numpy(),
                                  np.asarray(jq.dequantize(pj, jnp.asarray(idx.numpy()))))
    _close(jq.soft_quantize(pj, xj, temperature=0.5),
           tq.soft_quantize(pt, xt, temperature=0.5))
    for n in (2, 3, 8, 9, 16):
        assert tq.quantization_bits(n) == jq.quantization_bits(n)
