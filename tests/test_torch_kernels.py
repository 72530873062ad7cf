"""The port's offload kernels on the CPU: their plain PyTorch versions
(what ``ops.py`` runs for CPU tensors) held bit-exact against the JAX
package's oracles and its Pallas kernels in interpret mode, the fused
kernel's tile walk emulated, and the CUDA wrappers' input checks."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.offload_fused.ops import fused_offload_op  # noqa: E402
from repro.kernels.offload_fused.ref import offload_fused_ref as jax_fused_ref  # noqa: E402
from repro.kernels.quantize.ops import quantize_op as jax_quantize_op  # noqa: E402
from repro.kernels.quantize.ref import quantize_ref as jax_quantize_ref  # noqa: E402
from repro.kernels.topk_split.ops import split_op as jax_split_op  # noqa: E402
from repro.kernels.topk_split.ref import split_ref as jax_split_ref  # noqa: E402
from repro_torch.kernels.common import nearest_center_scan  # noqa: E402
from repro_torch.kernels.offload_fused.kernel import offload_fused_cuda  # noqa: E402
from repro_torch.kernels.offload_fused.ops import fused_offload  # noqa: E402
from repro_torch.kernels.offload_fused.ref import offload_fused_ref  # noqa: E402
from repro_torch.kernels.quantize.kernel import quantize_cuda  # noqa: E402
from repro_torch.kernels.quantize.ops import quantize_op  # noqa: E402
from repro_torch.kernels.quantize.ref import quantize_ref  # noqa: E402
from repro_torch.kernels.topk_split.kernel import channel_permute_cuda  # noqa: E402
from repro_torch.kernels.topk_split.ops import channel_permute_op, split_op  # noqa: E402


def assert_bitexact(jax_out, torch_out):
    """Same shape, dtype and bytes (so -0.0 != 0.0 and NaNs compare)."""
    a, b = np.asarray(jax_out), torch_out.numpy()
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes(), np.abs(a.astype(np.float64)
                                              - b.astype(np.float64)).max()


def _inputs(shape, C, L, seed=0):
    x = np.random.RandomState(seed).standard_normal(shape).astype(np.float32)
    perm = tuple(int(i) for i in np.random.RandomState(seed + 1).permutation(C))
    centers = np.array(jnp.linspace(-3, 3, L))
    return x, perm, centers


def _tie_inputs(rows, C, L):
    """Every input on a codebook midpoint or a center, with centers at
    half-integers: the two squared distances of a midpoint are exactly
    equal, so the scan must keep the lower index."""
    centers = (np.arange(L) - (L - 1) / 2).astype(np.float32)
    pool = np.concatenate([(centers[:-1] + centers[1:]) / 2, centers])
    x = np.resize(pool, rows * C).reshape(rows, C).astype(np.float32)
    return x, tuple(range(C))[::-1], centers


@pytest.mark.parametrize("shape,C,k", [((4, 6, 24), 24, 5), ((3, 24), 24, 7),
                                       ((7, 3, 3, 8), 8, 3)])
@pytest.mark.parametrize("L", [4, 8, 16])
def test_fused_offload_matches_jax(shape, C, k, L):
    x, perm, centers = _inputs(shape, C, L)
    ref = jax_fused_ref(jnp.asarray(x), jnp.asarray(centers), perm, k)
    pal = fused_offload_op(jnp.asarray(x), jnp.asarray(centers), perm=perm,
                           k=k, interpret=True)
    port = fused_offload(torch.from_numpy(x), torch.from_numpy(centers),
                         perm=perm, k=k)
    for r, p, t in zip(ref, pal, port):
        assert_bitexact(r, t)
        assert_bitexact(p, t)
        assert t.is_contiguous()


@pytest.mark.parametrize("rows", [1, 7, 8, 13, 250, 257])
def test_kernels_ragged_rows_match_jax(rows):
    C, k, L = 16, 5, 8
    x, perm, centers = _inputs((rows, C), C, L, seed=rows)
    xj, cj = jnp.asarray(x), jnp.asarray(centers)
    xt, ct = torch.from_numpy(x), torch.from_numpy(centers)

    for r, p, t in zip(jax_split_ref(xj, perm, k),
                       jax_split_op(xj, perm=perm, k=k, interpret=True),
                       split_op(xt, perm=perm, k=k)):
        assert_bitexact(r, t)
        assert_bitexact(p, t)
    for r, p, t in zip(jax_quantize_ref(xj, cj),
                       jax_quantize_op(xj, cj, interpret=True),
                       quantize_op(xt, ct)):
        assert_bitexact(r, t)
        assert_bitexact(p, t)
    for r, p, t in zip(jax_fused_ref(xj, cj, perm, k),
                       fused_offload_op(xj, cj, perm=perm, k=k, interpret=True),
                       fused_offload(xt, ct, perm=perm, k=k)):
        assert_bitexact(r, t)
        assert_bitexact(p, t)


@pytest.mark.parametrize("L", [4, 8, 16])
def test_ties_on_codebook_midpoints_go_to_lowest_index(L):
    C, k = 24, 5
    x, perm, centers = _tie_inputs(37, C, L)
    xj, cj = jnp.asarray(x), jnp.asarray(centers)
    xt, ct = torch.from_numpy(x), torch.from_numpy(centers)
    idx, deq = quantize_op(xt, ct)
    mids = np.isin(x, (centers[:-1] + centers[1:]) / 2)
    assert mids.any()
    # a midpoint between centers i and i+1 takes i
    lower = np.searchsorted(centers, x[mids]) - 1
    np.testing.assert_array_equal(idx.numpy()[mids], lower)
    for r, p, t in zip(jax_quantize_ref(xj, cj),
                       jax_quantize_op(xj, cj, interpret=True), (idx, deq)):
        assert_bitexact(r, t)
        assert_bitexact(p, t)
    for r, p, t in zip(jax_fused_ref(xj, cj, perm, k),
                       fused_offload_op(xj, cj, perm=perm, k=k, interpret=True),
                       fused_offload(xt, ct, perm=perm, k=k)):
        assert_bitexact(r, t)
        assert_bitexact(p, t)


def test_ops_plain_versions_agree_with_each_other():
    """The fused plain pass equals permute-then-quantize."""
    x, perm, centers = _inputs((5, 4, 4, 24), 24, 8, seed=3)
    xt, ct = torch.from_numpy(x), torch.from_numpy(centers)
    local, remote, idx, deq = offload_fused_ref(xt, ct, perm, 5)
    y = channel_permute_op(xt, perm)
    assert torch.equal(local, y[..., :5]) and torch.equal(remote, y[..., 5:])
    i2, d2 = quantize_ref(remote, ct)
    assert torch.equal(idx, i2) and torch.equal(deq, d2)


def _fused_tile_walk(x, centers, perm, k):
    """csrc/offload_fused.cu's data movement on the CPU: tiles of R = 4 *
    (768 // C) rows (a multiple of 4, so every tile starts on a 16-byte
    boundary in x and in each output), a table of tile offsets built from
    perm (the R*k local floats, then the R*(C-k) remote ones), each output
    float read from the tile through the table, the last tile cut to the
    rows left; the nearest-center scan of the plain version."""
    N, C = x.shape
    R, W = 4 * (3072 // (4 * C)), C - k
    table = np.array([(f // k) * C + perm[f % k] for f in range(R * k)]
                     + [(f // W) * C + perm[k + f % W] for f in range(R * W)],
                     np.int64)
    flat = x.reshape(-1)
    local, remote = np.empty(N * k, np.float32), np.empty(N * W, np.float32)
    for tile in range(-(-N // R)):
        rows = min(R, N - tile * R)
        s = flat[tile * R * C:(tile * R + rows) * C]
        local[tile * R * k:tile * R * k + rows * k] = s[table[:rows * k]]
        remote[tile * R * W:tile * R * W + rows * W] = \
            s[table[R * k:R * k + rows * W]]
    local, remote = torch.from_numpy(local), torch.from_numpy(remote)
    idx, deq = nearest_center_scan(remote, torch.from_numpy(centers))
    return tuple(t.reshape(N, -1) for t in (local, remote, idx, deq))


@pytest.mark.parametrize("rows", [1, 3, 5, 257])
@pytest.mark.parametrize("C", [3, 24, 64])
@pytest.mark.parametrize("k_of", ["0", "C/3", "C"])
def test_fused_tile_walk_matches_jax(rows, C, k_of):
    """The tile walk of the fused kernel, before the card: bit-exact with
    the JAX oracle at row counts off the float4 and the tile (257 rows is
    a ragged third tile at C = 24), any C, and k at 0 and C."""
    k = {"0": 0, "C/3": C // 3, "C": C}[k_of]
    x, perm, centers = _inputs((rows, C), C, 8, seed=rows * C)
    x *= 3
    ref = jax_fused_ref(jnp.asarray(x), jnp.asarray(centers), perm, k)
    for r, t in zip(ref, _fused_tile_walk(x, centers.astype(np.float32),
                                          perm, k)):
        assert_bitexact(r, t)


@pytest.mark.parametrize("call", ["offload_fused", "quantize", "topk_split"])
def test_cuda_wrappers_refuse_cpu_tensors(call):
    """A kernel wrapper handed a CPU tensor raises before it builds or
    launches anything: only ``ops.py`` picks the plain version."""
    x = torch.zeros(8, 24)
    c = torch.linspace(-1, 1, 8)
    launch = {
        "offload_fused": lambda: offload_fused_cuda(x, c, perm=range(24), k=5),
        "quantize": lambda: quantize_cuda(x, c),
        "topk_split": lambda: channel_permute_cuda(x, range(24)),
    }[call]
    with pytest.raises(ValueError, match="CUDA tensor"):
        launch()
