"""The quantize kernel's walks on the CPU: a plain-torch emulation of
``csrc/quantize.cu`` (the block's choice between the scan and the binary
search of a sorted codebook, both searches step for step, the edge rules)
held bit for bit against the port's scan (``quantize_ref``, what the
kernel must reproduce) and against JAX's argmin oracle where that one is
defined the same way (a finite least distance).  The card runs the same
cases in ``chip_smoke.py`` phase 13a."""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _hypothesis_compat import given, settings, st  # noqa: E402
from repro.kernels.quantize.ref import quantize_ref as jax_quantize_ref  # noqa: E402
from repro_torch.compress.quantize import linspace_f32  # noqa: E402
from repro_torch.kernels.common import nearest_center_scan  # noqa: E402
from repro_torch.kernels.quantize.kernel import MAX_CENTERS, SEARCH_MIN_CENTERS  # noqa: E402
from repro_torch.kernels.quantize.ref import quantize_ref  # noqa: E402

F32 = np.float32
INF = F32(np.inf)


def _sq(x, c):
    t = x - c
    return t * t


def _bisect(lo, hi, below):
    """The kernel's ``while (lo < hi)`` loop, per element: ``below(mid)``
    True moves lo past mid, False moves hi to mid."""
    while bool((lo < hi).any()):
        live = lo < hi
        mid = (lo + hi) // 2
        b = below(mid)
        lo = torch.where(live & b, mid + 1, lo)
        hi = torch.where(live & ~b, mid, hi)
    return lo


def search_emulated(x, c):
    """``nearest_sorted``: p the first c[p] >= x; the left candidate the
    first j <= p - 1 at c[p-1]'s distance; the left one unless the right
    one's distance is smaller; index 0 and 0.0 when no distance is below
    inf (a NaN or infinite x, or squares past the float range)."""
    L = c.numel()
    zero = torch.zeros(x.shape, dtype=torch.long)
    p = _bisect(zero, torch.full(x.shape, L), lambda m: c[m.clamp(max=L - 1)] < x)
    pl = (p - 1).clamp(min=0)
    dl = _sq(x, c[pl])
    j = _bisect(zero, pl, lambda m: ~(_sq(x, c[m]) <= dl))
    left = (p > 0) & (dl < INF)
    best_d = torch.where(left, dl, torch.full_like(x, INF))
    best_i = torch.where(left, j, zero)
    best_v = torch.where(left, c[j], torch.zeros_like(x))
    pr = p.clamp(max=L - 1)
    right = (p < L) & (_sq(x, c[pr]) < best_d)
    return torch.where(right, pr, best_i).int(), torch.where(right, c[pr], best_v)


def takes_search(c) -> bool:
    """The block's choice: L >= SEARCH_MIN_CENTERS, every center finite
    and none below the one before it."""
    return (c.numel() >= SEARCH_MIN_CENTERS and bool(torch.isfinite(c).all())
            and bool((c[1:] >= c[:-1]).all()))


def kernel_emulated(x, c):
    return search_emulated(x, c) if takes_search(c) else nearest_center_scan(x, c)


def adversarial(c: np.ndarray) -> np.ndarray:
    """Every center and midpoint (float32 and float64-rounded) and the
    floats on either side of each, +-inf, NaN, +-3e38, subnormals, +-0,
    and points past either end (chip_smoke.py's ``quantize_adversarial``)."""
    c = c.astype(F32)
    with np.errstate(over="ignore", invalid="ignore"):
        mids = np.concatenate([(c[:-1] + c[1:]) / F32(2),
                               ((c[:-1].astype(np.float64) + c[1:]) / 2).astype(F32)])
        fin = c[np.isfinite(c)]
        ends = np.array([fin.min() - 1, fin.max() + 1, fin.min() * 2, fin.max() * 2], F32)
        pool = [c, np.nextafter(c, INF), np.nextafter(c, -INF), mids,
                np.nextafter(mids, INF), np.nextafter(mids, -INF), ends,
                np.array([INF, -INF, np.nan, 3e38, -3e38, 1e-45, -1e-45, 1e-40, -1e-40,
                          0.0, -0.0], F32)]
    return np.concatenate(pool).astype(F32)


def unsorted_linspace(L=256, seed=30) -> np.ndarray:
    """A ``linspace_f32`` grid from lo < hi of one sign that steps down
    somewhere, as narrow ranges do (chip_smoke.py's ``unsorted_linspace``)."""
    rng = np.random.RandomState(seed)
    while True:
        a = float(rng.uniform(0.01, 100.0)) * (1 if rng.rand() < 0.5 else -1)
        lo, hi = sorted([a, a * (1 + 10 ** rng.uniform(-6, -1))])
        c = linspace_f32(L, lo, hi)
        if (np.diff(c) < 0).any():
            return c


def check_against_oracles(x: np.ndarray, c: np.ndarray):
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    idx, val = kernel_emulated(xt, ct)
    ref_i, ref_v = quantize_ref(xt, ct)
    np.testing.assert_array_equal(idx.numpy(), ref_i.numpy())
    np.testing.assert_array_equal(val.numpy().view(np.int32), ref_v.numpy().view(np.int32))
    # JAX's argmin agrees with the scan where the least distance is finite
    # (the scan keeps 0.0 where every distance is inf or NaN; argmin a center)
    with np.errstate(over="ignore", invalid="ignore"):
        d = (x[:, None] - c[None, :]) ** 2
    least = np.where(np.isnan(d), np.inf, d).min(-1)
    ok = np.isfinite(least) & np.isfinite(x)
    if np.isfinite(c).all() and ok.any():
        ji, jv = (np.asarray(t) for t in jax_quantize_ref(jnp.asarray(x), jnp.asarray(c)))
        np.testing.assert_array_equal(idx.numpy()[ok], ji[ok])
        np.testing.assert_array_equal(val.numpy()[ok].view(np.int32), jv[ok].view(np.int32))
    return takes_search(ct)


def _page(seed=0, n=4096):
    return (np.random.RandomState(seed).standard_normal(n) * 2).astype(F32)


CODEBOOKS = {
    "straddling 0": lambda: linspace_f32(256, -5.3, 4.1),
    "one sign, sorted": lambda: linspace_f32(256, 0.25, 7.5),
    "one sign, stepping down": unsorted_linspace,
    "runs of 4 equal centers": lambda: np.repeat(linspace_f32(64, -3.0, 3.0), 4),
    "runs of random lengths": lambda: np.sort(
        np.random.RandomState(31).choice(linspace_f32(40, -3.0, 3.0), 256)),
    "a 1e-30-wide grid": lambda: linspace_f32(256, -5e-31, 5e-31),
    "a grid over +-3e38": lambda: linspace_f32(256, -3e38, 3e38),
    "subnormal centers": lambda: linspace_f32(256, -1e-40, 1e-40),
    "an inf center": lambda: np.append(linspace_f32(255, -3.0, 3.0), INF),
    "a NaN center": lambda: np.insert(linspace_f32(255, -3.0, 3.0), 100, F32(np.nan)),
    "L = 16": lambda: linspace_f32(16, -3.0, 3.0),
    "L = 17": lambda: linspace_f32(17, -3.0, 3.0),
    "L = 8": lambda: linspace_f32(8, -4.0, 4.0),
}
# the block's walk for each codebook
SEARCHES = {"straddling 0": True, "one sign, sorted": True,
            "one sign, stepping down": False, "runs of 4 equal centers": True,
            "runs of random lengths": True, "a 1e-30-wide grid": True,
            "a grid over +-3e38": True, "subnormal centers": True,
            "an inf center": False, "a NaN center": False, "L = 16": False,
            "L = 17": True, "L = 8": False}


@pytest.mark.parametrize("book", list(CODEBOOKS))
def test_search_is_the_scan_bit_for_bit(book):
    """Adversarial inputs and a page of normal draws on each codebook: the
    emulated kernel's index and value equal the scan's bit for bit, and
    JAX's argmin where it is defined alike; the block takes the walk
    expected of the codebook (a grid that steps down takes the scan)."""
    c = CODEBOOKS[book]().astype(F32)
    x = np.concatenate([adversarial(c), _page()])
    assert check_against_oracles(x, c) is SEARCHES[book]


def test_linspace_grids_of_both_kinds():
    """``linspace_f32`` at L = 256 over ranges that straddle 0 (as K/V
    pages do) is sorted; over narrow one-signed ranges lo < hi it
    sometimes steps down, and each such grid is left to the scan."""
    rng = np.random.RandomState(7)
    stepped = 0
    for _ in range(40):
        a, b = rng.uniform(0.01, 50.0, 2)
        straddle = linspace_f32(256, -float(a), float(b))
        assert (np.diff(straddle) >= 0).all()
        lo, hi = sorted([float(a), float(a) * (1 + 10 ** rng.uniform(-6, -3))])
        same = linspace_f32(256, lo, hi)
        stepped += int((np.diff(same) < 0).any())
        for c in (straddle, same):
            x = np.concatenate([adversarial(c)[:2000], _page(int(a * 100), 256) * (hi - lo)
                                + F32(lo)]).astype(F32)
            assert check_against_oracles(x, c) is bool((np.diff(c) >= 0).all())
    assert stepped > 0


def test_search_threshold_matches_the_kernel():
    """SEARCH_MIN_CENTERS and MAX_CENTERS in kernel.py are the .cu's."""
    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
           / "quantize.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kSearchMinCenters"]) == SEARCH_MIN_CENTERS
    assert int(consts["kMaxQuantCenters"]) == MAX_CENTERS


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 256), st.floats(-1e4, 1e4, width=32), st.floats(0, 1e4, width=32),
       st.integers(0, 2**31 - 1))
def test_search_sweep(L, lo, width, seed):
    """Random grids (sorted ones take the search from L = 17 up), inputs
    over and past them and on their midpoints."""
    c = linspace_f32(L, lo, lo + width)
    rng = np.random.RandomState(seed)
    span = max(float(width), 1e-3)
    x = np.resize(np.concatenate([adversarial(c)[:600],
                                  rng.uniform(lo - span, lo + 2 * span, 200)]), 800).astype(F32)
    check_against_oracles(x, c)
