"""Decode attention over a cache cut into blocks of slots, as the meshed
decode runs it on a cache that ``cache_shardings`` splits along its
sequence (``kernels/decode_attention/ops.py``): each block through the
plain ``decode_attention_ref(return_lse=True)`` with its live count
(``block_attend``), the blocks combined by ``combine_blocks``.

Held to the unsplit call within 2e-5 (float32, the bar of
tests/test_decode_attention.py), for blocks with no live slot, a per-row
(B,) ``attend_len`` with an empty row, and a ring cache past its wrap
(every slot live); the log-sum-exp against a float64 one of the same
scores, -inf where a block or a row has no live slot; ``return_lse``
leaves the output's bits as they are.  All on the CPU, in milliseconds.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention.ops import block_attend, combine_blocks  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402

TOL = 2e-5

# (B, S, Hq, Hkv, D, blocks, attend): attend an int, a list (per row), or
# "wrap" (a ring past its wrap: every slot live)
CASES = [
    (2, 64, 4, 2, 64, 4, 9),            # blocks 1-3 have no live slot
    (3, 96, 8, 2, 32, 4, [0, 50, 96]),  # per row, an empty row
    (2, 48, 6, 3, 16, 3, "wrap"),
    (1, 256, 14, 2, 64, 16, 131),       # qwen2's group of 7, 16 blocks
    (4, 32, 8, 8, 128, 2, [1, 17, 31, 32]),
    (2, 40, 4, 1, 64, 5, 0),            # no live slot anywhere
]


def _inputs(B, S, Hq, Hkv, D, attend, seed=0):
    rs = np.random.RandomState(seed)
    q, k, v = (torch.tensor(rs.standard_normal(shape).astype(np.float32))
               for shape in ((B, 1, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    if attend == "wrap":
        attend = min(S + 17, S)           # cache_len past S: attend_len = S
    if isinstance(attend, list):
        attend = torch.tensor(attend)
    return q, k, v, attend


def _split(q, k, v, attend, blocks):
    size = k.shape[1] // blocks
    outs, lses = zip(*(decode_attention_ref(q, k[:, i * size:(i + 1) * size],
                                            v[:, i * size:(i + 1) * size],
                                            block_attend(attend, i * size, size),
                                            return_lse=True)
                       for i in range(blocks)))
    return torch.stack(outs), torch.stack(lses)


def _lse64(q, k, attend):
    """float64 log-sum-exp of each (row, query head)'s scaled scores over
    its live slots."""
    B, _, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    s = torch.einsum("bhgd,bshd->bhgs", q.double().reshape(B, Hkv, Hq // Hkv, D),
                     k.double()) / math.sqrt(D)
    live = torch.arange(S)[None, :] < torch.as_tensor(attend).reshape(-1, 1)
    s = torch.where(live[:, None, None, :], s, -math.inf)
    return torch.logsumexp(s, dim=-1).reshape(B, Hq)


@pytest.mark.parametrize("B,S,Hq,Hkv,D,blocks,attend", CASES)
def test_blocks_combine_to_the_unsplit_call(B, S, Hq, Hkv, D, blocks, attend):
    q, k, v, attend = _inputs(B, S, Hq, Hkv, D, attend)
    want = decode_attention_ref(q, k, v, attend)
    outs, lses = _split(q, k, v, attend, blocks)
    got = combine_blocks(outs, lses)
    assert got.shape == want.shape and got.dtype == want.dtype
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("B,S,Hq,Hkv,D,blocks,attend", CASES)
def test_lse_matches_float64(B, S, Hq, Hkv, D, blocks, attend):
    q, k, v, attend = _inputs(B, S, Hq, Hkv, D, attend, seed=1)
    out, lse = decode_attention_ref(q, k, v, attend, return_lse=True)
    assert lse.shape == (B, Hq) and lse.dtype == torch.float32
    want = _lse64(q, k, attend)
    dead = torch.isinf(want)
    assert torch.equal(torch.isneginf(lse), dead)
    torch.testing.assert_close(lse[~dead].double(), want[~dead], atol=TOL, rtol=TOL)
    assert torch.equal(out, decode_attention_ref(q, k, v, attend))
    _, lses = _split(q, k, v, attend, blocks)
    size = S // blocks
    for i in range(blocks):
        block = _lse64(q, k[:, i * size:(i + 1) * size], block_attend(attend, i * size, size))
        assert torch.equal(torch.isneginf(lses[i]), torch.isinf(block))


def test_block_attend_clamps_ints_and_rows():
    assert [block_attend(9, s, 16) for s in (0, 16, 32)] == [9, 0, 0]
    assert [block_attend(40, s, 16) for s in (0, 16, 32)] == [16, 16, 8]
    rows = torch.tensor([0, 20, 48])
    assert block_attend(rows, 16, 16).tolist() == [0, 4, 16]


def test_combine_keeps_a_bf16_output_dtype():
    q, k, v, attend = _inputs(2, 64, 4, 2, 64, [5, 64])
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    outs, lses = _split(q, k, v, attend, 4)
    got = combine_blocks(outs, lses)
    want = decode_attention_ref(q, k, v, attend)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


def _err64(got, ref):
    return float((got.double() - ref).abs().max())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_split_error_is_the_unsplit_calls(seed):
    """A bf16 cache in 16 blocks, each block's output rounded to bf16
    before the combine: its error against the float32 call at most 2 x
    the unsplit bf16 call's (chip_smoke.py's phase 21e bar, which scales
    with the output), while a combine that drops a block or ignores the
    blocks' weights exceeds that bar tenfold."""
    B, S, Hq, Hkv, D, blocks = 4, 8192, 8, 1, 128, 16
    q, k, v, _ = _inputs(B, S, Hq, Hkv, D, S, seed=seed)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    ref = decode_attention_ref(q.float(), k.float(), v.float(), S).double()
    outs, lses = _split(q, k, v, S, blocks)
    bar = 2 * _err64(decode_attention_ref(q, k, v, S), ref)
    assert _err64(combine_blocks(outs, lses), ref) <= bar
    assert _err64(combine_blocks(outs[1:], lses[1:]), ref) > 10 * bar
    assert _err64(combine_blocks(outs, torch.zeros_like(lses)), ref) > 10 * bar
