"""LZW codec (paper §6 uses standard LZW [49] after quantization).

A copy of ``repro.compress.lzw`` (numpy only), so the two packages frame
and size payloads identically.

Operates on byte sequences; used by the offload runtime to measure the
actual transmitted payload size (Table 2 / Figure 21(c) reproductions).
Pure Python — it runs on the host side of the serving engine.  The
encoder keys its dictionary on packed (prefix_code, byte) ints rather
than concatenated byte strings, so each input byte is O(1) dict work
with no string allocation; the variable-width stream size is a closed
form of the code count.
"""
from __future__ import annotations

import numpy as np


class PayloadCorruptionError(ValueError):
    """A payload failed to decode: truncated or bit-flipped on the air.

    Raised (instead of an uncaught KeyError/IndexError or silently wrong
    data) by `lzw_decode` on an impossible code and by `unpack_indices`
    on a payload too short for its framing.  The gateway treats it as a
    droppable fault — the request degrades to zero-filled channels or a
    Local-NN fallback instead of crashing the event loop."""


def lzw_encode(data: bytes) -> list[int]:
    """Classic LZW: returns a list of integer codes.

    The table maps (prefix_code << 8) | next_byte -> code; single bytes
    are implicitly codes 0..255.  Emitted codes are identical to the
    textbook string-keyed formulation.
    """
    if not data:
        return []
    table: dict[int, int] = {}
    next_code = 256
    out: list[int] = []
    w = data[0]
    for b in data[1:]:
        key = (w << 8) | b
        nxt = table.get(key)
        if nxt is not None:
            w = nxt
        else:
            out.append(w)
            table[key] = next_code
            next_code += 1
            w = b
    out.append(w)
    return out


# decoder codebook template: built once, copied per call — the 256
# single-byte entries never change, only the learned suffix does
_DECODE_BASE = {i: bytes([i]) for i in range(256)}


def lzw_decode(codes: list[int]) -> bytes:
    if not codes:
        return b""
    table = dict(_DECODE_BASE)
    next_code = 256
    if not isinstance(codes[0], int) or not 0 <= codes[0] < 256:
        raise PayloadCorruptionError(
            f"bad LZW stream head {codes[0]!r}: the first code must be a "
            "literal byte")
    w = table[codes[0]]
    out = [w]
    for c in codes[1:]:
        if not isinstance(c, int) or c < 0:
            raise PayloadCorruptionError(f"bad LZW code {c!r}")
        if c in table:
            entry = table[c]
        elif c == next_code:
            entry = w + w[:1]
        else:
            raise PayloadCorruptionError(
                f"bad LZW code {c} (table holds {next_code})")
        out.append(entry)
        table[next_code] = w + entry[:1]
        next_code += 1
        w = entry
    return b"".join(out)


def lzw_encoded_bytes(codes: list[int]) -> int:
    """Size of the code stream with variable-width packing (as the MCU
    implementation does): code i is emitted at the bit width needed for
    the table size at that moment — i.e. bit_length(256 + i), never below
    9.  Computed per contiguous width segment instead of per code."""
    n = len(codes)
    if n == 0:
        return 0
    bits = 0
    width = 9
    i = 0
    while i < n:
        hi = min(n, (1 << width) - 256)   # codes still emitted at `width`
        bits += (hi - i) * width
        i = hi
        width += 1
    return (bits + 7) // 8


def compress_payload(data: bytes) -> tuple[int, list[int]]:
    """Returns (compressed_byte_count, codes)."""
    codes = lzw_encode(data)
    return lzw_encoded_bytes(codes), codes


def pack_indices(idx: np.ndarray, bits: int) -> bytes:
    """Bit-pack quantization indices (H*W*C elements, `bits` bits each)."""
    idx = np.asarray(idx, dtype=np.uint8).ravel()
    if bits == 8:
        return idx.tobytes()
    bitstream = np.unpackbits(idx[:, None], axis=1, count=8)[:, 8 - bits:]
    return np.packbits(bitstream.ravel()).tobytes()


def packed_nbytes(bits: int, count: int) -> int:
    """Byte length of a well-framed ``pack_indices`` payload: `count`
    indices at `bits` bits, padded to a byte boundary."""
    return count if bits == 8 else (count * bits + 7) // 8


def unpack_indices(data: bytes, bits: int, count: int) -> np.ndarray:
    """Inverse of ``pack_indices``: the first `count` indices of a packed
    payload (trailing pad bits from the byte-boundary framing are
    discarded).  A payload shorter than its framing demands raises
    `PayloadCorruptionError` instead of returning a ragged array."""
    if len(data) < packed_nbytes(bits, count):
        raise PayloadCorruptionError(
            f"truncated payload: {len(data)} bytes cannot hold {count} "
            f"indices at {bits} bits")
    buf = np.frombuffer(data, np.uint8)
    if bits == 8:
        return buf[:count].astype(np.int32)
    bitstream = np.unpackbits(buf)[:count * bits].reshape(count, bits)
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.int32)
    return bitstream.astype(np.int32) @ weights


def unpack_indices_batch(payloads: list[bytes], bits: int,
                         count: int) -> np.ndarray:
    """Decode a batch of equal-framing payloads in one vectorized pass.

    Every payload packs exactly `count` indices at `bits` bits (the
    gateway groups arrivals by framing before decoding).  Returns a
    (B, count) int32 array, row-identical to per-payload
    ``unpack_indices``."""
    need = packed_nbytes(bits, count)
    if any(len(p) != len(payloads[0]) or len(p) < need for p in payloads):
        raise PayloadCorruptionError(
            f"ragged or truncated payload batch: need {need} bytes per row "
            f"for {count} indices at {bits} bits")
    buf = np.frombuffer(b"".join(payloads), np.uint8)
    buf = buf.reshape(len(payloads), -1)
    if bits == 8:
        return buf[:, :count].astype(np.int32)
    bitstream = np.unpackbits(buf, axis=1)[:, :count * bits]
    bitstream = bitstream.reshape(len(payloads), count, bits)
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.int32)
    return bitstream.astype(np.int32) @ weights


def pack_indices_batch(idx: np.ndarray, bits: int) -> list[bytes]:
    """Bit-pack a whole batch in one vectorized pass.

    idx: (B, ...) index array.  Returns one bytes object per sample,
    byte-identical to ``pack_indices(idx[b], bits)`` (each sample is
    padded to its own byte boundary, matching the per-sample radio
    framing)."""
    idx = np.asarray(idx, dtype=np.uint8).reshape(idx.shape[0], -1)
    if bits == 8:
        return [row.tobytes() for row in idx]
    # MSB-first bit expansion by shifts: skips the 8-wide unpackbits
    # intermediate and its non-contiguous slice
    shifts = np.arange(bits - 1, -1, -1, dtype=np.uint8)
    bitstream = (idx[..., None] >> shifts) & 1
    packed = np.packbits(bitstream.reshape(idx.shape[0], -1), axis=1)
    return [row.tobytes() for row in packed]
