"""Shared-prefix page cache for the decode slot pool: refcounted physical
pages with a quantized host tier.

The port of ``repro.serve.prefix_cache``.  Most prompts of a fleet share
a head (a system prompt, a few-shot header), so the K/V pages that head
prefills into are identical across admissions: a page's values depend
only on the token prefix up to its end.  Pages are content-addressed by a
*chain hash* over the full token prefix; an admission that finds its
leading pages resident seeds them into its slot and prefills only the
suffix, and every page a live slot was built from is pinned by refcount
until the slot is released.

Ownership model (the scheduler's side is in ``serve.scheduler``):

  * **page table** — ``key -> _Entry``; the key of page p is
    ``H(key_{p-1} || tokens[p*page : (p+1)*page])``, so two prompts share
    page p only when they agree on *every* token before it.  The page
    holding a prompt's final token is never shareable: the admission must
    compute its last position itself for its first-token logits.
  * **copy-on-write, hoisted to inject** — slots never alias pages: a
    slot's only write below its prompt length is the inject, which copies
    the seeded pages into the pool; decode appends strictly above the
    prompt, so a slot never mutates a shared page.
  * **refcounts** — ``pin(slot, ...)`` takes a reference on every
    shareable page of the slot's prompt (inserting the pages the slot just
    prefilled); ``release(slot)`` drops them.  Referenced pages are never
    demoted or dropped, so a fetch for an occupied slot is served hot.
  * **two tiers** — hot pages are device tensors, one ``(n_layers, page,
    n_kv, head_dim)`` copy per page for K and for V (the JAX package's
    ``(n_sb, n_attn, page, n_kv, hd)`` flattens in the same order).  Past
    ``hot_pages``, unreferenced pages demote LRU to a host tier: each
    quantized to ``2**bits`` uniform centers over the page's own range
    (the quantize kernel on a CUDA page) and bit-packed
    (``compress.lzw.pack_indices``).  A hit on a cold page decompresses it
    back to the device.  The tier is *lossy* by design; runs that need
    exact replay size ``hot_pages`` to their working set or set
    ``cold_bytes=0`` so cold pages drop instead.

The codebook is ``compress.quantize.linspace_f32``, which rounds as the
JAX package's ``jnp.linspace`` does, so a page's cold blob ``(payload,
lo, hi)`` is the JAX package's byte for byte.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from repro_torch.compress.lzw import pack_indices, unpack_indices
from repro_torch.compress.quantize import hard_indices, linspace_f32


def page_keys(tokens, page_size: int) -> list[bytes]:
    """Chain-hash keys for every *shareable* page of a prompt.

    Key p digests the whole token prefix through page p (each digest
    extends the previous hash state), so equal keys imply equal prefixes.
    Pages at or past the final token are excluded: the admission owns its
    last position (first-token logits come from it)."""
    toks = np.ascontiguousarray(np.asarray(tokens, np.int64))
    n = max(0, (len(toks) - 1) // page_size)
    h = hashlib.sha1(np.int64(page_size).tobytes())
    keys = []
    for p in range(n):
        h.update(toks[p * page_size:(p + 1) * page_size].tobytes())
        keys.append(h.digest())
    return keys


class _Entry:
    """One physical page: device-resident K/V and/or a compressed host
    blob, pinned by the slots built from it."""

    __slots__ = ("key", "refs", "hot", "cold", "stamp")

    def __init__(self, key: bytes):
        self.key = key
        self.refs = 0        # live slots whose cache was seeded/built here
        self.hot = None      # {"k","v"}: (n_layers, page, n_kv, hd)
        self.cold = None     # {"k","v"}: (payload, lo, hi) packed indices
        self.stamp = 0       # LRU tick


class PrefixCache:
    """Refcounted page table over prompt-prefix K/V, with a hot device
    tier and a quantized cold host tier.

    hot_pages:  device-resident page budget; referenced pages are pinned
                and may transiently overflow it.
    cold_bytes: host-tier payload budget for demoted pages (0: demotion
                drops the page outright).
    bits:       codebook bits per element in the cold tier (<= 8, the
                bit-packer's framing).
    """

    def __init__(self, page_size: int, *, hot_pages: int = 512,
                 cold_bytes: int = 0, bits: int = 8):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if not 1 <= bits <= 8:
            raise ValueError(f"the cold tier packs 1-8 bits per element, "
                             f"got {bits}")
        self.page_size = page_size
        self.hot_pages = hot_pages
        self.cold_bytes = cold_bytes
        self.bits = bits
        self._index: dict[bytes, _Entry] = {}
        self._slot_keys: dict[int, list[bytes]] = {}
        self._parked: dict[object, list[bytes]] = {}
        self._tick = 0
        self._cold_used = 0
        self._page_shape = None      # (n_layers, page, n_kv, hd)
        self._dtype = None
        self._device = None
        self.stats = {"page_lookups": 0, "page_hits": 0, "inserts": 0,
                      "demotions": 0, "promotions": 0, "hot_drops": 0,
                      "cold_drops": 0}

    # ------------------------------------------------------------ queries --

    @property
    def hit_rate(self) -> float:
        """Pages served from the cache / shareable pages of admitted
        prompts (deterministic for a fixed workload + schedule)."""
        return self.stats["page_hits"] / max(1, self.stats["page_lookups"])

    @property
    def n_hot(self) -> int:
        return sum(1 for e in self._index.values() if e.hot is not None)

    @property
    def n_cold(self) -> int:
        return sum(1 for e in self._index.values() if e.cold is not None)

    @property
    def cold_used_bytes(self) -> int:
        return self._cold_used

    def lookup(self, tokens) -> tuple[list[bytes], int]:
        """(page keys of the prompt, length of the leading resident run).
        A pure query: admission stats are recorded by `record` only when a
        request is admitted, so re-planning the same queue head across
        rounds does not inflate the hit rate."""
        keys = page_keys(tokens, self.page_size)
        n = 0
        for k in keys:
            if k not in self._index:
                break
            n += 1
        return keys, n

    def record(self, n_pages: int, n_seeded: int) -> None:
        """Account one admission: n_pages shareable pages looked up,
        n_seeded of them served from the cache."""
        self.stats["page_lookups"] += n_pages
        self.stats["page_hits"] += n_seeded

    # ----------------------------------------------------------- transfer --

    def fetch(self, keys: list[bytes]) -> dict:
        """K/V for a resident run of pages, concatenated on the token axis
        (1), promoting cold pages back to the device on the way."""
        ks, vs = [], []
        for key in keys:
            e = self._index[key]
            self._touch(e)
            if e.hot is None:
                e.hot = {"k": self._decompress(e.cold["k"]),
                         "v": self._decompress(e.cold["v"])}
                self.stats["promotions"] += 1
            ks.append(e.hot["k"])
            vs.append(e.hot["v"])
        if len(ks) == 1:
            return {"k": ks[0], "v": vs[0]}
        return {"k": torch.cat(ks, dim=1), "v": torch.cat(vs, dim=1)}

    def pin(self, slot: int, keys: list[bytes], k_rows, v_rows) -> None:
        """Reference every shareable page of a freshly admitted slot,
        inserting the ones it prefilled itself.  k_rows/v_rows are the
        slot's cache rows, (n_layers, W, n_kv, hd) with W >= len(keys) *
        page_size; per-page slices are copies, so entries never alias (or
        pin) a slot's cache buffer."""
        if slot in self._slot_keys:
            raise ValueError(f"slot {slot} already pinned")
        page = self.page_size
        for p, key in enumerate(keys):
            e = self._index.get(key)
            sl = (slice(None), slice(p * page, (p + 1) * page))
            if e is None:
                e = _Entry(key)
                e.hot = {"k": k_rows[sl].clone(), "v": v_rows[sl].clone()}
                self._register_shape(e.hot["k"])
                self._index[key] = e
                self.stats["inserts"] += 1
            elif e.hot is None:
                # resident only as a cold blob: the slot's own rows hold
                # the values it was seeded from, rehydrate for free
                e.hot = {"k": k_rows[sl].clone(), "v": v_rows[sl].clone()}
            e.refs += 1
            self._touch(e)
        self._slot_keys[slot] = list(keys)
        self._enforce_budgets()

    def release(self, slot: int) -> None:
        """Drop the slot's references; unpinned pages become demotion
        candidates.  Unknown slots are a no-op (staging admissions that
        abort before finishing were never pinned)."""
        self._drop_refs(self._slot_keys.pop(slot, []))

    def park(self, slot: int, token) -> "object | None":
        """Move a slot's pins to a parked handle without ever dropping
        them, so a suspended request's pages stay resident while it waits
        to resume.  Returns the handle, or None when the slot held no pins.
        The slot itself is left unpinned and free to re-admit."""
        keys = self._slot_keys.pop(slot, None)
        if not keys:
            return None
        if token in self._parked:
            raise ValueError(f"park handle {token!r} in use")
        self._parked[token] = keys
        return token

    def unpark(self, token) -> None:
        """Drop a parked handle's references (the resumed admission has
        re-pinned through its own slot, or the suspension was discarded).
        Unknown handles are a no-op, as in `release`."""
        self._drop_refs(self._parked.pop(token, []))

    # ----------------------------------------------------------- internal --

    def _drop_refs(self, keys: list[bytes]) -> None:
        for key in keys:
            e = self._index.get(key)
            if e is not None:
                e.refs -= 1
                if e.refs < 0:
                    raise RuntimeError("prefix page refcount underflow")
        self._enforce_budgets()

    def _register_shape(self, leaf: torch.Tensor) -> None:
        if self._page_shape is None:
            self._page_shape = tuple(leaf.shape)
            self._dtype = leaf.dtype
            self._device = leaf.device

    def _touch(self, e: _Entry) -> None:
        self._tick += 1
        e.stamp = self._tick

    def _codebook(self, lo: float, hi: float) -> torch.Tensor:
        return torch.from_numpy(linspace_f32(1 << self.bits, lo, hi)).to(
            self._device)

    def _compress(self, page: torch.Tensor) -> tuple[bytes, float, float]:
        """Page -> (bit-packed codebook indices, codebook range).  The
        codebook is a uniform grid over the page's own value range; the
        indices are the quantize kernel's on a CUDA page."""
        x = page.float().contiguous()
        lo, hi = (float(v) for v in torch.aminmax(x))
        if not hi > lo:
            hi = lo + 1.0
        idx = hard_indices({"centers": self._codebook(lo, hi)}, x)
        return pack_indices(idx.cpu().numpy(), self.bits), lo, hi

    def _decompress(self, blob: tuple[bytes, float, float]) -> torch.Tensor:
        payload, lo, hi = blob
        count = int(np.prod(self._page_shape))
        idx = torch.from_numpy(unpack_indices(payload, self.bits, count).astype(
            np.int64)).to(self._device)
        x = self._codebook(lo, hi)[idx].reshape(self._page_shape)
        return x.to(self._dtype)

    def _cold_nbytes(self, e: _Entry) -> int:
        return len(e.cold["k"][0]) + len(e.cold["v"][0])

    def _demote(self, e: _Entry) -> None:
        """Hot -> cold (or gone, with no cold budget).  A page that already
        has a cold blob just drops its device copy: re-demotion never
        re-quantizes, so a page degrades at most once."""
        if self.cold_bytes > 0:
            if e.cold is None:
                e.cold = {"k": self._compress(e.hot["k"]),
                          "v": self._compress(e.hot["v"])}
                self._cold_used += self._cold_nbytes(e)
            e.hot = None
            self.stats["demotions"] += 1
        else:
            e.hot = None
            del self._index[e.key]
            self.stats["hot_drops"] += 1

    def _enforce_budgets(self) -> None:
        """LRU-demote unpinned hot pages past hot_pages, then LRU-drop cold
        blobs past cold_bytes.  Pinned pages never move; a pinned working
        set larger than hot_pages overflows the budget rather than break
        the fetch contract."""
        n_hot = self.n_hot
        if n_hot > self.hot_pages:
            victims = sorted((e for e in self._index.values()
                              if e.hot is not None and e.refs == 0),
                             key=lambda e: e.stamp)
            for e in victims[:n_hot - self.hot_pages]:
                self._demote(e)
        if self._cold_used > self.cold_bytes:
            victims = sorted((e for e in self._index.values()
                              if e.cold is not None),
                             key=lambda e: e.stamp)
            for e in victims:
                if self._cold_used <= self.cold_bytes:
                    break
                self._cold_used -= self._cold_nbytes(e)
                e.cold = None
                self.stats["cold_drops"] += 1
                if e.hot is None:
                    del self._index[e.key]
