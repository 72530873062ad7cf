"""Host-side data pipeline: batching and background prefetch, as
``repro.data.pipeline``.

``HostDataLoader`` keeps the JAX package's interface with ``device=`` in
place of ``sharding=``: one host feeds one card, and each numpy array of
a batch is moved to that device as it is taken.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch import tree_map


class HostDataLoader:
    """Wraps a ``batch_fn(step) -> dict of np arrays`` with background
    prefetch and optional placement on ``device``."""

    def __init__(self, batch_fn: Callable[[int], dict], *,
                 prefetch: int = 2, device=None, start_step: int = 0):
        self.batch_fn = batch_fn
        self.device = device
        self._q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            try:
                batch = self.batch_fn(step)
            except Exception as e:  # propagate to consumer
                self._q.put(e)
                return
            self._q.put(batch)
            step += 1

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        if self.device is not None:
            item = tree_map(lambda x: torch.as_tensor(x, device=self.device), item)
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


def host_slice(global_batch: dict, *, host_id: int = 0,
               n_hosts: int = 1) -> dict:
    """Slice a host's portion of the global batch (process-sharded input
    pipelines)."""
    def sl(x):
        per = x.shape[0] // n_hosts
        return x[host_id * per:(host_id + 1) * per]
    return tree_map(sl, global_batch)


def token_batch_fn(data, batch_size: int, *, seed_base: int = 0):
    """Adapter for SyntheticTokens: step -> {tokens, labels}."""
    def fn(step: int) -> dict:
        toks = data.batch(batch_size, seed=seed_base + step)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}
    return fn


def image_batch_fn(data, batch_size: int, *, seed_base: int = 0):
    """Adapter for SyntheticImages: step -> {images, labels}."""
    def fn(step: int) -> dict:
        images, labels = data.batch(batch_size, seed=seed_base + step)
        return {"images": images, "labels": labels}
    return fn
