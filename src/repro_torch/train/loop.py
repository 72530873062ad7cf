"""Generic training loop: step function + data loader + metrics +
periodic checkpointing, as ``repro.train.loop``."""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint.io import save_checkpoint


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int = 0


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    log_every: int = 20
    ckpt_every: int = 0
    ckpt_path: str = ""


def _is_scalar(v) -> bool:
    return v.dim() == 0 if isinstance(v, torch.Tensor) else np.ndim(v) == 0


def run_training(state: TrainState, step_fn: Callable, data_iter, *,
                 loop: LoopConfig, on_log: Optional[Callable] = None) -> TrainState:
    """step_fn(params, opt_state, batch) -> (params, opt_state, metrics).

    Returns the final TrainState; metrics history attached as .history.
    """
    history = []
    t0 = time.time()
    for i in range(state.step, loop.total_steps):
        batch = next(data_iter)
        state.params, state.opt_state, metrics = step_fn(
            state.params, state.opt_state, batch)
        state.step = i + 1
        if loop.log_every and (i % loop.log_every == 0
                               or i == loop.total_steps - 1):
            row = {k: float(v) for k, v in metrics.items() if _is_scalar(v)}
            row.update(step=i, wall_s=round(time.time() - t0, 1))
            history.append(row)
            if on_log:
                on_log(row)
        if loop.ckpt_every and loop.ckpt_path and \
                (i + 1) % loop.ckpt_every == 0:
            save_checkpoint(loop.ckpt_path, state.params)
    state.history = history  # type: ignore[attr-defined]
    return state
