"""Failure detection and elastic recovery for training loops and solves.

Counterpart of ``feature_detector_tpu/utils/recovery.py``.  ``ResilientLoop``
runs ``step_fn(state, step) -> state`` for a number of steps, saving the
state every ``save_every`` steps (``utils/checkpoint.CheckpointManager``).
A step window that raises (a runtime or device error) or ends in an
unhealthy state (``health_fn``, by default every float leaf finite) is
rolled back to the last checkpoint and replayed, after an optional backoff;
``max_retries`` consecutive failures surface the last error.  A new loop
over the same directory resumes from the newest checkpoint.  ``step_fn``
must be a pure function of (state, step) for the replay to be exact.

    loop = ResilientLoop(ckpt_dir, save_every=50)
    final_state = loop.run(init_state, step_fn, n_steps)
"""

from __future__ import annotations

import time
from typing import Any, Callable

import torch

from ..core.device import DeviceLike, resolve_device
from .checkpoint import CheckpointManager
from .checks import count_nonfinite, tree_leaves_with_path
from .log import report_info, report_warn


def default_health(state: Any) -> bool:
    """True iff every float leaf of ``state`` is finite."""
    return not any(count_nonfinite(leaf)[0] for _, leaf in tree_leaves_with_path(state))


def devices_alive(device: DeviceLike = None) -> bool:
    """A liveness probe: one tiny operation on ``device`` (the card by
    default), synchronised and read back.  False when it raises, or when no
    card is present."""
    try:
        dev = resolve_device(device)
        x = torch.zeros((), device=dev) + 1
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return int(x.item()) == 1
    except RuntimeError:
        return False


def _synchronize(state: Any) -> None:
    """Waits for the card when any leaf of ``state`` lies there, so that a
    device error surfaces inside the step window."""
    for _, leaf in tree_leaves_with_path(state):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
            return


class ResilientLoop:
    def __init__(
        self,
        checkpoint_dir: str,
        *,
        save_every: int = 100,
        max_to_keep: int = 3,
        max_retries: int = 3,
        health_fn: Callable[[Any], bool] = default_health,
        backoff_s: float = 0.0,
    ):
        self.manager = CheckpointManager(checkpoint_dir, max_to_keep=max_to_keep)
        self.save_every = save_every
        self.max_retries = max_retries
        self.health_fn = health_fn
        self.backoff_s = backoff_s
        self.rollbacks = 0

    def run(self, init_state: Any, step_fn: Callable[[Any, int], Any], n_steps: int) -> Any:
        """Runs ``step_fn`` up to step ``n_steps``, resuming from the newest
        checkpoint when one exists; returns the final state."""
        latest = self.manager.latest_step()
        if latest is not None:
            state = self.manager.restore(init_state, step=latest)
            step = latest
            report_info("recovery: resuming from checkpointed step %d", latest)
        else:
            state = init_state
            self.manager.save(0, state)
            step = 0

        retries = 0
        while step < n_steps:
            window_end = min(step + self.save_every, n_steps)
            try:
                new_state = state
                for s in range(step, window_end):
                    new_state = step_fn(new_state, s)
                _synchronize(new_state)
                if not self.health_fn(new_state):
                    raise FloatingPointError(f"health check failed after step window {step}..{window_end}")
            except Exception as e:  # a crash or a failed health check: roll back
                retries += 1
                self.rollbacks += 1
                report_warn("recovery: step window %d..%d failed (%s: %s); rollback #%d",
                            step, window_end, type(e).__name__, e, retries)
                if retries > self.max_retries:
                    raise
                good = self.manager.latest_step()
                state = self.manager.restore(state, step=good)
                step = int(good)
                if self.backoff_s:
                    time.sleep(self.backoff_s * retries)
                continue
            retries = 0
            state = new_state
            step = window_end
            self.manager.save(step, state)
        self.manager.close()
        return state
