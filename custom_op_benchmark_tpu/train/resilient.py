"""Failure detection + elastic resume (SURVEY.md §5 aux subsystem).

The reference has no checkpointing or failure story at all; JAX's
multi-host semantics are fail-fast (a dead host kills the program), so
the recovery model is: detect, checkpoint, restart, resume — not
in-place healing. This module provides the three pieces:

- :class:`CheckpointManager` — rolling step-numbered ``.npz``
  checkpoints with atomic latest-discovery (restart-safe: a killed save
  never becomes "latest").
- :func:`resilient_steps` — a training-step driver that detects
  divergence (non-finite loss) and stalls (step wall-clock watchdog),
  restores the last good checkpoint on divergence, and re-raises after
  ``max_restores`` so an external supervisor can reschedule.
- resume-on-restart: construct the manager over an existing directory
  and ``restore_latest`` picks up exactly where the dead run left off.
"""

from __future__ import annotations

import os
import re
import time
from typing import Any, Callable, Optional

import jax
import numpy as np

from custom_op_benchmark_tpu.train.checkpoint import (
    checkpoint_complete,
    restore_checkpoint,
    save_checkpoint,
)


class CheckpointManager:
    """Rolling ``step_N`` checkpoints under one directory.

    Saves are written to ``step_N`` and only count as latest once its
    file is complete (written under a temporary name, then renamed);
    ``keep`` bounds disk usage.
    """

    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def _steps(self):
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and checkpoint_complete(
                    os.path.join(self.directory, name)):
                out.append(int(m.group(1)))
        return sorted(out)

    @property
    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def save(self, state: Any, step: int) -> str:
        path = os.path.join(self.directory, f"step_{step}")
        save_checkpoint(path, state)
        for old in self._steps()[: -self.keep]:
            import shutil

            shutil.rmtree(
                os.path.join(self.directory, f"step_{old}"),
                ignore_errors=True,
            )
        return path

    def restore_latest(self, state: Any) -> tuple:
        """(state, step) from the newest checkpoint, or (state, None)."""
        step = self.latest_step
        if step is None:
            return state, None
        path = os.path.join(self.directory, f"step_{step}")
        return restore_checkpoint(path, state), step


class DivergenceError(RuntimeError):
    """Loss went non-finite more than ``max_restores`` times."""


def resilient_steps(step_fn: Callable, state: Any, num_steps: int, *,
                    manager: Optional[CheckpointManager] = None,
                    checkpoint_every: int = 50,
                    max_restores: int = 3,
                    stall_timeout_s: Optional[float] = None,
                    on_event: Optional[Callable[[str, int], None]] = None):
    """Run ``state, loss = step_fn(state, i)`` for ``num_steps``, with:

    - resume: if ``manager`` holds a checkpoint, start after its step;
    - divergence detection: non-finite loss restores the last good
      checkpoint (or the initial state) and re-runs; after
      ``max_restores`` raises :class:`DivergenceError`;
    - stall detection: a step exceeding ``stall_timeout_s`` (measured
      after device sync) reports a ``"stall"`` event — the fail-fast
      analog of a hardware watchdog;
    - periodic checkpoints every ``checkpoint_every`` steps.

    Returns (state, losses). ``on_event(kind, step)`` receives
    ``"restore" | "checkpoint" | "stall" | "resume"``.
    """
    notify = on_event or (lambda kind, step: None)
    start = 0
    if manager is not None:
        state, ckpt_step = manager.restore_latest(state)
        if ckpt_step is not None:
            start = ckpt_step + 1
            notify("resume", ckpt_step)
    initial_state = state
    restores = 0
    # Keyed by step so a divergence restore REWINDS the history too —
    # appending unconditionally would double-count replayed steps and
    # interleave pre-/post-restore values.
    loss_by_step = {}
    i = start
    while i < num_steps:
        t0 = time.monotonic()
        new_state, loss = step_fn(state, i)
        loss = jax.block_until_ready(loss)
        dt = time.monotonic() - t0
        if stall_timeout_s is not None and dt > stall_timeout_s:
            notify("stall", i)
        if not bool(np.isfinite(np.asarray(loss))):
            restores += 1
            if restores > max_restores:
                raise DivergenceError(
                    f"non-finite loss at step {i} after "
                    f"{max_restores} restores"
                )
            if manager is not None and manager.latest_step is not None:
                state, ckpt_step = manager.restore_latest(initial_state)
                i = ckpt_step + 1
            else:
                state, i = initial_state, start
            loss_by_step = {s: v for s, v in loss_by_step.items() if s < i}
            notify("restore", i)
            continue
        state = new_state
        loss_by_step[i] = float(loss)
        if manager is not None and (i + 1) % checkpoint_every == 0:
            manager.save(state, i)
            notify("checkpoint", i)
        i += 1
    if manager is not None and num_steps > start:
        manager.save(state, num_steps - 1)
        notify("checkpoint", num_steps - 1)
    return state, [loss_by_step[s] for s in sorted(loss_by_step)]
