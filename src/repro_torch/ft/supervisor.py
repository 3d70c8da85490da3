"""Fault-tolerant training supervisor: checkpoint/restart with injected
failures.

Port of ``repro.ft.supervisor``.  The supervisor owns the step loop.  A
``FailureInjector`` raises ``SimulatedFailure`` at given steps (modelling
preemptions and node loss); the supervisor catches it, restores the
latest complete checkpoint, and resumes.  Because checkpoints are atomic
and the data pipeline is a pure function of the step counter
(``data/synthetic.py``), a restart lands on a consistent state and the
trajectory is exactly the one an uninterrupted run takes.

Across ranks each rank runs its own supervisor with the same injector
steps, so a failure strikes every rank at the same step; checkpoints are
written by rank 0 behind a barrier (``checkpoint.manager.save``), so all
ranks roll back to the same latest step, and the run equals the
uninterrupted one bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["SimulatedFailure", "FailureInjector", "Supervisor",
           "SupervisorReport"]


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    """Fail deterministically at the given steps (first occurrence each)."""
    fail_at_steps: tuple[int, ...] = ()

    def __post_init__(self):
        self._armed = set(self.fail_at_steps)

    def maybe_fail(self, step: int):
        if step in self._armed:
            self._armed.discard(step)
            raise SimulatedFailure(f"injected failure at step {step}")


@dataclasses.dataclass
class SupervisorReport:
    steps_run: int
    restarts: int
    final_step: int
    losses: list


@dataclasses.dataclass
class Supervisor:
    """Drives step_fn through failures.

    step_fn(state, batch) -> (state, metrics);  batch_fn(step) -> batch.
    """
    ckpt: CheckpointManager
    step_fn: Callable
    batch_fn: Callable
    checkpoint_every: int = 10

    def run(self, state, *, total_steps: int,
            injector: Optional[FailureInjector] = None,
            start_step: int = 0) -> tuple[object, SupervisorReport]:
        step = start_step
        restarts = 0
        steps_run = 0
        losses = []
        self.ckpt.save(step, state, blocking=True)
        while step < total_steps:
            try:
                if injector is not None:
                    injector.maybe_fail(step)
                batch = self.batch_fn(step)
                state, metrics = self.step_fn(state, batch)
                losses.append(float(metrics["loss"]))
                step += 1
                steps_run += 1
                if step % self.checkpoint_every == 0 or step == total_steps:
                    self.ckpt.save(step, state, blocking=True)
            except SimulatedFailure:
                restarts += 1
                got, restored = self.ckpt.restore_latest(state)
                if got is None:
                    raise RuntimeError("no checkpoint to restart from")
                state, step = restored, got
                # drop optimistic losses past the restore point
                losses = losses[:step - start_step]
        return state, SupervisorReport(steps_run=steps_run,
                                       restarts=restarts,
                                       final_step=step, losses=losses)
