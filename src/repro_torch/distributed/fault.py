"""Failure injection and the restart supervisor (the port's copy of
``repro/distributed/fault.py``, pure Python).

A restarted run resumes bit for bit from its last checkpoint
(``launch/train.py``); this module provides the harness that shows it: a
``FailureInjector`` that raises at chosen steps and ``run_with_restarts``,
which calls the run again, resuming, after each such failure.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List


class SimulatedFailure(RuntimeError):
    """Stands in for a node loss or a preemption."""


@dataclasses.dataclass
class FailureInjector:
    """Raises ``SimulatedFailure`` when the step hits one of ``fail_at``
    (each trigger fires once: a restarted run passes the same step)."""
    fail_at: List[int]

    def __post_init__(self):
        self._pending = sorted(set(self.fail_at))

    def check(self, step: int) -> None:
        if self._pending and step == self._pending[0]:
            self._pending.pop(0)
            raise SimulatedFailure(f"injected failure at step {step}")


def run_with_restarts(run_fn: Callable[[bool], int], *,
                      max_restarts: int = 10) -> int:
    """Call ``run_fn(resume)`` until it returns; ``resume`` is True after
    the first ``SimulatedFailure``.  Returns its final step; raises the
    failure after ``max_restarts`` restarts."""
    restarts = 0
    while True:
        try:
            return run_fn(restarts > 0)
        except SimulatedFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
