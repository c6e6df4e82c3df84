"""Fault tolerance: preemption handling, straggler detection, step timing.

The port's counterpart of ``repro/ft/resilience.py``: planned preemptions
(SIGTERM → checkpoint now and exit cleanly), stragglers (a step, or a host,
slower than ``factor`` x the median) and the step timer the train loop
laps.  ``reshard_tree`` (elastic re-mesh) waits for the sharded train step
(ROADMAP.md queue 1, item 6c).
"""
from __future__ import annotations

import signal
import statistics
import time
from typing import List, Optional


class PreemptionGuard:
    """SIGTERM/SIGINT → set a flag the training loop polls each step."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._requested = False
        self._old = {}
        for s in signals:
            self._old[s] = signal.signal(s, self._handler)

    def _handler(self, signum, frame):  # noqa: ARG002
        self._requested = True

    @property
    def preempted(self) -> bool:
        return self._requested

    def request(self) -> None:  # for tests / manual drain
        self._requested = True

    def restore(self) -> None:
        for s, h in self._old.items():
            signal.signal(s, h)


class StragglerDetector:
    """Flags steps (or hosts) whose time exceeds ``factor × median``.

    Keeps a sliding window of recent step times; `observe` returns True when
    the new sample is a straggler.  `observe_many` applies the same rule
    across per-host samples of one step (multi-host mode) and returns the
    list of straggler ranks — the caller can then exclude, re-queue, or
    re-mesh around them.
    """

    def __init__(self, window: int = 50, factor: float = 2.0, min_samples: int = 8):
        self.window = window
        self.factor = factor
        self.min_samples = min_samples
        self._times: List[float] = []

    def observe(self, dt: float) -> bool:
        flagged = False
        if len(self._times) >= self.min_samples:
            med = statistics.median(self._times)
            flagged = dt > self.factor * med
        self._times.append(dt)
        if len(self._times) > self.window:
            self._times.pop(0)
        return flagged

    def observe_many(self, per_host_dt: List[float]) -> List[int]:
        med = statistics.median(per_host_dt)
        return [i for i, t in enumerate(per_host_dt) if t > self.factor * med]

    @property
    def median(self) -> Optional[float]:
        return statistics.median(self._times) if self._times else None


class StepTimer:
    def __init__(self):
        self.t0 = time.perf_counter()

    def lap(self) -> float:
        t = time.perf_counter()
        dt = t - self.t0
        self.t0 = t
        return dt
