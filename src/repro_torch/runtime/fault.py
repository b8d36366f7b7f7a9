"""Straggler detection for the serving loop (the ``StragglerMonitor`` of
``repro/runtime/fault.py``, copied: it is plain host code)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class StragglerMonitor:
    """EWMA of step (or request) durations; flags those slower than
    ``threshold`` x the running mean, and advises escalation after
    ``trip_limit`` consecutive flags."""

    alpha: float = 0.1           # EWMA coefficient
    threshold: float = 2.0       # flag steps slower than 2x the mean
    trip_limit: int = 3          # consecutive flags before escalation
    mean_s: float = 0.0
    trips: int = 0
    flagged_steps: List[int] = field(default_factory=list)

    def observe(self, step: int, duration_s: float) -> bool:
        """Returns True when escalation (reshard / evict) is advised."""
        if self.mean_s == 0.0:
            self.mean_s = duration_s
            return False
        slow = duration_s > self.threshold * self.mean_s
        if slow:
            self.trips += 1
            self.flagged_steps.append(step)
        else:
            self.trips = 0
            # slow steps don't poison the baseline
            self.mean_s = (1 - self.alpha) * self.mean_s + self.alpha * duration_s
        return self.trips >= self.trip_limit
