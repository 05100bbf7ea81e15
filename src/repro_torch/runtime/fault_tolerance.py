"""Straggler detection for the training loop (the port's copy of
``StragglerDetector`` from the JAX package's ``runtime/fault_tolerance.py``;
the heartbeat registry, elastic plan and restart loop come later)."""
from __future__ import annotations

from typing import List


class StragglerDetector:
    """Median/MAD z-score over a sliding window of step times."""

    def __init__(self, window: int = 50, z_thresh: float = 4.0,
                 min_samples: int = 10):
        self.window = window
        self.z = z_thresh
        self.min_samples = min_samples
        self.times: List[float] = []
        self.flags = 0

    def record(self, dt: float) -> bool:
        """Returns True if this step is a straggler event."""
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        if len(self.times) < self.min_samples:
            return False
        med = sorted(self.times)[len(self.times) // 2]
        mad = sorted(abs(t - med) for t in self.times)[len(self.times) // 2]
        sigma = 1.4826 * max(mad, 1e-9)
        if (dt - med) / sigma > self.z:
            self.flags += 1
            return True
        return False

    def chronic(self, k: int = 3) -> bool:
        return self.flags >= k
