"""Convergence test (paper Algorithm 1 line 13): Converged(M_r, M_{r+1}, eps).

The round step already returns ||Delta|| as `delta_norm`; the orchestrator
calls `converged()` host-side with a window of recent norms (a single-round
norm is noisy under partial participation)."""
from __future__ import annotations

from collections import deque


class ConvergenceMonitor:
    def __init__(self, eps: float, window: int = 3, min_rounds: int = 5):
        self.eps = eps
        self.window = window
        self.min_rounds = min_rounds
        self.norms: deque = deque(maxlen=window)
        self.rounds = 0

    def update(self, delta_norm: float) -> bool:
        self.rounds += 1
        self.norms.append(float(delta_norm))
        if self.rounds < self.min_rounds or len(self.norms) < self.window:
            return False
        return max(self.norms) < self.eps
