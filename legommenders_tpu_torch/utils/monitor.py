"""Early stopping monitor.

The port's copy of the JAX package's utils/monitor.py (reference
utils/monitor.py:21-76): emits best/skip/stop signals with patience
measured in epochs since the best dev metric.
"""
import enum


class Signal(enum.Enum):
    BEST = "best"
    SKIP = "skip"
    STOP = "stop"


class Monitor:
    def __init__(self, patience: int = 5, minimize: bool = False):
        self.patience = patience
        self.minimize = minimize
        self.best_value = None
        self.best_index = -1
        self._n = 0

    def push(self, value: float) -> Signal:
        index = self._n
        self._n += 1
        improved = (
            self.best_value is None
            or (value < self.best_value if self.minimize else value > self.best_value)
        )
        if improved:
            self.best_value = value
            self.best_index = index
            return Signal.BEST
        if index - self.best_index >= self.patience:
            return Signal.STOP
        return Signal.SKIP
