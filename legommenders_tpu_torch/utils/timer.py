"""Section timers for profiling and latency benchmarking.

The port's copy of the JAX package's utils/timer.py (reference
utils/timer.py:43-180), which also keeps every section's durations
(`samples`) for medians. Callers that time device work synchronize the
device (torch.cuda.synchronize) before `stop()`.
"""
import time
from collections import defaultdict


class Timer:
    def __init__(self, activate: bool = False):
        self.activated = activate
        self._starts = {}
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.samples = defaultdict(list)

    def activate(self):
        self.activated = True

    def deactivate(self):
        self.activated = False

    def __call__(self, name: str):
        return _Section(self, name)

    def start(self, name: str):
        if self.activated:
            self._starts[name] = time.perf_counter()

    def stop(self, name: str):
        if self.activated and name in self._starts:
            dt = time.perf_counter() - self._starts.pop(name)
            self.totals[name] += dt
            self.counts[name] += 1
            self.samples[name].append(dt)

    def avg_ms(self, name: str) -> float:
        if not self.counts[name]:
            return 0.0
        return self.totals[name] / self.counts[name] * 1e3

    def clear(self):
        self._starts.clear()
        self.totals.clear()
        self.counts.clear()
        self.samples.clear()


class _Section:
    def __init__(self, timer: Timer, name: str):
        self.timer, self.name = timer, name

    def __enter__(self):
        self.timer.start(self.name)
        return self

    def __exit__(self, *exc):
        self.timer.stop(self.name)
        return False
