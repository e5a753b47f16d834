"""Running mean (the port's copy of the JAX package's utils/meaner.py;
reference utils/meaner.py)."""


class Meaner:
    def __init__(self):
        self.total = 0.0
        self.count = 0

    def add(self, value: float) -> float:
        self.total += float(value)
        self.count += 1
        return self.mean

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def reset(self):
        self.total, self.count = 0.0, 0
