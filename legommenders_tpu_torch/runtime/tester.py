"""Tester — test-split evaluation (the port of the JAX package's
runtime/tester.py `Tester.test`; reference tester.py:46-141)."""
import logging
from typing import Dict

from legommenders_tpu_torch.runtime.manager import Manager


class Tester:
    def __init__(self, manager: Manager, log=None):
        self.m = manager
        self.log = log or logging.getLogger("legommenders_tpu_torch.tester")
        self.evaluator = manager.evaluator()

    def test(self) -> Dict[str, float]:
        res = self.evaluator.evaluate("test")
        self.log.info("test: " + ", ".join(
            f"{k} {v:.4f}" for k, v in res.items()))
        return res
