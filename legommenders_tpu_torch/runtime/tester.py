"""Tester — test-split evaluation + latency benchmark.

The port of the JAX package's runtime/tester.py (reference
tester.py:46-141): `test()` computes the metric suite on the test split;
`latency(num_batches)` times each forward of the host-batched path, each
up to the device's end of it (torch.cuda.synchronize before the timer
stops, the counterpart of JAX's block_until_ready), so the time is the
device's.
"""
from typing import Dict

from legommenders_tpu_torch.runtime.manager import Manager
from legommenders_tpu_torch.utils.logging import get_logger
from legommenders_tpu_torch.utils.timer import Timer


class Tester:
    def __init__(self, manager: Manager, log=None):
        self.m = manager
        self.log = log or get_logger("tester")
        self.evaluator = manager.evaluator()

    def test(self) -> Dict[str, float]:
        res = self.evaluator.evaluate("test")
        self.log.info("test: " + ", ".join(
            f"{k} {v:.4f}" for k, v in res.items()))
        return res

    def latency(self, num_batches: int = 100,
                use_cache: bool = True) -> float:
        """Mean ms of one forward of an eval batch over `num_batches`
        batches of the test phase, through the caches when `use_cache` and
        the model has them, else the full forward."""
        timer = Timer(activate=True)
        self.evaluator.evaluate(
            "test", latency_timer=timer,
            use_cache=use_cache and self.evaluator.cache is not None,
            max_batches=num_batches)
        avg_ms = timer.avg_ms("forward")
        self.log.info(f"avg forward latency: {avg_ms:.3f} ms "
                      f"({num_batches} batches)")
        return avg_ms
