"""metric_ms.eval: host ms of Evaluator.metrics over a test phase's scores,
ended by a synchronise (the median of the span passes, unprofiled)."""
from portbench.harness import median


def read(run):
    ms = run.spans.get("metrics")
    return median(ms) if ms else None
