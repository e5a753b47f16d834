"""plans_backward_ms.train: device ms a profiled step launched inside the
program's `lego.plans.backward` spans (the catalog gradient plans' segment
sums, ops/catalog_grad.py; portbench/spans.py)."""
from portbench.spans import ms_per_unit


def read(run):
    return ms_per_unit(run, "lego.plans.backward")
