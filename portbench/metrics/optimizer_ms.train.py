"""optimizer_ms.train: device ms a profiled step launched inside the
program's `lego.optimizer` span (Adam's update, runtime/steps.py;
portbench/spans.py)."""
from portbench.spans import ms_per_unit


def read(run):
    return ms_per_unit(run, "lego.optimizer")
