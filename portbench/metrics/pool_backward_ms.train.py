"""pool_backward_ms.train: device ms a profiled step launched inside the
program's `lego.pool.backward` spans (the additive pool's plain backward,
ops/additive.py; portbench/spans.py)."""
from portbench.spans import ms_per_unit


def read(run):
    return ms_per_unit(run, "lego.pool.backward")
