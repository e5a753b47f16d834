"""train_step_ms_p95: the 95th percentile (nearest rank) of the window's
step times, each from CUDA events recorded at the step boundaries."""
from portbench.harness import p95


def read(run):
    return p95(run.unit_ms) if run.unit_ms else None
