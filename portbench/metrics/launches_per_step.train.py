"""launches_per_step.train: kernel records of the profiled steps (copies
and fills not counted) over the steps."""


def read(run):
    if run.trace is None or not run.traced_units:
        return None
    return len(run.trace.kernels()) / run.traced_units
