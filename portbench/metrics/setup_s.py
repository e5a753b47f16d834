"""setup_s: seconds from the process's start to the measured window (or the
profiled units): imports, the fixture, the model and its catalog plans,
the weights, the kernels' build or load, the checked steps, the warm-up."""


def read(run):
    return run.setup_s
