"""pool_roofline: the additive pool's least time (portbench/work.py
`pool_bound_s` of every pool call of the profiled units, the calls counted
by the kind from the cell's shapes) over the device time of the kernels
launched inside the pool wrapper's ranges, in %."""
from portbench.readers import pool_roofline


def read(run):
    return pool_roofline(run)
