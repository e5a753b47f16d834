"""idle_share: the share of a unit in which no operation ran on the device,
in %: one minus the device's busy seconds a profiled unit over the seconds
of the median unprofiled unit (portbench/readers.py `idle_share`)."""
from portbench.readers import idle_share


def read(run):
    return idle_share(run)
