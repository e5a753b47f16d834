"""mfu: the model's operations in one unit (counted from the cell's shapes)
over the seconds of the median unprofiled unit and the card's bf16 peak, in %
(portbench/readers.py `mfu`)."""
from portbench.readers import mfu


def read(run):
    return mfu(run)
