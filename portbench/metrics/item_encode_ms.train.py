"""item_encode_ms.train: device ms a profiled step launched inside the
program's `lego.item_encode` spans (the whole catalog's encode in
models/legommender.py) and their `lego.item_encode.backward` (portbench/
spans.py)."""
from portbench.spans import ms_per_unit


def read(run):
    return ms_per_unit(run, "lego.item_encode", "lego.item_encode.backward")
