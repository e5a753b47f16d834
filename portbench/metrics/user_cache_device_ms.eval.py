"""user_cache_device_ms.eval: device ms a profiled pass launched inside
the program's `lego.cache.users` span (every user page of the repr cache,
runtime/cacher.py; portbench/spans.py)."""
from portbench.spans import ms_per_unit


def read(run):
    return ms_per_unit(run, "lego.cache.users")
