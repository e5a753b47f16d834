"""launches_per_item_page.eval: kernel launch calls inside the program's
`lego.cache.item_page` spans (runtime/cacher.py) over those spans: a
count, which the profiler's host cost does not stretch (portbench/
spans.py)."""
from portbench.spans import launches_per_span


def read(run):
    return launches_per_span(run, "lego.cache.item_page")
