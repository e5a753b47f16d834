"""cache_ms.eval: host ms of ReprCache.cache() (every item page, then every
user page), ended by a synchronise (the span passes, unprofiled)."""
from portbench.harness import median


def read(run):
    ms = run.spans.get("cache")
    return median(ms) if ms else None
