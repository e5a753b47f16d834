"""What several metric readers share."""
from portbench import work


def wrapper_roofline(run, wrapper: str, bounds_s):
    """A kernel's share of its roofline in %: the least time of the
    launches of one unit (`bounds_s`, one a launch, counted from the
    cell's shapes) times the profiled units, over the device time of the
    kernels launched inside `wrapper`'s ranges. The wrapper's own counter
    must show the launches counted; where the tracer lost some device
    records (it does, in bursts), the missing ones are taken at the mean of
    the recorded."""
    if run.trace is None or not bounds_s:
        return None
    want = len(bounds_s) * run.traced_units
    counted = run.counts.get(wrapper, 0)
    seen = run.trace.wrapper_launches(wrapper)
    if counted != want or not seen:
        run.log(f"[trace] {wrapper}: {counted} launches counted, {want} "
                f"expected from the shapes, {seen} in the trace")
        return None
    busy = run.trace.wrapper_s(wrapper) * counted / seen
    return 100.0 * sum(bounds_s) * run.traced_units / busy


def pool_roofline(run):
    ref = run.cfg["reference"]
    return wrapper_roofline(
        run, "additive_pool",
        [work.pool_bound_s(N, L, ref["hidden"], ref["pool_hidden"])
         for N, L in run.kind.pool_calls(run.cfg, run.traffic)])


def mfu(run):
    """The model's operations in one unit (the kind's `model_flops`,
    counted from the cell's shapes) over the median seconds of the traced
    run's unprofiled units and the card's bf16 peak, in %."""
    if not run.unit_s:
        return None
    return 100.0 * run.kind.model_flops(run.cfg, run.traffic) \
        / run.unit_s / work.PEAK_BF16


def idle_share(run):
    """The share of an unprofiled unit in which no operation ran on the
    device, in %: one minus the device's busy seconds a profiled unit (the
    union of the trace's device records) over the median seconds of the
    traced run's unprofiled units. The profiler's own host cost stretches
    the profiled units, not the device's work in them."""
    if run.trace is None or not run.unit_s or not run.traced_units:
        return None
    busy = run.trace.busy_s / run.traced_units
    return 100.0 * (1.0 - busy / run.unit_s)
