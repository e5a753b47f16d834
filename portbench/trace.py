"""One torch.profiler window over a few steady units of work, reduced in one
walk of the trace's events to what the per-layer readers take:

  * each device record (kernels, copies, fills) with its interval and
    correlation id, and the union of their intervals (the device's busy
    time);
  * the host ranges the program's kernel wrappers open around a launch
    (`ops/build.launch_range`: "additive_pool", "packed_attention", ...)
    and the benchmark's own spans ("portbench.*"), and which launch calls
    lie inside each wrapper's ranges, so that a kernel's device time is
    found by the range that launched it, whatever its name;
  * the idle gaps between device records, each named by what the host was
    doing in its middle (the innermost host event then).
The walk follows `chip_smoke.trace_records`: a range's device-side
annotation, which the tracer lists as a device record under the range's
name, is no kernel and is left out.
"""
import bisect

# the program's wrapper ranges (ops/build.launch_range names)
WRAPPERS = ("additive_pool", "packed_attention", "packed_attention_backward",
            "dropout_keep_mask")
SPAN_PREFIX = "portbench."
WINDOW = "portbench.window"
# the CUDA API calls that enqueue a kernel
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel",
                "cudaLaunchCooperativeKernel")
# cuBLAS's matrix-product kernels on the H100 (cuBLASLt's nvjet, the xmma
# and CUTLASS kernels); a split-K reduction is not one
GEMM_MARKERS = ("gemm", "nvjet", "xmma", "cutlass")
TOP = 10


def is_gemm(name: str) -> bool:
    low = name.lower()
    return any(m in low for m in GEMM_MARKERS) and "reduce" not in low


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def profile(fn):
    """The Trace of fn() run under the profiler, the device synchronised
    before and after, inside a WINDOW range."""
    import torch
    from torch.profiler import ProfilerActivity, profile as prof_ctx

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with prof_ctx(activities=[ProfilerActivity.CPU]
                  + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
        with torch.profiler.record_function(WINDOW):
            fn()
            sync()
    return Trace(prof.profiler.kineto_results.events())


class Trace:
    def __init__(self, events):
        from torch.autograd import DeviceType

        names = set(WRAPPERS)
        self.device = []        # (start_ns, end_ns, name, correlation)
        host, calls, ranges, spans = [], {}, [], []
        self.window = None
        for e in events:
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                if name in names or name.startswith(SPAN_PREFIX):
                    continue
                self.device.append((e.start_ns(), e.end_ns(), name,
                                    e.correlation_id()))
                continue
            if name == WINDOW:
                self.window = (e.start_ns(), e.end_ns())
            if name in names:
                ranges.append((e.start_ns(), e.end_ns(), name))
            if name.startswith(LAUNCH_CALLS) and e.correlation_id():
                calls[e.correlation_id()] = (e.start_ns(), e.end_ns())
            elif name.startswith(SPAN_PREFIX):
                if name != WINDOW:
                    spans.append((e.start_ns(), e.end_ns(), name))
            else:
                host.append((e.start_ns(), e.end_ns(), name))
        self.device.sort()
        lo, hi = self.window or (self.device[0][0] if self.device else 0,
                                 self.device[-1][1] if self.device else 0)
        self.window_s = (hi - lo) / 1e9
        # the busy union, clipped to the window
        busy, merged = 0, []
        for s, e, _, _ in self.device:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy_s = sum(e - s for s, e in merged) / 1e9
        self._merged = merged
        self._host = sorted(host)
        self._spans = sorted(spans)
        self._bounds = (lo, hi)
        # launch calls inside each wrapper's ranges (ranges do not nest)
        ranges.sort()
        starts = [r[0] for r in ranges]
        self.wrapper_of = {}
        for corr, (s, e) in calls.items():
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and e <= ranges[i][1]:
                self.wrapper_of[corr] = ranges[i][2]
        self._starts = [h[0] for h in self._host]
        self._calls = calls

    # ----------------------------------------------------------------- #
    def kernels(self):
        return [d for d in self.device if is_kernel(d[2])]

    def kernel_s(self, pred) -> float:
        return sum(e - s for s, e, n, _ in self.kernels() if pred(n)) / 1e9

    def wrapper_s(self, wrapper: str) -> float:
        """Device seconds of the kernels launched inside `wrapper`'s
        ranges."""
        return sum(e - s for s, e, _, c in self.kernels()
                   if self.wrapper_of.get(c) == wrapper) / 1e9

    def wrapper_launches(self, wrapper: str) -> int:
        return sum(1 for _, _, _, c in self.kernels()
                   if self.wrapper_of.get(c) == wrapper)

    def _host_at(self, t: int):
        """The innermost host event covering time t (it starts last before
        t among those that cover it), or None."""
        i = bisect.bisect_right(self._starts, t) - 1
        return next((n for s, e, n in (self._host[j] for j in
                                        range(i, max(i - 4096, -1), -1))
                     if e >= t), None)

    def device_ops(self):
        """The TOP device operations by total seconds: [[name, s], ...],
        each named by the host operation that launched it and the
        kernel's name."""
        tot = {}
        for s, e, n, c in self.device:
            call = self._calls.get(c)
            op = self._host_at(call[0]) if call else None
            key = f"{op}: {n}" if op else n
            tot[key] = tot.get(key, 0) + (e - s)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:TOP]
        return [[n[:160], v / 1e9] for n, v in top]

    def idle_gaps(self):
        """The TOP host activities by the device idle time they cover:
        each gap between busy intervals (and at the window's ends) is
        named by the innermost host event at its middle."""
        lo, hi = self._bounds
        edges = [lo] + [x for iv in self._merged for x in iv] + [hi]
        tot = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2
            inner = self._host_at(mid)
            span = next((n for s, e, n in reversed(self._spans)
                         if s <= mid <= e), None)
            name = " > ".join(x for x in (span, inner) if x) \
                or "(no host event)"
            tot[name] = tot.get(name, 0) + (b - a)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:TOP]
        return [[n[:120], v / 1e9] for n, v in top]
