"""The program's spans joined with a profiled window's trace.

The program records spans at its layer boundaries while a profiler runs
(`legommenders_tpu_torch/utils/spans.py`: name, start and end on the
clock kineto stamps its host events with, the thread, the parent). Once
per run they are taken from the program (`records`, kept on the run) and
joined with the run's trace (`of`):
  * a launch call of the trace belongs to the innermost span that holds
    its start on the thread that made it. The trace keeps no thread for a
    launch call; while a thread waits on another (the step's thread in
    `lego.backward` while the autograd engine's thread runs the backward)
    only the other launches, and its innermost span is the one of all
    threads' spans holding the call that opened last. The call also
    belongs to that span's ancestors: on its thread by `parent`, and a
    span with no parent on its thread to the span that held its start on
    another (the engine's backward spans to the step's `lego.backward`);
  * its device record follows by correlation id; where the tracer lost a
    span's device records (it does, in bursts), the missing ones are taken
    at the mean of the recorded ones, as `readers.wrapper_roofline` does;
  * the result is each span name's device ns, launches and spans over the
    window, every span holding the launches of the spans inside it.
It logs `[spans]` lines: each name's device ms and launches a unit and
its share of the unit's busy time; the device operations each span
launches itself (not through the spans inside it), under its parent's
name and its own, named as the trace's breakdown names them; the share of
each top-level span's device time that the spans below it hold; the launch
calls that end after their span (the two clocks disagreeing); and the idle
gaps, each named by the innermost program span at its middle.
A program that records no spans (one without `utils/spans.py`) gives
None, and so does every reader of a span it lacks.
"""
import bisect

UNSPANNED = "(no program span)"
TOP = 10
OPS = 3


def records(run):
    """The program's span records, taken from it once per run; None where
    the program has no spans."""
    if not hasattr(run, "program_spans"):
        try:
            from legommenders_tpu_torch.utils import spans
        except ImportError:
            run.program_spans = None
        else:
            run.program_spans = spans.take()
    return run.program_spans


def of(run):
    """The run's Join (None without spans, a trace or profiled units),
    made and logged once."""
    if not hasattr(run, "span_join"):
        recs = records(run)
        run.span_join = None
        if recs and run.trace is not None and run.traced_units:
            run.span_join = Join(recs, run.trace)
            run.span_join.log(run.log, run.traced_units)
    return run.span_join


def ms_per_unit(run, *names):
    """Device ms a profiled unit launched inside the spans `names` (and
    the spans inside them); None where none of them launched anything."""
    j = of(run)
    if j is None:
        return None
    got = [j.ns(n) for n in names if j.launches.get(n)]
    if not got or None in got:
        return None
    return sum(got) / 1e6 / run.traced_units


def launches_per_span(run, name):
    """Kernel launches inside the spans `name`, over those spans."""
    j = of(run)
    if j is None or not j.launches.get(name):
        return None
    return float(j.launches[name]) / j.count[name]


class Join:
    def __init__(self, recs, trace):
        lo, hi = trace.window or (None, None)
        keep = [i for i, r in enumerate(recs) if r["end_ns"] is not None
                and (lo is None or (r["end_ns"] >= lo
                                    and r["start_ns"] <= hi))]
        order = sorted(keep, key=lambda i: recs[i]["start_ns"])
        pos = {i: k for k, i in enumerate(order)}
        self.spans = [recs[i] for i in order]
        self._starts = [r["start_ns"] for r in self.spans]
        self.parent = []
        for k, r in enumerate(self.spans):
            p = pos.get(r["parent"]) if r["parent"] is not None else None
            self.parent.append(p if p is not None
                               else self._holding(r["start_ns"], before=k))
        self.count = {}
        for r in self.spans:
            self.count[r["name"]] = self.count.get(r["name"], 0) + 1
        dev = {c: e - s for s, e, _, c in trace.kernels()}
        names = {c: n for _, _, n, c in trace.kernels()}
        self.launches, self.recorded, self._ns = {}, {}, {}
        self.outside = self.unspanned = 0
        self.below, self.total, self.ops = {}, {}, {}
        for corr, (s, e) in trace._calls.items():
            k = self._holding(s)
            if k is None:
                self.unspanned += 1
                continue
            if e > self.spans[k]["end_ns"]:
                self.outside += 1
            chain = self._chain(k)
            dur = dev.get(corr)
            for name in {self.spans[j]["name"] for j in chain}:
                self.launches[name] = self.launches.get(name, 0) + 1
                if dur is not None:
                    self.recorded[name] = self.recorded.get(name, 0) + 1
                    self._ns[name] = self._ns.get(name, 0) + dur
            if dur is not None:
                op = f"{trace._host_at(s)}: {names[corr]}"[:100]
                own = self.ops.setdefault(" > ".join(
                    self.spans[i]["name"] for i in chain[1::-1]), {})
                own[op] = own.get(op, 0) + dur
                top = self.spans[chain[-1]]["name"]
                self.total[top] = self.total.get(top, 0) + dur
                if len(chain) > 1:
                    self.below[top] = self.below.get(top, 0) + dur
        self.calls = len(trace._calls)
        self.busy_ns = trace.busy_s * 1e9
        self.idle = self._idle(trace)

    def _holding(self, t, before=None):
        """The span holding time t that started last (of those before
        position `before`), or None."""
        k = bisect.bisect_right(self._starts, t) - 1
        if before is not None:
            k = min(k, before - 1)
        while k >= 0:
            if self.spans[k]["end_ns"] >= t:
                return k
            k -= 1
        return None

    def _chain(self, k):
        out = [k]
        while self.parent[out[-1]] is not None:
            out.append(self.parent[out[-1]])
        return out

    def ns(self, name):
        """Device ns launched inside the spans `name`, the lost records
        taken at the mean of the recorded; None where none was recorded."""
        n, rec = self.launches.get(name, 0), self.recorded.get(name, 0)
        if not n:
            return 0.0
        return self._ns[name] * n / rec if rec else None

    def _idle(self, trace):
        """Idle ns by the innermost program span at each gap's middle."""
        lo, hi = trace._bounds
        edges = [lo] + [x for iv in trace._merged for x in iv] + [hi]
        out = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            k = self._holding((a + b) // 2)
            name = UNSPANNED if k is None else self.spans[k]["name"]
            out[name] = out.get(name, 0) + (b - a)
        return out

    def log(self, log, units):
        for name in sorted(self.launches, key=lambda n: -(self.ns(n) or 0)):
            ns = self.ns(name)
            share = (f"{100.0 * ns / self.busy_ns:.2f} % of the busy time"
                     if ns is not None and self.busy_ns else "no record")
            log(f"[spans] {name}: {(ns or 0) / 1e6 / units:.3f} ms a unit, "
                f"{self.launches[name] / units:.1f} launches a unit in "
                f"{self.count[name] / units:.1f} spans; {share}")
        for name, ops in sorted(self.ops.items(),
                                key=lambda kv: -sum(kv[1].values())):
            for op, ns in sorted(ops.items(), key=lambda kv: -kv[1])[:OPS]:
                log(f"[spans] {name} launches {op}: {ns / 1e6 / units:.3f} "
                    f"ms a unit")
        for top, ns in self.total.items():
            below = self.below.get(top, 0)
            busy = (f", {100.0 * below / self.busy_ns:.2f} % of the busy "
                    f"time" if self.busy_ns else "")
            log(f"[spans] {top}: {100.0 * below / ns:.2f} % of its "
                f"recorded device time inside the spans below it{busy}")
        log(f"[spans] launch calls: {self.calls}, {self.unspanned} in no "
            f"span, {self.outside} ending after their span")
        for name, ns in sorted(self.idle.items(), key=lambda kv: -kv[1])[
                :TOP]:
            log(f"[spans] idle in {name}: {ns / 1e6 / units:.3f} ms a unit")
