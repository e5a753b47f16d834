"""portbench/spans.py on a synthetic trace: the program's span records
joined with the launch calls and device records of a trace built from
hand-made kineto events (as `trace.Trace` walks them).

One step: the step's thread holds `lego.step` > `lego.forward` >
`lego.item_encode`, then `lego.backward` while the engine's thread runs
`lego.item_encode.backward` > `lego.pool.backward`, then
`lego.optimizer`. A launch goes to the innermost span holding it on its
thread, and counts for that span's ancestors, across the two threads; a
lost device record is taken at the mean of its span's recorded ones; a
call that ends after its span is counted; idle gaps are named by the
innermost span at their middle; every reader gives None where the
program recorded no span, or has no spans at all.
"""
import sys
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from tiny import ROOT  # noqa: F401
from portbench import harness, spans, trace

MAIN, ENGINE = 101, 202
NEW = ("item_encode_ms.train", "pool_backward_ms.train",
       "plans_backward_ms.train", "optimizer_ms.train",
       "item_cache_device_ms.eval", "user_cache_device_ms.eval",
       "launches_per_item_page.eval")


class Ev:
    def __init__(self, name, dev, start, end, corr=0):
        self._n, self._d, self._s, self._e, self._c = name, dev, start, end, \
            corr

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def correlation_id(self):
        return self._c


def _rec(name, start, end, thread=MAIN, parent=None, **attrs):
    return {"name": name, "start_ns": start, "end_ns": end,
            "thread": thread, "parent": parent, "attrs": attrs}


RECORDS = [
    _rec("lego.step", 100, 9000, step_idx=0),                      # 0
    _rec("lego.forward", 200, 3000, parent=0),                     # 1
    _rec("lego.item_encode", 300, 2000, parent=1),                 # 2
    _rec("lego.backward", 3100, 8000, parent=0),                   # 3
    _rec("lego.item_encode.backward", 3500, 7000, thread=ENGINE),  # 4
    _rec("lego.pool.backward", 4000, 5000, thread=ENGINE, parent=4),
    _rec("lego.optimizer", 8100, 8900, parent=0),                  # 6
    _rec("lego.open", 8950, None, parent=0),
]
# correlation id: (launch call start, end), its kernel's interval or None
CALLS = {
    1: ((400, 410), (500, 600)),        # lego.item_encode
    2: ((3200, 3210), (3300, 3400)),    # lego.backward, between spans
    3: ((4100, 4110), (4200, 4500)),    # lego.pool.backward
    4: ((4600, 4610), None),            # lego.pool.backward, record lost
    5: ((6000, 6010), (6100, 6300)),    # lego.item_encode.backward
    6: ((8200, 8210), (8300, 8400)),    # lego.optimizer
    7: ((9500, 9510), (9600, 9700)),    # no span
    8: ((1990, 2010), (2100, 2150)),    # lego.item_encode, ends after it
}


def _trace():
    events = [Ev(trace.WINDOW, DeviceType.CPU, 0, 10000)]
    for corr, (call, kernel) in CALLS.items():
        events.append(Ev("cudaLaunchKernel", DeviceType.CPU, *call, corr))
        events.append(Ev("aten::mm", DeviceType.CPU, call[0] - 5,
                         call[1] + 5))
        if kernel:
            events.append(Ev(f"kernel_{corr}", DeviceType.CUDA, *kernel,
                             corr))
    return trace.Trace(events)


def _run(records=RECORDS, units=1):
    lines = []
    return SimpleNamespace(trace=_trace(), traced_units=units,
                           program_spans=records, log=lines.append,
                           lines=lines)


def test_a_launch_goes_to_its_innermost_span_and_its_ancestors():
    run = _run()
    j = spans.of(run)
    assert j.launches == {"lego.step": 7, "lego.forward": 2,
                          "lego.item_encode": 2, "lego.backward": 4,
                          "lego.item_encode.backward": 3,
                          "lego.pool.backward": 2, "lego.optimizer": 1}
    assert j.count["lego.pool.backward"] == 1 and "lego.open" not in j.count
    assert (j.unspanned, j.outside, j.calls) == (1, 1, 8)
    assert j.ns("lego.item_encode") == 150
    assert j.ns("lego.optimizer") == 100
    assert harness.reader("optimizer_ms.train")(run) == pytest.approx(1e-4)
    assert spans.of(run) is j
    assert any(line.startswith("[spans] lego.step: ") for line in run.lines)


def test_lost_records_are_taken_at_the_mean_of_the_recorded():
    run = _run(units=2)
    j = spans.of(run)
    assert j.ns("lego.pool.backward") == 300 * 2
    assert j.ns("lego.item_encode.backward") == (300 + 200) * 3 / 2
    assert j.ns("lego.backward") == (100 + 300 + 200) * 4 / 3
    assert harness.reader("pool_backward_ms.train")(run) == \
        pytest.approx(600 / 1e6 / 2)
    assert harness.reader("item_encode_ms.train")(run) == \
        pytest.approx((150 + 750) / 1e6 / 2)


def test_idle_gaps_named_by_the_innermost_span_at_their_middle():
    j = spans.of(_run())
    assert j.idle == {
        "lego.forward": 500 + 1150,                 # 0-500, 2150-3300
        "lego.item_encode": 1500,                   # 600-2100
        "lego.item_encode.backward": 800 + 1600,    # 3400-4200, 4500-6100
        "lego.backward": 2000,                      # 6300-8300
        "lego.step": 1200,                          # 8400-9600
        spans.UNSPANNED: 300}                       # 9700-10000


def test_launches_per_span():
    recs = [_rec("lego.cache.items", 100, 9000),
            _rec("lego.cache.item_page", 300, 2500, parent=0),
            _rec("lego.cache.item_page", 3000, 7500, parent=0)]
    run = _run(recs)
    assert harness.reader("launches_per_item_page.eval")(run) == 6 / 2
    assert harness.reader("item_cache_device_ms.eval")(run) == \
        pytest.approx((100 + 50 + 100 + 300 + 200 + 100) * 7 / 6 / 1e6)
    assert harness.reader("user_cache_device_ms.eval")(run) is None


@pytest.mark.parametrize("name", NEW)
def test_readers_give_none_without_spans(name, monkeypatch):
    read = harness.reader(name)
    assert read(_run([])) is None
    assert read(SimpleNamespace(trace=None, traced_units=0,
                                program_spans=RECORDS, log=print)) is None
    # a program without utils/spans.py
    import legommenders_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "legommenders_tpu_torch.utils.spans",
                        None)
    run = _run()
    del run.program_spans
    assert read(run) is None and run.program_spans is None
