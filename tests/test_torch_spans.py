"""The program's spans (legommenders_tpu_torch/utils/spans.py) on the CPU.

  * with no profiler running, `span` is one shared null context, `region`
    calls its function as it is (no marker in the autograd graph) and
    nothing is recorded;
  * under a CPU torch.profiler a span's [start_ns, end_ns] holds the
    kineto events of the operators run inside it (the two share a clock);
    parents and thread ids are right, nested, and on a thread that runs a
    region's backward;
  * a tiny NAML fused training step records the step's spans in the
    nesting of the program's layers, down to the pool's and the plans'
    backward inside the item encode's, and its loss, gradients and
    updated weights are bit-identical with recording on and off;
  * a test pass records one `lego.cache.item_page` / `user_page` span per
    page of the repr caches, then the scoring and the metrics;
  * `take()` clears the records and `dump()` writes them as JSON.
"""
import copy
import json
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from legommenders_tpu_torch.data.device_pipeline import DeviceTrainPipeline
from legommenders_tpu_torch.data.processors.synthetic import (
    SyntheticProcessor,
)
from legommenders_tpu_torch.ops.additive import additive_pool
from legommenders_tpu_torch.runtime import steps
from legommenders_tpu_torch.runtime.manager import Manager
from legommenders_tpu_torch.utils import spans

DATA_KW = dict(num_items=80, num_users=40, title_len=8, history_len=6,
               vocab_size=200, inters_per_user=8)
NAML_CFG = {
    "meta": {"item": "CNN", "user": "Ada", "predictor": "Dot"},
    "config": {"use_item_content": True, "hidden_size": 16, "neg_count": 4,
               "full_catalog_encode": "on",
               "item_config": {"dropout": 0.1, "kernel_size": 3,
                               "additive_hidden_size": 32},
               "user_config": {"additive_hidden_size": 32}},
}
MARKS = ("_OutputMarkBackward", "_InputMarkBackward")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def empty():
    spans.take()
    yield
    spans.take()


@pytest.fixture(scope="module")
def naml():
    m = Manager(model_cfg=NAML_CFG,
                data=SyntheticProcessor(**DATA_KW).as_lego_data(),
                device="cpu")
    dp = DeviceTrainPipeline(m.data, batch_size=8, neg_count=4, seed=0,
                             device="cpu")
    return m, dp


def _recorded(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, spans.take(), prof


def _graph_names(t):
    seen, todo, names = set(), [t.grad_fn], []
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return names


def _children(recs, parent):
    return [r["name"] for r in recs if r["parent"] == parent]


def _index(recs, name, n=0):
    return [i for i, r in enumerate(recs) if r["name"] == name][n]


def test_no_profiler_records_nothing_and_marks_no_graph():
    s = spans.span("lego.x", step_idx=3)
    assert s is spans.span("lego.y")
    with s:
        x = torch.randn(4, 3, requires_grad=True)
        y = spans.region("lego.r", lambda t: t.tanh() * 2, x)
    assert type(y.grad_fn).__name__ == "MulBackward0"
    y.sum().backward()
    assert spans.take() == []


def test_span_holds_the_kineto_events_run_inside_it():
    x = torch.randn(64, 64)

    def run():
        torch.mm(x, x)
        with spans.span("lego.outer"):
            torch.mm(x, x)
            torch.tanh(x)
        torch.mm(x, x)

    _, recs, prof = _recorded(run)
    (rec,) = recs
    mms = sorted((e.start_ns(), e.end_ns()) for e in
                 prof.profiler.kineto_results.events()
                 if e.name() in ("aten::mm", "aten::tanh"))
    inside = [(s, e) for s, e in mms
              if rec["start_ns"] <= s and e <= rec["end_ns"]]
    assert len(mms) == 4 and len(inside) == 2
    assert mms[0][1] <= rec["start_ns"] and rec["end_ns"] <= mms[-1][0]


def test_parents_and_threads_nested_and_on_the_backward_thread():
    N, L, D, H = 5, 7, 8, 6
    g = torch.Generator().manual_seed(0)
    x = torch.randn(N, L, D, generator=g, requires_grad=True)
    mask = torch.ones(N, L)
    w1, b1, w2 = (torch.randn(*s, generator=g, requires_grad=True)
                  for s in ((D, H), (H,), (H,)))
    threads = {}

    def forward():
        with spans.span("lego.a", k=1):
            with spans.span("lego.b"):
                pass
            return spans.region(
                "lego.r", lambda t: additive_pool(t, mask, w1, b1, w2), x)

    def backward():
        # a profiler's state is the thread's own: the autograd engine
        # hands it to the threads it runs a backward on, a thread of ours
        # starts one of its own
        threads["bw"] = threading.get_native_id()
        with profile(activities=[ProfilerActivity.CPU]):
            out.sum().backward()

    with profile(activities=[ProfilerActivity.CPU]):
        out = forward()
    t = threading.Thread(target=backward)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    recs = spans.take()
    main = threading.get_native_id()
    a, b, r = (_index(recs, n) for n in ("lego.a", "lego.b", "lego.r"))
    rb, pb = _index(recs, "lego.r.backward"), _index(recs,
                                                     "lego.pool.backward")
    assert recs[a]["parent"] is None and recs[a]["attrs"] == {"k": 1}
    assert recs[b]["parent"] == a and recs[r]["parent"] == a
    assert {recs[i]["thread"] for i in (a, b, r)} == {main}
    assert recs[rb]["thread"] == recs[pb]["thread"] == threads["bw"] != main
    assert recs[rb]["parent"] is None and recs[pb]["parent"] == rb
    for outer, inner in ((a, b), (a, r), (rb, pb)):
        assert recs[outer]["start_ns"] <= recs[inner]["start_ns"] \
            <= recs[inner]["end_ns"] <= recs[outer]["end_ns"]
    assert recs[r]["end_ns"] <= recs[rb]["start_ns"]
    assert x.grad is not None and w1.grad is not None


def test_fused_step_records_the_layers_nesting(naml):
    m, dp = naml
    model = copy.deepcopy(m.model)
    step = dp.make_fused_train_step(model, m.contents.columns,
                                    steps.adam(model, 1e-3), seed=0)
    idx = next(dp.epoch_indices())
    step(idx, 0)
    _, recs, _ = _recorded(lambda: step(idx, 7))
    top = _index(recs, "lego.step")
    assert recs[top]["parent"] is None and recs[top]["attrs"] == {
        "step_idx": 7}
    assert _children(recs, top) == ["lego.assemble", "lego.zero_grad",
                                    "lego.forward", "lego.backward",
                                    "lego.optimizer"]
    fwd, bwd = _index(recs, "lego.forward"), _index(recs, "lego.backward")
    assert _children(recs, fwd) == ["lego.item_encode", "lego.user_encode",
                                    "lego.score", "lego.score"]
    # the CPU runs the backward on the step's thread: under lego.backward
    assert _children(recs, bwd) == [
        "lego.score.backward", "lego.score.backward",
        "lego.user_encode.backward", "lego.plans.backward",
        "lego.item_encode.backward"]
    ub = _index(recs, "lego.user_encode.backward")
    ib = _index(recs, "lego.item_encode.backward")
    assert _children(recs, ub) == ["lego.pool.backward"]
    assert sorted(_children(recs, ib)) == ["lego.plans.backward",
                                           "lego.plans.backward",
                                           "lego.pool.backward"]
    for i, r in enumerate(recs):
        if r["parent"] is not None:
            p = recs[r["parent"]]
            assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] \
                <= p["end_ns"], (r["name"], p["name"])


def test_recording_leaves_the_step_bit_identical(naml):
    m, dp = naml
    idx = next(dp.epoch_indices())
    out = []
    for record in (False, True):
        model = copy.deepcopy(m.model)
        step = dp.make_fused_train_step(model, m.contents.columns,
                                        steps.adam(model, 1e-3), seed=3)
        loss = (_recorded(lambda: step(idx, 5))[0] if record
                else step(idx, 5))
        out.append((loss, {n: (p.grad.clone(), p.detach().clone())
                           for n, p in model.named_parameters()}))
    assert spans.take() == []
    (l0, p0), (l1, p1) = out
    assert torch.equal(l0, l1)
    assert p0.keys() == p1.keys()
    for n in p0:
        assert torch.equal(p0[n][0], p1[n][0]), n
        assert torch.equal(p0[n][1], p1[n][1]), n


def test_marks_only_while_recording(naml):
    m, dp = naml
    model = m.model
    batch = dp.assemble(next(dp.epoch_indices()),
                        torch.Generator().manual_seed(0))
    loss_fn = steps.make_loss_fn(model, m.contents.columns, True)
    plain = loss_fn(batch, torch.Generator().manual_seed(0))
    assert not set(_graph_names(plain)) & set(MARKS)
    marked, _, _ = _recorded(
        lambda: loss_fn(batch, torch.Generator().manual_seed(0)))
    names = _graph_names(marked)
    # item encode, user encode, predictor, loss; the last three's inputs
    assert names.count("_OutputMarkBackward") == 4
    assert names.count("_InputMarkBackward") == 4
    assert torch.equal(plain, marked)


def test_test_pass_records_a_span_per_cache_page(naml):
    m, _ = naml
    ev = m.evaluator()
    ev.cache.page_size = 16
    res, recs, _ = _recorded(lambda: ev.evaluate("test"))
    assert res
    tops = [r["name"] for r in recs if r["parent"] is None]
    assert tops == ["lego.cache.items", "lego.cache.users",
                    "lego.eval.score", "lego.eval.metrics"]
    items, users = (_index(recs, n) for n in ("lego.cache.items",
                                              "lego.cache.users"))
    assert _children(recs, items) == ["lego.cache.item_page"] * 5
    assert _children(recs, users) == ["lego.cache.user_page"] * 3


def test_take_clears_and_dump_writes_json(tmp_path):
    def run():
        with spans.span("lego.a", step_idx=2):
            with spans.span("lego.b"):
                pass

    _, recs, _ = _recorded(lambda: None)
    assert recs == []
    with profile(activities=[ProfilerActivity.CPU]):
        run()
    written = spans.dump(str(tmp_path / "spans.json"))
    assert [r["name"] for r in written] == ["lego.a", "lego.b"]
    assert json.loads((tmp_path / "spans.json").read_text()) == written
    assert spans.take() == []
    with profile(activities=[ProfilerActivity.CPU]):
        run()
    first = spans.take()
    assert [(r["name"], r["parent"]) for r in first] == [("lego.a", None),
                                                          ("lego.b", 0)]
    assert spans.take() == []
