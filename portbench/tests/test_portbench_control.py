"""The controls come out not correct (portbench/control.py): the reference
in the program's place at the configuration's control precision, fp8 (its
metric engine at bf16), and the training
faults of a loss over half of each batch and of a step that leaves the
weights unchanged; on the CPU at a size a test run holds, with the cells'
own limits: 600 items at the fixture's title and history lengths, a
training batch of 128, BERT's 12 layers at d 64. (On the card at the
cells' sizes: PERF.md §2.)"""
import pytest

import tiny
from portbench import control


def _small(workload):
    f = tiny.files(workload, "bf16")
    f["config"]["data"].update(items=600, users=300, vocab=3000,
                               title_tokens=[15, 30], history=[3, 50],
                               train_clicks=512, negatives=[4, 100],
                               test_impressions=150, candidates=[2, 72])
    if f["traffic"]["kind"] == "train":
        f["traffic"]["batch_size"] = 128
    else:
        f["config"]["reference"].update(layers=12)
        f["config"]["model"]["config"]["item_config"][
            "num_hidden_layers"] = 12
    return f


@pytest.mark.parametrize("workload", ["naml.train", "bert-naml.eval"])
def test_controls_are_not_correct(workload):
    f = _small(workload)
    out = control.control(f, 77, "cpu")
    modes = [k for k in out if k not in ("seed", "workload")]
    want = {f["config"]["control"]}
    if f["traffic"]["kind"] == "train":
        want |= {"half_batch", "unchanged"}
    assert set(modes) == want
    for mode in modes:
        assert out[mode]["correct"] is False, (mode, out[mode]["numbers"])
