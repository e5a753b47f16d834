"""The cells on the card, briefly: each runs at its own sizes, untraced and
traced, comes out correct and reports every metric it lists. Skips without
a card; on the card:

    python -m pytest -o addopts="" -m cuda portbench/tests/test_portbench_card.py
"""
import pytest
import torch

from tiny import ROOT  # noqa: F401
from portbench import harness

pytestmark = pytest.mark.cuda
MAN = harness.manifest()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", [w["name"] for w in MAN["workloads"]])
def test_cell_on_the_card(card, workload, trace):
    files = harness.cell_files(MAN, workload)
    out = harness.run_cell(files, 2 ** 31 + 19, 2.0, trace, card,
                           log=lambda m: None)
    assert out["correct"], out["checks"]
    want = files["per_layer"] if trace else files["end_to_end"]
    assert set(out["metrics"]) == {m["name"] for m in want}
    assert out["device"]["platform"] == "gpu"
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        for m in out["metrics"]:
            if m.endswith("_roofline") or "_roofline." in m or "mfu" in m:
                assert 0 < out["metrics"][m]["value"] <= 100
