"""The plain reference against legommenders_tpu_torch at float32 on the CPU,
at tiny sizes, through the harness's own run: the training steps (loss,
first gradient, update), the evaluation's vectors and group metrics, for
both configurations; and the reference's metrics against the port's
metric engine."""
import copy

import numpy as np
import pytest

import tiny
from portbench import harness
from portbench.reference.metrics import group_metrics

F32_GAP = 1e-5


def _eval_files(config: str):
    """The eval traffic over `config` (naml has no eval cell: its eval runs
    here only)."""
    f = tiny.files("bert-naml.eval")
    if config != "bert-naml":
        other = tiny.files("naml.train")
        f = dict(f, config=other["config"], limits=f["limits"])
    return f


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 5])
def test_naml_training_matches_the_port(seed):
    out = harness.run_cell(tiny.files("naml.train"), seed, 0.5, False,
                           "cpu", log=lambda m: None)
    assert out["correct"]
    for name, c in out["checks"].items():
        assert c["value"] < F32_GAP, (name, c)


@pytest.mark.parametrize("config", ["naml", "bert-naml"])
def test_evaluation_matches_the_port(config):
    out = harness.run_cell(_eval_files(config), 11, 0.5, False, "cpu",
                           log=lambda m: None)
    assert out["correct"]
    for name, c in out["checks"].items():
        assert c["value"] < F32_GAP, (name, c)


def test_metrics_match_the_port_engine():
    from legommenders_tpu_torch.runtime.metrics import MetricPool

    rng = np.random.default_rng(0)
    n = 5000
    groups = np.repeat(np.arange(400), rng.integers(1, 25, 400))[:n]
    scores = rng.normal(size=len(groups)).round(1)   # ties too
    labels = (rng.random(len(groups)) < 0.2).astype(np.int32)
    names = ["GAUC", "MRR", "NDCG@1", "NDCG@5", "NDCG@10"]
    want = MetricPool.parse(names)(scores, labels, groups)
    got = group_metrics(scores, labels, groups, names)
    for k in names:
        assert got[k] == pytest.approx(want[k], abs=1e-12), k


def test_bf16_program_reads_above_f32_and_below_the_limits():
    """At the configuration's bf16 the gaps are the bf16 roundings':
    above the float32 parity, and (training) within the cell's limits."""
    f = tiny.files("naml.train", "bf16")
    out = harness.run_cell(copy.deepcopy(f), 4, 0.5, False, "cpu",
                           log=lambda m: None)
    assert out["correct"]
    assert max(c["value"] for c in out["checks"].values()) > F32_GAP
