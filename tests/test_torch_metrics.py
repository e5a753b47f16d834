"""The port's torch group-metric engine vs its numpy MetricPool.

`legommenders_tpu_torch/runtime/device_metrics.py` must reproduce the
numpy segment engine (the port's copy of runtime/metrics.py) at 1e-6 on
score ties, single-class groups, singleton groups, non-dense group ids and
a large-prefix case, as tests/test_device_metrics.py holds the JAX engine.
The port's numpy pool is in turn held to the JAX package's.
"""
import numpy as np
import pytest
import torch

from legommenders_tpu.runtime.metrics import MetricPool as JMetricPool
from legommenders_tpu_torch.runtime.metrics import MetricPool

ALL = ["GAUC", "MRR", "MRR0", "LRAP", "NDCG@1", "NDCG@5", "NDCG@10",
       "HitRatio@5", "Recall@5"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Single-threaded torch while this module runs (the suite runs in
    parallel workers); restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_case(rng, n_groups=400, max_size=40, ties=False):
    sizes = rng.integers(1, max_size, n_groups)
    groups = np.repeat(rng.permutation(n_groups * 3)[:n_groups], sizes)
    n = len(groups)
    scores = rng.normal(size=n).astype(np.float32)
    if ties:
        # quantize so (group, score) tie runs appear
        scores = np.round(scores * 4) / 4
    labels = (rng.random(n) < 0.3).astype(np.float32)
    return scores, labels, groups


def _device(pool, scores, labels, groups, max_groups=0):
    return pool.calculate_device(
        torch.as_tensor(scores, dtype=torch.float32),
        torch.as_tensor(labels), torch.as_tensor(groups.astype(np.int32)),
        max_groups)


@pytest.mark.parametrize("ties", [False, True])
def test_torch_engine_matches_numpy_random(ties):
    rng = np.random.default_rng(7 + ties)
    scores, labels, groups = _rand_case(rng, ties=ties)
    pool = MetricPool.parse(ALL)
    assert pool.supports_device
    want = pool(scores, labels, groups)
    got = _device(pool, scores, labels, groups,
                  max_groups=len(np.unique(groups)))
    assert list(got) == list(want)
    for k in want:
        assert abs(got[k] - want[k]) < 1e-6, (k, got[k], want[k])


def test_torch_engine_matches_numpy_degenerate_groups():
    """all-positive, all-negative and singleton groups exercise every
    valid-mask branch (GAUC two-class filter, MRR/Recall pos>0, LRAP=1)."""
    scores = np.array([0.9, 0.1, 0.5, 0.4, 0.3, 0.8, 0.2, 0.6, 0.7],
                      np.float32)
    labels = np.array([1, 1, 0, 0, 0, 1, 0, 1, 0], np.float32)
    groups = np.array([5, 5, 9, 9, 9, 2, 7, 7, 7], np.int32)
    pool = MetricPool.parse(ALL)
    want = pool(scores, labels, groups)
    got = _device(pool, scores, labels, groups)
    for k in want:
        assert abs(got[k] - want[k]) < 1e-6, (k, got[k], want[k])


def test_torch_engine_matches_numpy_large_prefix():
    """At 400k rows the global prefix sums are ~1e5 while group totals are
    ~1: differencing a plain f32 cumsum of real values would be wrong in
    the second decimal here. 20k groups, heavy ties."""
    rng = np.random.default_rng(11)
    sizes = rng.integers(5, 35, 20_000)
    groups = np.repeat(np.arange(20_000), sizes)
    n = len(groups)
    scores = (np.round(rng.standard_normal(n) * 8) / 8).astype(np.float32)
    labels = (rng.random(n) < 0.25).astype(np.float32)
    pool = MetricPool.parse(ALL)
    want = pool(scores, labels, groups)
    got = _device(pool, scores, labels, groups, max_groups=20_000)
    for k in want:
        assert abs(got[k] - want[k]) < 1e-6, (k, got[k], want[k])


def test_pointwise_metrics_fall_back_to_numpy():
    rng = np.random.default_rng(3)
    scores, labels, groups = _rand_case(rng, n_groups=50)
    scores = 1.0 / (1.0 + np.exp(-scores))
    pool = MetricPool.parse(["AUC", "GAUC"])
    assert not pool.supports_device
    want = pool(scores, labels, groups)
    got = _device(pool, scores, labels, groups)
    for k in want:
        assert abs(got[k] - want[k]) < 1e-6, (k, got[k], want[k])


def test_numpy_pool_copy_matches_jax_package():
    rng = np.random.default_rng(5)
    scores, labels, groups = _rand_case(rng, n_groups=100, ties=True)
    want = JMetricPool.parse(ALL)(scores, labels, groups)
    got = MetricPool.parse(ALL)(scores, labels, groups)
    assert got == want
