"""The port's full-forward and host-batched evaluation vs the JAX package.

NAML (CNN / Ada / Dot, hidden 16, dropout 0, f32) on bridged weights over
a 150-item synthetic catalog (60 users, 12 rows each: 720 test rows), with
an eval batch of 64 (the last page of the full-forward path padded with
row 0: 720 = 11 x 64 + 16). Checked, within 1e-5:
  * `score_phase_device_full` against JAX's, and against the port's own
    cached scores;
  * `evaluate(use_cache=False)` metrics against JAX's and against the
    port's cached path;
  * the host-batched path (`collect_scores` through `max_batches`, cached
    and uncached) against JAX's `evaluate(..., max_batches=3)`;
  * `Tester.latency` times every batch it scores, cached and uncached.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legommenders_tpu.data.processors.synthetic import (
    SyntheticProcessor as JSynthetic,
)
from legommenders_tpu.runtime.manager import Manager as JManager
from legommenders_tpu.runtime.steps import init_params
from legommenders_tpu_torch.bridge import params_from_jax
from legommenders_tpu_torch.data.processors.synthetic import SyntheticProcessor
from legommenders_tpu_torch.runtime.manager import Manager
from legommenders_tpu_torch.runtime.tester import Tester
from legommenders_tpu_torch.utils.timer import Timer

DATA_KW = dict(num_items=150, num_users=60, title_len=10, history_len=8,
               vocab_size=300, inters_per_user=12)
MODEL_CFG = {
    "meta": {"item": "CNN", "user": "Ada", "predictor": "Dot"},
    "config": {"use_item_content": True, "hidden_size": 16,
               "cache_page_size": 64,
               "item_config": {"dropout": 0.0, "kernel_size": 3,
                               "additive_hidden_size": 32},
               "user_config": {"additive_hidden_size": 32}},
}
EXP = {"policy": {"batch_size": 16, "eval_batch_size": 64}}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Single-threaded torch while this module runs (the suite runs in
    parallel workers); restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    jm = JManager({}, MODEL_CFG, data=JSynthetic(**DATA_KW).as_lego_data(),
                  exp_cfg=EXP)
    batch = next(jm.train_batcher(seed=0).epoch(shuffle=False))
    params = jax.jit(lambda b, c: init_params(jm.model, b, c, seed=2))(
        {k: jnp.asarray(v) for k, v in batch.items()}, jm.contents.columns)
    tm = Manager(model_cfg=MODEL_CFG, exp_cfg=EXP,
                 data=SyntheticProcessor(**DATA_KW).as_lego_data(),
                 device="cpu")
    tm.model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tm.model))
    return dict(jm=jm, jev=jm.evaluator(), params=params, tm=tm,
                ev=tm.evaluator())


def test_full_scores_match_jax_and_the_cache(pair):
    ev, tm = pair["ev"], pair["tm"]
    assert ev.batch_size == 64 and ev.phase("test").n == 720
    got = ev.score_phase_device_full("test").numpy()
    want = np.asarray(pair["jev"].score_phase_device_full(pair["params"],
                                                          "test"))
    assert got.shape == want.shape == (720,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    tm.cache.cache()
    cached = ev.score_phase_device("test").numpy()
    np.testing.assert_allclose(got, cached, rtol=1e-5, atol=1e-5)


def test_full_forward_metrics_match_jax_and_the_cache(pair):
    ev = pair["ev"]
    got = ev.evaluate("test", use_cache=False)
    want = pair["jev"].evaluate(pair["params"], "test", use_cache=False)
    cached = ev.evaluate("test")
    assert list(got) == list(want) == list(cached)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5, (k, got, want)
        assert abs(got[k] - cached[k]) <= 1e-5, (k, got, cached)


@pytest.mark.parametrize("use_cache", [True, False])
def test_host_batched_sweep_matches_jax(pair, use_cache):
    """collect_scores over the first 3 eval batches (192 rows)."""
    got = pair["ev"].evaluate("test", use_cache=use_cache, max_batches=3)
    want = pair["jev"].evaluate(pair["params"], "test", use_cache=use_cache,
                                max_batches=3)
    whole = pair["ev"].evaluate("test", use_cache=use_cache)
    assert list(got) == list(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5, (k, got, want)
    assert got != whole


@pytest.mark.parametrize("use_cache", [True, False])
def test_latency_times_each_batch(pair, use_cache, monkeypatch):
    timers = []
    real = Timer

    def spy(*a, **k):
        timers.append(real(*a, **k))
        return timers[-1]

    monkeypatch.setattr("legommenders_tpu_torch.runtime.tester.Timer", spy)
    ms = Tester(pair["tm"]).latency(num_batches=4, use_cache=use_cache)
    assert ms > 0
    assert timers[0].counts["forward"] == 4
    assert ms == pytest.approx(timers[0].avg_ms("forward"))


def test_uncached_manager_evaluates_by_full_forward(pair):
    """use_fast_eval off: no caches; the evaluator takes the full-forward
    path, whose metrics equal the cached ones of the same weights."""
    cfg = {**MODEL_CFG, "config": {**MODEL_CFG["config"],
                                   "use_fast_eval": False}}
    tm = Manager(model_cfg=cfg, exp_cfg=EXP, data=pair["tm"].data,
                 device="cpu")
    tm.model.load_state_dict(pair["tm"].model.state_dict())
    assert tm.cache is None
    got = Tester(tm).test()
    want = pair["ev"].evaluate("test", use_cache=True)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5, (k, got, want)
