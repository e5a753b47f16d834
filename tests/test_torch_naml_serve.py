"""NAML serving in the port vs the JAX package, on bridged weights.

JAX Manager + init_params -> numpy -> `params_from_jax` -> the port. Then
the repr caches (1e-5), the cached scores of the test phase (1e-4), the
catalog-branch forward (1e-5) and `Tester.test()` metrics (1e-5) must
agree. f32, eval mode (dropout off). Small widths: 300 items, 120 users,
title 12, hidden 16, additive hidden 32, cache pages of 64 rows so both
caches span several pages.
"""
import os
import re

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
from legommenders_tpu.runtime.tester import Tester as JTester
from legommenders_tpu_torch.bridge import params_from_jax
from legommenders_tpu_torch.data.processors.synthetic import SyntheticProcessor
from legommenders_tpu_torch.runtime.manager import Manager
from legommenders_tpu_torch.runtime import tester

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_KW = dict(num_items=300, num_users=120, title_len=12, history_len=10,
               vocab_size=500, inters_per_user=6)
MODEL_CFG = {
    "meta": {"item": "CNN", "user": "Ada", "predictor": "Dot"},
    "config": {"use_item_content": True, "hidden_size": 16,
               "cache_page_size": 64,
               "item_config": {"dropout": 0.1, "kernel_size": 3,
                               "additive_hidden_size": 32},
               "user_config": {"additive_hidden_size": 32}},
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Single-threaded torch while this module runs (the suite runs in
    parallel workers); restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jit_init(jm, batch, seed):
    """`init_params` (runtime/steps.py) under one jit: the same params,
    without compiling every primitive on its own."""
    return jax.jit(lambda b, c: init_params(jm.model, b, c, seed=seed))(
        batch, jm.contents.columns)


@pytest.fixture(scope="module")
def pair():
    jm = JManager({}, MODEL_CFG, data=JSynthetic(**DATA_KW).as_lego_data(),
                  exp_cfg={"policy": {"batch_size": 8}})
    batch = next(jm.train_batcher(seed=0).epoch(shuffle=False))
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = _jit_init(jm, batch, seed=0)
    tree = jax.tree_util.tree_map(np.asarray, params)
    tm = Manager(model_cfg=MODEL_CFG,
                 data=SyntheticProcessor(**DATA_KW).as_lego_data(),
                 device="cpu")
    tm.model.load_state_dict(params_from_jax(tree, tm.model))
    jev = jm.evaluator()
    jev.evaluate(params, "test")        # builds the JAX caches
    return dict(jm=jm, params=params, tree=tree, tm=tm, batch=batch,
                jev=jev)


def test_synthetic_processor_identical():
    kw = dict(DATA_KW, num_items=90, num_users=40)
    want = JSynthetic(**kw).build()
    got = SyntheticProcessor(**kw).build()
    assert list(got) == list(want)
    for part, store in want.items():
        assert got[part].col_names() == store.col_names()
        assert got[part].col_vocab == store.col_vocab
        for col in store.col_names():
            a, b = got[part][col], store[col]
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (part, col)
        for name, vocab in store.vocab_hub.items():
            assert got[part].vocab_hub.get(name).tokens == vocab.tokens


def test_bridge_rejects_unplaced_and_unset(pair):
    tm, tree = pair["tm"], pair["tree"]
    extra = {"params": {**tree["params"], "stray": {"kernel": np.zeros((2, 2))}}}
    with pytest.raises(KeyError, match="does not have"):
        params_from_jax(extra, tm.model)
    short = {"params": {k: v for k, v in tree["params"].items()
                        if k != "user_op"}}
    with pytest.raises(KeyError, match="left unset"):
        params_from_jax(short, tm.model)


def test_repr_caches_match_jax(pair):
    jm, tm = pair["jm"], pair["tm"]
    tm.cache.cache()
    item = tm.cache.item_repr.numpy()
    user = tm.cache.user_repr.numpy()
    assert item.shape == (300, 16) and user.shape == (120, 16)
    np.testing.assert_allclose(item, np.asarray(jm.cache.item_repr),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(user, np.asarray(jm.cache.user_repr),
                               rtol=1e-5, atol=1e-5)


def test_cached_scores_match_jax(pair):
    jm, tm = pair["jm"], pair["tm"]
    want = pair["jev"].score_phase_device(pair["params"], "test")
    ev = tm.evaluator()
    tm.cache.cache()
    got = ev.score_phase_device("test").numpy()
    assert got.shape == want.shape == (120 * 6,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_catalog_forward_matches_jax(pair):
    jm, tm, batch = pair["jm"], pair["tm"], pair["batch"]
    want = np.asarray(jax.jit(lambda p, b, c: jm.model.apply(
        p, b, c, training=False))(pair["params"], batch, jm.contents.columns))
    tbatch = {k: torch.from_numpy(np.array(batch[k]))
              for k in ("candidates", "history", "mask")}
    with torch.no_grad():
        got = tm.model(tbatch, tm.contents.columns).numpy()
    assert got.shape == want.shape == (8, 5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_tester_metrics_match_jax(pair):
    want = JTester(pair["jm"], pair["params"]).test()
    got = tester.Tester(pair["tm"]).test()
    assert list(got) == list(want) == ["GAUC", "MRR", "NDCG@1", "NDCG@5",
                                       "NDCG@10"]
    for k in want:
        assert np.isfinite(got[k])
        assert abs(got[k] - want[k]) < 1e-5, (k, got[k], want[k])


def test_pretrained_feature_table_with_transform_matches_jax():
    """A pretrained 24-dim table keyed by the `title` column wins over the
    `word` vocab table and is projected to the model's 16 dims by a Linear
    (the bridge's `tr_*` path)."""
    kw = dict(DATA_KW, num_items=80, num_users=30)
    glove = np.random.default_rng(1).normal(size=(500, 24)).astype(np.float32)
    embed_cfg = {"embeddings": [{"col_name": "title", "path": glove,
                                 "frozen": True}]}
    jm = JManager({}, MODEL_CFG, embed_cfg=embed_cfg,
                  data=JSynthetic(**kw).as_lego_data(),
                  exp_cfg={"policy": {"batch_size": 8}})
    batch = next(jm.train_batcher(seed=0).epoch(shuffle=False))
    params = _jit_init(jm, {k: jnp.asarray(v) for k, v in batch.items()},
                       seed=1)
    tm = Manager(model_cfg=MODEL_CFG, embed_cfg=embed_cfg,
                 data=SyntheticProcessor(**kw).as_lego_data(), device="cpu")
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, params), tm.model)
    assert "eh.transforms.feature__title.weight" in sd
    tm.model.load_state_dict(sd)
    assert not tm.model.eh.tables["feature__title"].requires_grad
    want = np.asarray(jax.jit(lambda p, c: jm.model.apply(
        p, c, method=jm.model.encode_item_content))(params,
                                                    jm.contents.columns))
    with torch.no_grad():
        got = tm.model.encode_item_content(tm.contents.columns).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_manager_requires_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = SyntheticProcessor(**dict(DATA_KW, num_items=40,
                                     num_users=10)).as_lego_data()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Manager(model_cfg=MODEL_CFG, data=data)


@pytest.mark.parametrize("entry", ["ReprCache", "Evaluator"])
def test_entry_points_require_cuda_unless_cpu(entry, monkeypatch):
    """The caches and the evaluator default to the card and raise without
    one, as the Manager does (the Tester runs on its Manager's device)."""
    from legommenders_tpu_torch.runtime.cacher import ReprCache
    from legommenders_tpu_torch.runtime.evaluator import Evaluator

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    make = {"ReprCache": lambda: ReprCache(None, {"title": np.zeros((2, 3))},
                                           np.zeros((1, 2))),
            "Evaluator": lambda: Evaluator(None, None, ["AUC"], cache=object())}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make[entry]()


def test_port_imports_nothing_of_jax():
    """The port and chip_smoke.py import no jax/flax/optax and nothing of
    the JAX package."""
    pat = re.compile(
        r"^\s*(import|from)\s+(jax|flax|optax)\b"
        r"|legommenders_tpu\.|(import|from)\s+legommenders_tpu\b",
        re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "legommenders_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    hits = []
    for path in files:
        with open(path) as f:
            hits += [f"{path}: {m.group(0)}" for m in pat.finditer(f.read())]
    assert len(files) > 20
    assert not hits, hits
