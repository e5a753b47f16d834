"""NRMS, LSTUR, Fastformer and MINER end to end in the port vs the JAX
package, on the CPU, on bridged weights.

Each model is `config/model/<name>.yaml` as the config parser reads it,
with the YAML's own knobs set small (hidden 16, 2 heads, 1 layer, 4
context codes of 8), over a 120-item synthetic catalog (60 users, title
8, history 10), f32, eval mode:
  * Manager + Tester.test(): every metric within 1e-5 of JAX's Tester;
    NRMS, LSTUR and Fastformer through the repr caches (their reprs within
    1e-5), MINER, whose user operator refuses caching, through full
    forwards (the Manager builds no cache);
  * the catalog-branch forward's scores within 1e-5.
NRMS trains 20 Adam steps (lr 1e-3, batches of 8 from the port's device
pipeline, dropout 0) against JAX's train step and optax.adam with the
catalog plans live on both sides: every loss within 1e-5 relative, every
parameter within 1e-4 at the end. The YAMLs also train through the port's
Trainer (one epoch of 3 steps, finite loss and metrics), and at their
defaults their pools get the (L, H) chip_smoke.py's phase 7 holds the
pool kernel at (ZOO_POOLS).
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from legommenders_tpu.data.processors.synthetic import (
    SyntheticProcessor as JSynthetic,
)
from legommenders_tpu.runtime import steps as jsteps
from legommenders_tpu.runtime.manager import Manager as JManager
from legommenders_tpu.runtime.tester import Tester as JTester
from legommenders_tpu_torch.bridge import params_from_jax
from legommenders_tpu_torch.config import parser
from legommenders_tpu_torch.data.device_pipeline import DeviceTrainPipeline
from legommenders_tpu_torch.data.processors.synthetic import SyntheticProcessor
from legommenders_tpu_torch.ops import catalog_grad
from legommenders_tpu_torch.runtime import steps
from legommenders_tpu_torch.runtime.manager import Manager
from legommenders_tpu_torch.runtime.tester import Tester
from legommenders_tpu_torch.runtime.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_KW = dict(num_items=120, num_users=60, title_len=8, history_len=10,
               vocab_size=300, inters_per_user=6)
BATCH = 8
SMALL = {"hidden_size": 16, "num_item_heads": 2, "num_user_heads": 2,
         "item_layers": 1, "user_layers": 1, "num_context_codes": 4,
         "context_code_dim": 8}
MODELS = ("nrms", "lstur", "fastformer", "miner")
OPERATORS = {"nrms": ("Attention", "Attention", "Dot"),
             "lstur": ("CNNCat", "GRU", "Dot"),
             "fastformer": ("Fastformer", "Fastformer", "Dot"),
             "miner": ("Transformer", "PolyAttention", "MINER")}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def model_cfg(name: str) -> dict:
    cfg = parser.parse_four_way({"model": name, **SMALL},
                                config_root=os.path.join(ROOT, "config"))
    cfg = copy.deepcopy(cfg.raw()["model"])
    cfg["config"]["cache_page_size"] = 32
    return cfg


def _build(name):
    cfg = model_cfg(name)
    jm = JManager({}, cfg, data=JSynthetic(**DATA_KW).as_lego_data(),
                  exp_cfg={"policy": {"batch_size": BATCH}})
    batch = next(jm.train_batcher(seed=0).epoch(shuffle=False))
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.jit(lambda b, c: jsteps.init_params(jm.model, b, c, seed=0))(
        batch, jm.contents.columns)
    tree = jax.tree_util.tree_map(np.asarray, params)
    tm = Manager(model_cfg=cfg, data=SyntheticProcessor(**DATA_KW)
                 .as_lego_data(), device="cpu")
    tm.model.load_state_dict(params_from_jax(tree, tm.model))
    return dict(cfg=cfg, jm=jm, tm=tm, params=params, batch=batch)


@pytest.fixture(scope="module")
def pairs():
    return {}


def _pair(pairs, name):
    if name not in pairs:
        pairs[name] = _build(name)
    return pairs[name]


@pytest.mark.parametrize("name", MODELS)
def test_yaml_builds_the_zoo_model(name):
    cfg = model_cfg(name)
    tm = Manager(model_cfg=cfg, data=SyntheticProcessor(**DATA_KW)
                 .as_lego_data(), device="cpu")
    m = tm.model
    assert tuple(type(x).__name__.replace(suffix, "") for x, suffix in (
        (m.item_op, "Operator"), (m.user_op, "Operator"),
        (m.predictor, "Predictor"))) == OPERATORS[name]
    assert (tm.cache is None) == (name == "miner")
    assert set(m.catalog_plans) == {"title", "category"}
    assert m.catalog_history_plan is not None


@pytest.mark.parametrize("name", MODELS)
def test_tester_and_forward_match_jax(pairs, name):
    p = _pair(pairs, name)
    jm, tm, params, batch = p["jm"], p["tm"], p["params"], p["batch"]
    want = np.asarray(jax.jit(lambda q, b, c: jm.model.apply(
        q, b, c, training=False))(params, batch, jm.contents.columns))
    tbatch = {k: torch.from_numpy(np.array(batch[k]))
              for k in ("candidates", "history", "mask")}
    with torch.no_grad():
        got = tm.model(tbatch, tm.contents.columns).numpy()
    assert got.shape == want.shape == (BATCH, 5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    jres = JTester(jm, params).test()
    res = Tester(tm).test()
    assert list(res) == list(jres)
    for k in jres:
        assert np.isfinite(res[k])
        assert abs(res[k] - jres[k]) < 1e-5, (k, res[k], jres[k])
    if tm.cache is not None:
        tm.cache.cache()
        for part in ("item_repr", "user_repr"):
            np.testing.assert_allclose(
                getattr(tm.cache, part).numpy(),
                np.asarray(getattr(jm.cache, part)), rtol=1e-5, atol=1e-5)


def _batches(tm, n, seed=0):
    dp = DeviceTrainPipeline(tm.data, batch_size=BATCH, neg_count=4,
                             seed=seed, device="cpu")
    out, g = [], torch.Generator().manual_seed(seed)
    while len(out) < n:
        for idx in dp.epoch_indices():
            b = dp.assemble(idx, g)
            out.append((b, {k: jnp.asarray(v.numpy().astype(
                np.float32 if k == "label" else np.int32))
                for k, v in b.items()}))
            if len(out) == n:
                break
    return out


def test_nrms_adam_trajectory_with_plans_matches_jax(pairs):
    p = _pair(pairs, "nrms")
    cfg = copy.deepcopy(p["cfg"])
    for side in ("item_config", "user_config"):
        cfg["config"][side]["attention_dropout"] = 0.0
    jm = JManager({}, cfg, data=JSynthetic(**DATA_KW).as_lego_data(),
                  exp_cfg={"policy": {"batch_size": BATCH}})
    tm = Manager(model_cfg=cfg, data=p["tm"].data, device="cpu")
    tm.model.load_state_dict(p["tm"].model.state_dict())
    batches = _batches(tm, 20, seed=1)
    opt = optax.adam(1e-3)
    jstep = jsteps.make_train_step(jm.model, jm.contents.columns, opt, True)
    params = jax.tree_util.tree_map(jnp.array, p["params"])
    opt_state = opt.init(params)
    model = tm.model
    step = steps.make_train_step(model, tm.contents.columns,
                                 steps.adam(model, 1e-3))
    for i, (bt, bj) in enumerate(batches):
        params, opt_state, want = jstep(params, opt_state, bj,
                                        jax.random.PRNGKey(i))
        catalog_grad.record_trace((), ())
        got = step(bt, torch.Generator().manual_seed(i)).item()
        assert set(catalog_grad.last_trace["live"]) == {"title", "category"}
        assert catalog_grad.last_trace["history"]
        assert abs(got - float(want)) <= 1e-5 * abs(float(want)), (i, got,
                                                                    want)
    final = params_from_jax(jax.tree_util.tree_map(np.asarray, params), model)
    moved = 0
    for name, t in model.named_parameters():
        np.testing.assert_allclose(t.detach().numpy(), final[name].numpy(),
                                   rtol=0, atol=1e-4, err_msg=name)
        moved += not torch.equal(t.detach(),
                                 p["tm"].model.state_dict()[name])
    assert moved >= 10


@pytest.mark.parametrize("name", MODELS)
def test_trainer_runs_the_yaml(name):
    cfg = model_cfg(name)
    tm = Manager(model_cfg=cfg, data=SyntheticProcessor(**DATA_KW)
                 .as_lego_data(), device="cpu",
                 exp_cfg={"policy": {"batch_size": BATCH, "epoch": 1,
                                     "epoch_batch": 3}})
    tr = Trainer(tm, seed=0)
    catalog_grad.record_trace((), ())
    out = tr.train()
    assert tr.global_step == 3
    assert set(catalog_grad.last_trace["live"]) == {"title", "category"}
    assert np.isfinite(out["best_dev"])
    res = tr.test()
    assert all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in res.values())


def test_chip_smoke_zoo_pool_shapes_are_the_models():
    """chip_smoke.ZOO_POOLS (the pool shapes phase 7 holds the kernel at)
    are the (L, H) the four YAMLs' pools get at chip_smoke's title and
    history lengths, D 64."""
    import sys
    from unittest import mock

    sys.path.insert(0, ROOT)
    import chip_smoke
    from legommenders_tpu_torch.models.common import AdditiveAttention

    kw = dict(chip_smoke.DATA_KW, num_items=200, num_users=12,
              vocab_size=300, inters_per_user=4)
    data = SyntheticProcessor(**kw).as_lego_data()
    seen = set()
    forward = AdditiveAttention.forward

    def spy(self, inputs, mask=None):
        seen.add((inputs.shape[-2], inputs.shape[-1],
                  self.proj_kernel.shape[1]))
        return forward(self, inputs, mask)

    with mock.patch.object(AdditiveAttention, "forward", spy), \
            torch.no_grad():
        for name in MODELS:
            cfg = parser.parse_four_way(
                {"model": name}, config_root=os.path.join(ROOT, "config")
            ).raw()["model"]
            tm = Manager(model_cfg=cfg, data=data, device="cpu")
            reprs = tm.model.encode_item_content(tm.contents.columns)
            hist = torch.as_tensor(data.history_matrix()[:4]).long()
            tm.model.encode_user(reprs[hist.clamp(min=0)],
                                 (hist >= 0).int())
    want = {(L, 64, h) for L, h, _ in chip_smoke.ZOO_POOLS.values()}
    want.add((kw["history_len"], 64, 256))      # NRMS users: NAML's pool
    assert seen == want
