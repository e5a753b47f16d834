"""The CTR zoo and the id-only models end to end in the port vs the JAX
package, on the CPU, on bridged weights.

Each of the 24 YAMLs (the ten CTR heads over the id-only path and over
the Pooling item operator: {dnn,pnn,deepfm,dcn,dcnv2,gdcn,autoint,
masknet,finalmlp,din}_{id,text}; naml_id, nrms_id, miner_id, bst_text) is
`config/model/<name>.yaml` as the config parser reads it, its knobs made
small (hidden 16, MLPs of [16, 16], one attention layer of 2 heads, 4
context codes of 8, cross_num 2, a low rank of 4 with 2 experts) over the
120-item catalog of tests/test_torch_zoo_models.py, f32, dropout 0, the
two Managers of each YAML built once for the module, eval mode:
  * Manager + Tester.test(): every metric within 1e-5 of JAX's Tester,
    through the repr caches for the _text models whose operators allow
    them, by full forwards for the id-only models and DIN (their pages at
    JAX's page size: DIN's batch norm scores depend on the page);
  * the forward's scores on one training batch within 1e-5.
Five models train 20 Adam steps (lr 1e-3, batches of 8 from the port's
device pipeline, dropout 0) against JAX's train step and optax.adam, in
ranking mode (dcn_id, dcnv2_text, din_text, autoint_id: pointwise BCE
over K = 1 with the f32 labels) and in matching mode (nrms_id): every
loss within 1e-5 relative, every parameter within 1e-4 at the end. Each
YAML also runs the port's fused device step and its Trainer (one epoch
of 3 steps, finite loss and metrics). DIN refuses matching mode and MINER
ranking mode, as in JAX; an id-only model builds no repr cache.
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
from legommenders_tpu_torch.runtime import steps
from legommenders_tpu_torch.runtime.manager import Manager
from legommenders_tpu_torch.runtime.tester import Tester
from legommenders_tpu_torch.runtime.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_KW = dict(num_items=120, num_users=60, title_len=8, history_len=10,
               vocab_size=300, inters_per_user=6)
BATCH = 8
HEADS = ("dnn", "pnn", "deepfm", "dcn", "dcnv2", "gdcn", "autoint",
         "masknet", "finalmlp", "din")
MODELS = tuple(f"{h}_{side}" for h in HEADS for side in ("id", "text")) + (
    "naml_id", "nrms_id", "miner_id", "bst_text")
# the YAMLs' placeholders
SMALL = {"hidden_size": 16, "num_user_heads": 2, "user_layers": 1,
         "num_context_codes": 4, "context_code_dim": 8, "cross_num": 2,
         "autoint_attention_layers": 1, "autoint_attention_heads": 2,
         "autoint_attention_dim": 16, "masknet_block_dim": 16}
# predictor_config knobs the YAMLs write out
SMALL_PREDICTOR = {
    "dnn_hidden_units": [16, 16], "stacked_dnn_hidden_units": [16, 16],
    "parallel_dnn_hidden_units": [16, 16], "mlp1_hidden_units": [16, 16],
    "mlp2_hidden_units": [16, 16], "hidden_units": [16, 16],
    "attention_hidden_units": [16], "low_rank": 4, "num_experts": 2}
DROPOUTS = ("dnn_dropout", "attention_dropout", "net_dropout")
TRAINED = {"dcn_id": False, "dcnv2_text": False, "din_text": False,
           "autoint_id": False, "nrms_id": True}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def model_cfg(name: str, dropout: bool = True) -> dict:
    cfg = parser.parse_four_way({"model": name, **SMALL},
                                config_root=os.path.join(ROOT, "config"))
    cfg = copy.deepcopy(cfg.raw()["model"])
    c = cfg["config"]
    c["cache_page_size"] = 32
    pc = c.setdefault("predictor_config", {})
    for k, v in SMALL_PREDICTOR.items():
        if k in pc or (k == "low_rank" and pc.get("use_low_rank_mixture")) \
                or (k == "num_experts" and pc.get("use_low_rank_mixture")):
            pc[k] = v
    if not dropout:
        for k in DROPOUTS:
            if k in pc:
                pc[k] = 0.0
        if "user_config" in c and "attention_dropout" in c["user_config"]:
            c["user_config"]["attention_dropout"] = 0.0
        if name == "nrms_id":
            c.setdefault("user_config", {})["attention_dropout"] = 0.0
    return cfg


@pytest.fixture(scope="module")
def jdata():
    return JSynthetic(**DATA_KW).as_lego_data()


@pytest.fixture(scope="module")
def tdata():
    return SyntheticProcessor(**DATA_KW).as_lego_data()


def _pair(name, jdata, tdata):
    """The JAX Manager and the port's of one YAML at dropout 0, the JAX
    parameters bridged into the port's model, and JAX's first training
    batch."""
    cfg = model_cfg(name, dropout=False)
    jm = JManager({}, cfg, data=jdata,
                  exp_cfg={"policy": {"batch_size": BATCH}})
    batch = next(jm.train_batcher(seed=0).epoch(shuffle=False))
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.jit(lambda b, c: jsteps.init_params(jm.model, b, c, seed=0))(
        batch, jm.contents.columns)
    tm = Manager(model_cfg=cfg, data=tdata, device="cpu",
                 exp_cfg={"policy": {"batch_size": BATCH}})
    tm.model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tm.model))
    return jm, tm, params, batch


@pytest.fixture(scope="module")
def pairs(jdata, tdata):
    """_pair of each YAML, built once for the module: a test that changes
    a Manager's policy restores it, one that trains copies the model."""
    built = {}

    def get(name):
        if name not in built:
            built[name] = _pair(name, jdata, tdata)
        return built[name]

    return get


@pytest.mark.parametrize("name", MODELS)
def test_tester_and_forward_match_jax(name, pairs):
    jm, tm, params, batch = pairs(name)
    ranking = not tm.lego_cfg.use_neg_sampling
    assert batch["candidates"].shape == (BATCH, 1 if ranking else 5)
    assert (tm.cache is None) == (jm.cache is None)
    if name.endswith("_id") or name.startswith("din"):
        assert tm.cache is None
    want = np.asarray(jax.jit(lambda q, b, c: jm.model.apply(
        q, b, c, training=False))(params, batch, jm.contents.columns))
    tbatch = {k: torch.from_numpy(np.array(batch[k]))
              for k in ("candidates", "history", "mask")}
    with torch.no_grad():
        got = tm.model(tbatch, tm.contents.columns).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    jres = JTester(jm, params).test()
    res = Tester(tm).test()
    assert list(res) == list(jres)
    for k in jres:
        assert np.isfinite(res[k])
        assert abs(res[k] - jres[k]) < 1e-5, (k, res[k], jres[k])


@pytest.mark.parametrize("name", ["din_id", "din_text"])
def test_din_pages_as_jax_when_a_phase_is_smaller_than_a_page(
        name, pairs, tdata):
    """An eval batch larger than the test phase: JAX scores the phase in
    one page of its own length (max(8, n)), and so does the port; a page
    padded to the eval batch with row 0 would give DIN's batch norm other
    statistics and other scores."""
    jm, tm, params, _ = pairs(name)
    big = 4 * tdata.inters["test"][tdata.cm.user_col].shape[0]
    saved = jm.policy.get("eval_batch_size"), tm.policy.get("eval_batch_size")
    jm.policy["eval_batch_size"] = tm.policy["eval_batch_size"] = big
    try:
        ev = tm.evaluator()
        assert ev.batch_size == big
        jres = JTester(jm, params).test()
        res = Tester(tm).test()
    finally:
        jm.policy["eval_batch_size"], tm.policy["eval_batch_size"] = saved
    for k in jres:
        assert abs(res[k] - jres[k]) < 1e-5, (k, res[k], jres[k])


def _batches(tm, n, use_neg_sampling, seed=0):
    dp = DeviceTrainPipeline(tm.data, batch_size=BATCH, neg_count=4,
                             use_neg_sampling=use_neg_sampling, seed=seed,
                             device="cpu")
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


@pytest.mark.parametrize("name", list(TRAINED))
def test_adam_trajectory_matches_jax(name, pairs):
    use_neg = TRAINED[name]
    jm, tm, params, _ = pairs(name)
    assert tm.lego_cfg.use_neg_sampling == use_neg
    batches = _batches(tm, 20, use_neg, seed=1)
    if not use_neg:
        b = batches[0][0]
        assert b["candidates"].shape == (BATCH, 1)
        assert b["label"].dtype == torch.float32
        assert set(np.unique(b["label"].numpy())) <= {0.0, 1.0}
    opt = optax.adam(1e-3)
    jstep = jsteps.make_train_step(jm.model, jm.contents.columns, opt,
                                   use_neg)
    jparams = jax.tree_util.tree_map(jnp.array, params)
    opt_state = opt.init(jparams)
    model = copy.deepcopy(tm.model)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    step = steps.make_train_step(model, tm.contents.columns,
                                 steps.adam(model, 1e-3), use_neg)
    for i, (bt, bj) in enumerate(batches):
        jparams, opt_state, want = jstep(jparams, opt_state, bj,
                                         jax.random.PRNGKey(i))
        got = step(bt, torch.Generator().manual_seed(i)).item()
        assert abs(got - float(want)) <= 1e-5 * abs(float(want)), (i, got,
                                                                    want)
    final = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                            model)
    moved = 0
    for pname, t in model.named_parameters():
        np.testing.assert_allclose(t.detach().numpy(), final[pname].numpy(),
                                   rtol=0, atol=1e-4, err_msg=pname)
        moved += not torch.equal(t.detach(), start[pname])
    assert moved >= 5


@pytest.mark.parametrize("name", MODELS)
def test_fused_step_and_trainer_run_the_yaml(name, tdata):
    cfg = model_cfg(name)
    tm = Manager(model_cfg=cfg, data=tdata, device="cpu",
                 exp_cfg={"policy": {"batch_size": BATCH, "epoch": 1,
                                     "epoch_batch": 3}})
    cfg_l = tm.lego_cfg
    dp = DeviceTrainPipeline(tdata, batch_size=BATCH,
                             neg_count=cfg_l.neg_count,
                             use_neg_sampling=cfg_l.use_neg_sampling,
                             seed=0, device="cpu")
    step = dp.make_fused_train_step(tm.model, tm.contents.columns,
                                    steps.adam(tm.model, 1e-3), seed=0)
    idx = next(dp.epoch_indices())
    losses = [step(idx, i).item() for i in range(2)]
    assert all(np.isfinite(losses))

    tr = Trainer(tm, seed=0)
    out = tr.train()
    assert tr.global_step == 3
    assert np.isfinite(out["best_dev"])
    res = tr.test()
    assert all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in res.values())


def test_id_only_model_builds_no_cache(tdata):
    tm = Manager(model_cfg=model_cfg("dnn_id"), data=tdata, device="cpu")
    m = tm.model
    assert m.item_op is None and m.item_inputer is None
    assert not m.use_item_content and m.item_id_vocab == "item_id"
    assert tm.cache is None
    assert m.catalog_plans is None and m.catalog_history_plan is None
    table = m.eh.tables["vocab__item_id"]
    assert tuple(table.shape) == (tdata.num_items, 16)


@pytest.mark.parametrize("name,use_neg", [("din_text", True),
                                          ("din_id", True),
                                          ("miner_id", False)])
def test_incompatible_mode_raises(name, use_neg, tdata):
    cfg = model_cfg(name)
    cfg["config"]["use_neg_sampling"] = use_neg
    with pytest.raises(ValueError, match="does not support"):
        Manager(model_cfg=cfg, data=tdata, device="cpu")


def test_chip_smoke_ctr_models_and_pools_are_the_yamls():
    """chip_smoke.py's phase 8 runs these 24 YAMLs, and the pool widths
    it holds the kernel at (CTR_POOLS: L 50, D 64, H 256 over a step's
    users and a test page's, H 64 over a step's users) are the ones every
    id model's user pool and bst_text's user Transformer get at their
    defaults and chip_smoke's history length; the _text models pool
    nothing but bst_text's user Transformer."""
    import sys
    from unittest import mock

    sys.path.insert(0, ROOT)
    import chip_smoke
    from legommenders_tpu_torch.models.common import AdditiveAttention

    assert chip_smoke.CTR_MODELS == MODELS
    step = chip_smoke.TRAIN_BATCH
    assert sorted(chip_smoke.CTR_POOLS.values()) == [
        (step, 64), (step, 256), (4 * step, 256)]
    kw = dict(chip_smoke.DATA_KW, num_items=200, num_users=12,
              vocab_size=300, inters_per_user=4)
    data = SyntheticProcessor(**kw).as_lego_data()
    forward = AdditiveAttention.forward
    seen = {}

    def spy(self, inputs, mask=None):
        seen.setdefault(name, set()).add(
            (inputs.shape[-2], inputs.shape[-1], self.proj_kernel.shape[1]))
        return forward(self, inputs, mask)

    with mock.patch.object(AdditiveAttention, "forward", spy), \
            torch.no_grad():
        for name in MODELS:
            cfg = parser.parse_four_way(
                {"model": name}, config_root=os.path.join(ROOT, "config")
            ).raw()["model"]
            tm = Manager(model_cfg=cfg, data=data, device="cpu")
            ev = tm.evaluator()
            ev.score_phase_device_full("test")
    ada = {n for n in MODELS if n.endswith("_id")} - {"din_id", "miner_id"}
    assert {n for n, shapes in seen.items()
            if shapes == {(50, 64, 256)}} == ada
    assert set(seen) == ada | {"bst_text"}
    assert seen["bst_text"] == {(50, 64, 64)}
