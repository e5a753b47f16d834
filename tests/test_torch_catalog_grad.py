"""The port's catalog gradient plans (ops/catalog_grad.py) vs the scatter
path and vs the JAX package's plans, on the CPU.

  * CatalogGradPlan.take: forward bit-identical to the plain lookup;
    gradient equal to `F.embedding`'s backward (quarter-integer cotangents,
    whose sums are exact in f32: within 1e-6) and to JAX's plan's gradient
    on the same ids and cotangent (1e-6); with random cotangents within
    1e-5 of the largest value;
  * HistoryGradPlan.take: forward bit-identical to the plain gather of
    H_safe[user_id]; gradient equal to advanced indexing's backward and to
    JAX's history plan (1e-6);
  * matches_source: the same tensor, a copy, a swapped column, a written
    tensor; the content of a tensor is hashed once;
  * the model: NAML (hidden 16, 80 items) with its plans built by
    LegoConfig; the plans live (`last_trace`) on the fused training step;
    the history plan only on a training forward (a generator given) whose
    batch has `user_id`; gradients with the plans within 1e-5 of each
    tensor's largest value of the same model without them (catalog_plans
    and catalog_history_plan None) and within 1e-4 of JAX's (whose plans
    are live too); a swapped column falls back to the plain lookup with a
    warning; a paged encode never uses them; a copied model shares them.
    The additive pools' `proj_bias` gradients are zero to first order: the
    softmax backward's weights sum to zero over the positions and tanh' is
    ~1 near the init, so what is left is the rounding residue of
    cancelling terms (1.7e-8 here, against 1e-2 for the other tensors),
    and the plans' other order of f32 sums moves it by 2e-13. A bias is
    held at the same relative tolerance of the larger of its own largest
    value and its layer's weight's (a pool's `proj_kernel`), whose
    gradient sums the same cotangents.
"""
import copy
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn import functional as F

from legommenders_tpu.data.processors.synthetic import (
    SyntheticProcessor as JSynthetic,
)
from legommenders_tpu.ops import catalog_grad as jcatalog_grad
from legommenders_tpu.runtime import steps as jsteps
from legommenders_tpu.runtime.manager import Manager as JManager
from legommenders_tpu_torch.bridge import params_from_jax
from legommenders_tpu_torch.data.device_pipeline import DeviceTrainPipeline
from legommenders_tpu_torch.data.processors.synthetic import SyntheticProcessor
from legommenders_tpu_torch.data.token_store import UNSET
from legommenders_tpu_torch.ops import catalog_grad
from legommenders_tpu_torch.ops.catalog_grad import (
    CatalogGradPlan, HistoryGradPlan,
)
from legommenders_tpu_torch.runtime import steps
from legommenders_tpu_torch.runtime.manager import Manager

DATA_KW = dict(num_items=80, num_users=40, title_len=8, history_len=6,
               vocab_size=200, inters_per_user=8)
BATCH = 8
NAML_CFG = {
    "meta": {"item": "CNN", "user": "Ada", "predictor": "Dot"},
    "config": {"use_item_content": True, "hidden_size": 16, "neg_count": 4,
               "full_catalog_encode": "on",
               "item_config": {"dropout": 0.0, "kernel_size": 3,
                               "additive_hidden_size": 32},
               "user_config": {"additive_hidden_size": 32}},
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ids(shape, vocab, seed):
    """Token ids with UNSET padding and one heavily repeated id."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=shape).astype(np.int32)
    ids[ids % 7 == 3] = UNSET
    ids[ids % 5 == 4] = 1
    return ids


def _plain_take(table, ids, num_rows):
    return F.embedding(torch.as_tensor(ids).long().clamp(0, num_rows - 1),
                       table)


@pytest.mark.parametrize("fanout", [2, 8])
@pytest.mark.parametrize("shape,vocab", [((40, 7), 23), ((3, 5), 50),
                                         ((128, 12), 9)])
def test_plan_matches_scatter_and_jax(shape, vocab, fanout):
    ids = _ids(shape, vocab, 0)
    rng = np.random.default_rng(1)
    D = 16
    table_np = rng.normal(size=(vocab, D)).astype(np.float32)
    cot_np = rng.integers(-8, 8, size=(*shape, D)).astype(np.float32) * 0.25
    plan = CatalogGradPlan(torch.as_tensor(ids), vocab, fanout=fanout)

    table = torch.tensor(table_np, requires_grad=True)
    out = plan.take(table)
    assert torch.equal(out, _plain_take(table, ids, vocab))
    (out * torch.as_tensor(cot_np)).sum().backward()
    got = table.grad.clone()

    table.grad = None
    (_plain_take(table, ids, vocab) * torch.as_tensor(cot_np)).sum().backward()
    np.testing.assert_allclose(got.numpy(), table.grad.numpy(),
                               rtol=0, atol=1e-6)

    jplan = jcatalog_grad.CatalogGradPlan(ids, vocab, fanout=fanout)
    want = jax.grad(lambda t: jnp.vdot(jplan.take(t), jnp.asarray(cot_np)))(
        jnp.asarray(table_np))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    assert [len(lv) // fanout for lv in plan._levels] == [
        len(lv) for lv in jplan._levels]


def test_plan_random_cotangent_within_rounding():
    ids = np.random.default_rng(1).integers(0, 64, size=(200, 9))
    plan = CatalogGradPlan(torch.as_tensor(ids), 64, fanout=4)
    rng = np.random.default_rng(2)
    table = torch.tensor(rng.normal(size=(64, 8)).astype(np.float32),
                         requires_grad=True)
    cot = torch.as_tensor(rng.normal(size=(200, 9, 8)).astype(np.float32))
    (plan.take(table) * cot).sum().backward()
    got = table.grad.clone()
    table.grad = None
    (_plain_take(table, ids, 64) * cot).sum().backward()
    want = table.grad
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_history_plan_matches_gather_and_jax():
    rng = np.random.default_rng(3)
    U, S, N, D, B = 37, 9, 50, 8, 21
    H = rng.integers(0, N, size=(U, S)).astype(np.int32)
    H[rng.random((U, S)) < 0.2] = UNSET
    u = rng.integers(0, U, size=B).astype(np.int32)
    table_np = rng.normal(size=(N, D)).astype(np.float32)
    cot_np = rng.integers(-8, 8, size=(B, S, D)).astype(np.float32) * 0.25
    plan = HistoryGradPlan(H, N)
    safe = torch.as_tensor(np.clip(np.where(H == UNSET, 0, H), 0, N - 1))
    ut = torch.as_tensor(u)

    table = torch.tensor(table_np, requires_grad=True)
    out = plan.take(table, ut)
    assert torch.equal(out, table[safe.long()[ut.long()]])
    (out * torch.as_tensor(cot_np)).sum().backward()
    got = table.grad.clone()
    table.grad = None
    (table[safe.long()[ut.long()]] * torch.as_tensor(cot_np)).sum().backward()
    np.testing.assert_allclose(got.numpy(), table.grad.numpy(), rtol=0,
                               atol=1e-6)

    jplan = jcatalog_grad.HistoryGradPlan(H, N)
    want = jax.grad(lambda t: jnp.vdot(jplan.take(t, jnp.asarray(u)),
                                       jnp.asarray(cot_np)))(
        jnp.asarray(table_np))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    assert plan.matches((B, S), N) and not plan.matches((B, S + 1), N)
    assert not plan.matches((B, S), N + 1)


def test_matches_source_identity_content_and_swaps(monkeypatch):
    ids = torch.arange(24, dtype=torch.int32).reshape(6, 4) % 10
    plan = CatalogGradPlan(ids, num_rows=10)
    hashed = []
    md5 = catalog_grad._ids_md5
    monkeypatch.setattr(catalog_grad, "_ids_md5",
                        lambda a: hashed.append(1) or md5(a))
    assert plan.matches_source(ids) and not hashed   # same tensor: no hash
    copy_ = ids.clone()
    assert plan.matches_source(copy_) and len(hashed) == 1
    assert plan.matches_source(copy_) and len(hashed) == 1   # remembered
    assert plan.matches_source(ids.long()) and len(hashed) == 2
    swapped = ids.clone()
    swapped[0, 0] = (swapped[0, 0] + 1) % 10
    assert not plan.matches_source(swapped)
    assert not plan.matches_source(ids[:4])          # another shape
    copy_[0, 0] = (copy_[0, 0] + 1) % 10             # written in place
    assert not plan.matches_source(copy_)
    ids[0, 0] = (ids[0, 0] + 1) % 10                 # the source itself
    assert not plan.matches_source(ids)
    assert plan == plan and plan != CatalogGradPlan(ids, 10)
    assert copy.deepcopy(plan) is plan


# --------------------------------------------------------------------- #
# the plans in the model                                                #
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def naml():
    jm = JManager({}, NAML_CFG, data=JSynthetic(**DATA_KW).as_lego_data(),
                  exp_cfg={"policy": {"batch_size": BATCH}})
    batch = next(jm.train_batcher(seed=0).epoch(shuffle=False))
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.jit(lambda b, c: jsteps.init_params(jm.model, b, c, seed=0))(
        batch, jm.contents.columns)
    tree = jax.tree_util.tree_map(np.asarray, params)
    tm = Manager(model_cfg=NAML_CFG,
                 data=SyntheticProcessor(**DATA_KW).as_lego_data(),
                 device="cpu")
    tm.model.load_state_dict(params_from_jax(tree, tm.model))
    dp = DeviceTrainPipeline(tm.data, batch_size=BATCH, neg_count=4, seed=0,
                             device="cpu")
    tbatch = dp.assemble(next(dp.epoch_indices(shuffle=False)),
                         torch.Generator().manual_seed(0))
    jbatch = {k: jnp.asarray(v.numpy().astype(
        np.float32 if k == "label" else np.int32)) for k, v in tbatch.items()}
    return dict(jm=jm, tm=tm, params=params, tbatch=tbatch, jbatch=jbatch,
                dp=dp)


def _scale(name, grads):
    """The largest value a gradient is held against: its own, or for a
    bias the larger of its own and its layer's weight's (a pool's
    proj_kernel for its proj_bias; see the module docstring)."""
    ref = name
    if name.endswith("proj_bias"):
        ref = name[:-len("proj_bias")] + "proj_kernel"
    elif name.endswith(".bias"):
        ref = name[:-len("bias")] + "weight"
    return max(grads[name].abs().max(), grads[ref].abs().max())


def _grads(model, contents, batch, rng=True):
    model.zero_grad(set_to_none=True)
    loss = steps.make_loss_fn(model, contents, True)(
        batch, torch.Generator().manual_seed(0) if rng else None)
    loss.backward()
    out = {n: p.grad.clone() for n, p in model.named_parameters()
           if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return loss.item(), out


def test_lego_config_builds_the_plans(naml):
    model, cols = naml["tm"].model, naml["tm"].contents.columns
    assert set(model.catalog_plans) == {"title", "category"}
    for col, plan in model.catalog_plans.items():
        assert plan.source is cols[col]
        assert plan.matches_source(cols[col])
    hp = model.catalog_history_plan
    assert (hp.num_users, hp.seq_len, hp.num_rows) == (40, 6, 80)
    jplans = naml["jm"].model.catalog_plans
    assert set(jplans) == set(model.catalog_plans)
    for col, plan in model.catalog_plans.items():
        assert plan.num_unique == jplans[col].num_unique
        assert plan.ids_shape == jplans[col].ids_shape
    off = Manager(model_cfg={**NAML_CFG, "config": {
        **NAML_CFG["config"], "full_catalog_encode": "off"}},
        data=naml["tm"].data, device="cpu")
    assert off.model.catalog_plans is None
    assert off.model.catalog_history_plan is None


def test_plans_live_on_the_fused_step(naml):
    tm, dp = naml["tm"], naml["dp"]
    model = copy.deepcopy(tm.model)
    assert model.catalog_plans["title"] is tm.model.catalog_plans["title"]
    catalog_grad.record_trace((), ())
    catalog_grad.record_history(False)
    step = dp.make_fused_train_step(model, tm.contents.columns,
                                    steps.adam(model, 1e-3))
    assert np.isfinite(step(next(dp.epoch_indices()), 0).item())
    assert set(catalog_grad.last_trace["live"]) == {"title", "category"}
    assert catalog_grad.last_trace["dead"] == ()
    assert catalog_grad.last_trace["history"]


def test_history_plan_gate(naml):
    tm, batch = naml["tm"], naml["tbatch"]
    model, cols = tm.model, tm.contents.columns
    with torch.no_grad():
        model(batch, cols, torch.Generator().manual_seed(0))
        assert catalog_grad.last_trace["history"]
        model(batch, cols)                               # eval
        assert not catalog_grad.last_trace["history"]
        no_uid = {k: v for k, v in batch.items() if k != "user_id"}
        model(no_uid, cols, torch.Generator().manual_seed(0))
        assert not catalog_grad.last_trace["history"]


def test_gradients_with_plans_match_plain_and_jax(naml):
    tm, batch = naml["tm"], naml["tbatch"]
    model, cols = tm.model, tm.contents.columns
    loss, got = _grads(model, cols, batch)
    assert set(catalog_grad.last_trace["live"]) == {"title", "category"}
    assert catalog_grad.last_trace["history"]
    plans = model.catalog_plans, model.catalog_history_plan
    model.catalog_plans = model.catalog_history_plan = None
    try:
        plain_loss, plain = _grads(model, cols, batch)
    finally:
        model.catalog_plans, model.catalog_history_plan = plans
    assert loss == plain_loss
    assert got.keys() == plain.keys() and len(got) >= 8
    for name, g in got.items():
        w = plain[name]
        assert (g - w).abs().max() <= 1e-5 * _scale(name, plain), name

    jm = naml["jm"]
    loss_fn = jsteps.make_loss_fn(jm.model, jm.contents.columns, True)
    jcatalog_grad.record_trace((), ())
    want_loss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(
        naml["params"], naml["jbatch"], jax.random.PRNGKey(0))
    assert set(jcatalog_grad.last_trace["live"]) == {"title", "category"}
    assert jcatalog_grad.last_trace["history"]
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), model)
    assert abs(loss - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    for name, g in got.items():
        w = want[name]
        assert (g - w).abs().max() <= 1e-4 * _scale(name, want), name


def test_swapped_column_falls_back_with_a_warning(naml, caplog):
    tm, batch = naml["tm"], naml["tbatch"]
    model = copy.deepcopy(tm.model)
    cols = dict(tm.contents.columns)
    swapped = cols["title"].clone()
    swapped[0, 0] = (swapped[0, 0] + 1) % 5
    cols["title"] = swapped
    with caplog.at_level(logging.WARNING, logger="legommenders_tpu_torch"):
        loss, got = _grads(model, cols, batch)
    assert catalog_grad.last_trace["live"] == ("category",)
    assert catalog_grad.last_trace["dead"] == ("title",)
    assert "INACTIVE for columns ['title']" in caplog.text
    model.catalog_plans = None
    plain_loss, plain = _grads(model, cols, batch)
    assert loss == plain_loss
    for name, g in got.items():
        w = plain[name]
        assert (g - w).abs().max() <= 1e-5 * _scale(name, plain), name


def test_paged_encode_takes_no_plans(naml):
    tm, batch = naml["tm"], naml["tbatch"]
    model = copy.deepcopy(tm.model)
    model.item_page_size = 32
    catalog_grad.record_trace(("sentinel",), ())
    loss, got = _grads(model, tm.contents.columns, batch)
    assert catalog_grad.last_trace["live"] == ("sentinel",)
    model.item_page_size = 0
    want_loss, want = _grads(model, tm.contents.columns, batch)
    assert abs(loss - want_loss) <= 1e-6 * abs(want_loss)
    for name, g in got.items():
        assert (g - want[name]).abs().max() <= 1e-5 * _scale(name, want), name
