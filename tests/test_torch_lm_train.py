"""Training in the port vs the JAX package: bert-naml in layer-split mode
and NAML, on bridged weights.

bert-naml: a Bert item operator of 2 layers (D = 32, 2 heads) split at
tune_from = 1, LoRA r 4 folded on the upper layer with a non-zero lora_B
(so dL/dA is not trivially 0), fused attention, tanh gelu, dropout_reuse,
[CLS] title [SEP] category [SEP] compacted (L = 12, padded to 16 on the
device); Ada user operator; Dot. NAML: CNN / Ada / Dot, hidden 16. Both at
f32 and dropout 0, over 60-item synthetic catalogs, batches of 8 with 4
negatives assembled by the port's DeviceTrainPipeline on the CPU and fed,
as the same explicit batches, to both frameworks (their histories are the
exact rows of the history matrix, which JAX's training path reads by
user id). Checked:
  * the lower slice's cache against JAX `build_lm_hidden` (1e-5), and the
    port's disk round trip;
  * the gradient of every trainable tensor against `jax.grad` of JAX's
    loss (1e-4 of the tensor's largest gradient; frozen and unused tensors
    get none in the port and exactly 0 in JAX), on both branches of
    `__call__` (catalog and per-occurrence);
  * 20 Adam steps (lr 1e-3) against JAX's `make_train_step` with
    optax.adam: every loss within 1e-5 relative, every parameter within
    1e-4 at the end;
  * paging with `full` remat against no paging (1e-5), and, with dropout
    0.1, the checkpoint-recompute case: a paged `full` pass and a paged
    `none` pass from one step seed give the same gradients;
  * SharedBitsDropout's keep rate, scale and site independence, and the
    negative sampler's properties.
"""
import copy
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from legommenders_tpu.data.processors.synthetic import (
    SyntheticProcessor as JSynthetic,
)
from legommenders_tpu.runtime import lm_cache as jlm_cache
from legommenders_tpu.runtime import steps as jsteps
from legommenders_tpu.runtime.manager import Manager as JManager
from legommenders_tpu_torch.bridge import params_from_jax
from legommenders_tpu_torch.data.device_pipeline import DeviceTrainPipeline
from legommenders_tpu_torch.data.processors.synthetic import SyntheticProcessor
from legommenders_tpu_torch.models.lm.layers import SharedBitsDropout
from legommenders_tpu_torch.models.operators.lm_ops import (
    LM_HIDDEN_KEY, LM_MASK_KEY,
)
from legommenders_tpu_torch.runtime import lm_cache, steps
from legommenders_tpu_torch.runtime.manager import Manager

DATA_KW = dict(num_items=60, num_users=30, title_len=8, history_len=6,
               vocab_size=200, inters_per_user=6)
BATCH = 8


def bert_cfg(dropout=0.0, **config):
    return {
        "meta": {"item": "Bert", "user": "Ada", "predictor": "Dot"},
        "config": {
            "use_item_content": True, "hidden_size": 16,
            "embedding_dim": 32, "cache_page_size": 32, "neg_count": 4,
            **config,
            "item_config": {
                "lm_dtype": "f32", "num_hidden_layers": 2,
                "num_attention_heads": 2, "max_position": 64, "tune_from": 1,
                "use_lora": True, "lora_r": 4, "lora_dropout": 0.0,
                "lora_fold": True, "fused_attention": True,
                "gelu_approximate": True, "dropout_reuse": True,
                "dropout": dropout, "additive_hidden_size": 32,
                "inputer_config": {"use_cls_token": True,
                                   "use_sep_token": True, "compact": True}},
            "user_config": {"additive_hidden_size": 32}},
    }


NAML_CFG = {
    "meta": {"item": "CNN", "user": "Ada", "predictor": "Dot"},
    "config": {"use_item_content": True, "hidden_size": 16, "neg_count": 4,
               "item_config": {"dropout": 0.0, "kernel_size": 3,
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


def _nonzero_lora(tree, rng):
    return {k: (_nonzero_lora(v, rng) if isinstance(v, dict) else
                (rng.normal(0, 0.05, np.shape(v)).astype(np.float32)
                 if k == "lora_B" else np.asarray(v)))
            for k, v in tree.items()}


def _batches(tm, n, seed=0):
    """n explicit batches from the port's pipeline on the CPU: (torch
    batch, the same batch as jnp arrays)."""
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


def _build(cfg, tmp, lm: bool):
    jm = JManager({}, cfg, data=JSynthetic(**DATA_KW).as_lego_data(),
                  exp_cfg={"policy": {"batch_size": BATCH}})
    batch = next(jm.train_batcher(seed=0).epoch(shuffle=False))
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.jit(lambda b, c: jsteps.init_params(jm.model, b, c, seed=0))(
        batch, jm.contents.columns)
    tree = _nonzero_lora(jax.tree_util.tree_map(np.asarray, params),
                         np.random.default_rng(0))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    tm = Manager(model_cfg=cfg, data=SyntheticProcessor(**DATA_KW)
                 .as_lego_data(), device="cpu")
    tm.model.load_state_dict(params_from_jax(tree, tm.model))
    out = dict(jm=jm, tm=tm, params=params, tree=tree)
    if lm:
        op = jm.model.item_op
        out["j_hidden"] = jlm_cache.build_lm_hidden(
            jm.model, params, dict(jm.contents.columns), page_size=32)
        jm.contents.columns.update(jlm_cache.load_or_build_lm_cache(
            jm.model, params, dict(jm.contents.columns), jm.data.name,
            op.transformer_key, op.resolved_tune_from, page_size=32,
            root=str(tmp)))
        assert tm.prepare_lm_cache(root=str(tmp))
    return out


@pytest.fixture(scope="module")
def bert(tmp_path_factory):
    return _build(bert_cfg(), tmp_path_factory.mktemp("cache"), lm=True)


@pytest.fixture(scope="module")
def naml(tmp_path_factory):
    return _build(NAML_CFG, None, lm=False)


def test_lm_cache_matches_jax(bert, tmp_path):
    tm = bert["tm"]
    want_h, want_m = bert["j_hidden"]
    contents = {c: a for c, a in tm.contents.columns.items()
                if c not in (LM_HIDDEN_KEY, LM_MASK_KEY)}
    got_h, got_m = lm_cache.build_lm_hidden(tm.model, contents, page_size=32)
    assert got_h.shape == want_h.shape == (60, 12, 32)
    np.testing.assert_array_equal(got_m.numpy(), want_m)
    np.testing.assert_allclose(got_h.numpy(), want_h, rtol=1e-5, atol=1e-5)
    # on the device: L padded to 16 with mask 0, as in JAX
    dev, jdev = tm.contents.columns, bert["jm"].contents.columns
    for key in (LM_HIDDEN_KEY, LM_MASK_KEY):
        assert tuple(dev[key].shape) == tuple(jdev[key].shape)
    np.testing.assert_array_equal(dev[LM_MASK_KEY].numpy(),
                                  np.asarray(jdev[LM_MASK_KEY]))
    np.testing.assert_allclose(dev[LM_HIDDEN_KEY].numpy(),
                               np.asarray(jdev[LM_HIDDEN_KEY]), rtol=1e-5,
                               atol=1e-5)
    # the disk round trip: written once, read back as written
    args = (tm.model, contents, "d", "bert", 1, 32, str(tmp_path))
    first = lm_cache.load_or_build_lm_cache(*args)
    assert sorted(p.name.split(".")[0] for p in (tmp_path / "d" / "bert")
                  .iterdir()) == ["torch_layer_1", "torch_mask"]
    again = lm_cache.load_or_build_lm_cache(*args)
    for key in first:
        assert torch.equal(first[key], again[key])


def test_lm_cache_on_disk_is_keyed_by_the_catalogs_size(bert, tmp_path):
    """Two catalogs of another size under one data name and the same
    weights build a cache each: the first one's file is not read for the
    second."""
    tm = bert["tm"]
    contents = {c: a for c, a in tm.contents.columns.items()
                if c not in (LM_HIDDEN_KEY, LM_MASK_KEY)}
    part = {c: a[:17] for c, a in contents.items()}
    whole = lm_cache.load_or_build_lm_cache(
        tm.model, contents, "d", "bert", 1, 32, str(tmp_path))
    cut = lm_cache.load_or_build_lm_cache(
        tm.model, part, "d", "bert", 1, 32, str(tmp_path))
    assert whole[LM_HIDDEN_KEY].shape[0] == 60
    assert cut[LM_HIDDEN_KEY].shape[0] == 17
    torch.testing.assert_close(cut[LM_HIDDEN_KEY],
                               whole[LM_HIDDEN_KEY][:17])
    assert len(list((tmp_path / "d" / "bert").iterdir())) == 4


def test_layer_split_modules_and_bridge(bert):
    model = bert["tm"].model
    op = model.item_op
    assert op.use_lm_cache and op.resolved_tune_from == 1
    assert [n for n, _ in op.lm.named_children()] == ["layer_1"]
    assert {"layer_0", "embeddings_norm"} <= {
        n for n, _ in op.lm_lower.named_children()}
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    assert "item_op.lm.layer_1.attention.query.lora_A" in trainable
    assert "item_op.lm.layer_1.attention.query.weight" not in trainable
    assert not any(n.startswith("item_op.lm_lower.") for n in trainable)
    sd = params_from_jax(bert["tree"], model)
    lower = bert["tree"]["params"]["item_op"]["lm_lower"]
    np.testing.assert_array_equal(
        sd["item_op.lm_lower.layer_0.intermediate.weight"].numpy(),
        lower["layer_0"]["intermediate"]["kernel"].T)


def _grads_vs_jax(pair, jmodel, batch_t, batch_j):
    tm, params = pair["tm"], pair["params"]
    jm = pair["jm"]
    loss_fn = jsteps.make_loss_fn(jmodel, jm.contents.columns, True)
    want_loss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(
        params, batch_j, jax.random.PRNGKey(0))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads),
                           tm.model)
    tm.model.zero_grad(set_to_none=True)
    loss = steps.make_loss_fn(tm.model, tm.contents.columns, True)(
        batch_t, torch.Generator().manual_seed(0))
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    n_trainable = 0
    for name, p in tm.model.named_parameters():
        w = want[name].numpy()
        if not p.requires_grad or p.grad is None:
            assert not np.any(w), name       # frozen or unused in JAX too
            continue
        n_trainable += 1
        scale = max(float(np.abs(w).max()), 1e-6)
        err = float(np.abs(p.grad.numpy() - w).max())
        assert err <= 1e-4 * scale, (name, err, scale)
    tm.model.zero_grad(set_to_none=True)
    return n_trainable


@pytest.mark.parametrize("branch", ["catalog", "occurrence"])
def test_bert_gradients_match_jax(bert, branch):
    fce = "on" if branch == "catalog" else "off"
    jmodel = bert["jm"].model.clone(full_catalog_encode=fce)
    model = bert["tm"].model
    model.full_catalog_encode = fce
    try:
        (bt, bj), = _batches(bert["tm"], 1)
        n = _grads_vs_jax(bert, jmodel, bt, bj)
    finally:
        model.full_catalog_encode = "auto"
    # LoRA A/B of query and value, the head's linear + pool, the user pool
    assert n == 4 + 2 + 3 + 3


def test_naml_gradients_match_jax(naml):
    (bt, bj), = _batches(naml["tm"], 1)
    assert _grads_vs_jax(naml, naml["jm"].model, bt, bj) >= 8


@pytest.mark.parametrize("which", ["bert", "naml"])
def test_adam_trajectory_matches_jax(bert, naml, which):
    pair = {"bert": bert, "naml": naml}[which]
    jm, tm = pair["jm"], pair["tm"]
    batches = _batches(tm, 20, seed=1)
    opt = optax.adam(1e-3)
    jstep = jsteps.make_train_step(jm.model, jm.contents.columns, opt, True)
    params = jax.tree_util.tree_map(jnp.array, pair["params"])
    opt_state = opt.init(params)
    model = copy.deepcopy(tm.model)
    step = steps.make_train_step(model, tm.contents.columns,
                                 steps.adam(model, 1e-3))
    for i, (bt, bj) in enumerate(batches):
        params, opt_state, want = jstep(params, opt_state, bj,
                                        jax.random.PRNGKey(i))
        got = step(bt, torch.Generator().manual_seed(i)).item()
        assert abs(got - float(want)) <= 1e-5 * abs(float(want)), (i, got,
                                                                    want)
    final = params_from_jax(jax.tree_util.tree_map(np.asarray, params), model)
    moved = 0
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[name].numpy(),
                                   rtol=0, atol=1e-4, err_msg=name)
        moved += not torch.equal(p.detach(),
                                 tm.model.state_dict()[name])
    assert moved >= 8


def _loss_and_grads(model, contents, batch, seed):
    model.zero_grad(set_to_none=True)
    loss = steps.make_loss_fn(model, contents, True)(
        batch, torch.Generator().manual_seed(seed))
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def test_paged_full_remat_matches_unpaged(bert):
    """Pages of 24 rows (the 60-item catalog in 3 pages, the last one
    re-encoding its tail) under `full` remat give the unpaged loss and
    gradients at dropout 0."""
    tm = bert["tm"]
    (bt, _), = _batches(tm, 1)
    model = copy.deepcopy(tm.model)
    want = _loss_and_grads(model, tm.contents.columns, bt, 0)
    model.item_page_size, model.item_page_remat = 24, "full"
    got = _loss_and_grads(model, tm.contents.columns, bt, 0)
    assert abs(got[0] - want[0]) <= 1e-6
    assert got[1].keys() == want[1].keys()
    for n in want[1]:
        torch.testing.assert_close(got[1][n], want[1][n], rtol=1e-5,
                                   atol=1e-6)


def test_checkpoint_recompute_keeps_dropout_masks(tmp_path):
    """Dropout 0.1 (hidden sites through SharedBitsDropout, attention
    dropout in the packed attention): a paged pass under `full` remat
    recomputes each page in the backward with the masks of its forward,
    so its gradients equal those of the paged pass that keeps every
    activation (`none`), given one step seed; another seed draws other
    masks."""
    tm = Manager(model_cfg=bert_cfg(dropout=0.1, item_page_size=24),
                 data=SyntheticProcessor(**DATA_KW).as_lego_data(),
                 device="cpu", seed=3)
    assert tm.prepare_lm_cache(root=None)
    with torch.no_grad():
        for m in tm.model.modules():
            if hasattr(m, "lora_B"):
                m.lora_B.normal_(0.0, 0.05)
    (bt, _), = _batches(tm, 1)
    model = tm.model
    full = _loss_and_grads(model, tm.contents.columns, bt, 5)
    model.item_page_remat = "none"
    none = _loss_and_grads(model, tm.contents.columns, bt, 5)
    other = _loss_and_grads(model, tm.contents.columns, bt, 6)
    assert full[0] == none[0] and other[0] != none[0]
    for n in none[1]:
        torch.testing.assert_close(full[1][n], none[1][n], rtol=1e-6,
                                   atol=1e-7)


def test_shared_bits_dropout():
    """Keep rate t/256 with t = round(0.9 * 256) = 230, kept values scaled
    by 256/t rounded to the input's dtype; the two sites of one draw keep
    independently; no generator is eval (identity)."""
    x = torch.ones(400, 500)
    drop = SharedBitsDropout(0.1)
    g = torch.Generator().manual_seed(0)
    y0, bits = drop(x, 0, None, g)
    y1, bits1 = drop(x, 1, bits, g)
    assert bits1 is bits
    k0, k1 = y0 != 0, y1 != 0
    n, t = x.numel(), 230
    for k in (k0, k1):
        assert abs(k.float().mean().item() - t / 256) <= 4 * (
            t / 256 * (1 - t / 256) / n) ** 0.5
    assert torch.all(y0[k0] == 256.0 / t)
    both = (k0 & k1).float().mean().item()
    assert abs(both - (t / 256) ** 2) <= 0.004
    yb, _ = drop(x.bfloat16(), 0, bits, g)
    assert torch.all(yb[k0] == torch.tensor(256.0 / t).bfloat16())
    y, none = drop(x, 0, None, None)
    assert y is x and none is None


def test_sample_negatives_properties(naml):
    """Positive at column 0; negatives drawn from the slots of the user's
    own list without replacement while the list has K (a list may hold an
    item twice); the top-up within the item range; deterministic for a
    seed."""
    tm = naml["tm"]
    dp = DeviceTrainPipeline(tm.data, batch_size=BATCH, neg_count=4,
                             device="cpu")
    negs = tm.data.neg_matrix()
    idx = torch.arange(dp.n)
    b = dp.assemble(idx, torch.Generator().manual_seed(0))
    again = dp.assemble(idx, torch.Generator().manual_seed(0))
    assert all(torch.equal(b[k], again[k]) for k in b)
    cands, users = b["candidates"].numpy(), b["user_id"].numpy()
    np.testing.assert_array_equal(cands[:, 0], dp.item_ids.numpy())
    assert cands.min() >= 0 and cands.max() < tm.data.num_items
    full = 0
    for row, u in zip(cands[:, 1:], users):
        valid = [x for x in negs[u] if x >= 0]
        if len(valid) >= 4:
            full += 1
            assert Counter(row.tolist()) <= Counter(valid)
        else:
            assert Counter(row[:len(valid)].tolist()) == Counter(valid)
    assert full > 0
    np.testing.assert_array_equal(
        b["history"].numpy(),
        np.where(tm.data.history_matrix()[users] < 0, 0,
                 tm.data.history_matrix()[users]))


def test_pipeline_requires_cuda_unless_cpu(naml, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceTrainPipeline(naml["tm"].data, batch_size=BATCH)


@pytest.mark.parametrize("loss", ["neg_sampling", "ranking"])
def test_losses_match_jax(loss):
    """Both losses against the JAX package's on the same scores (1e-6)."""
    rng = np.random.default_rng(3)
    if loss == "neg_sampling":
        scores = rng.normal(0, 3, (BATCH, 5)).astype(np.float32)
        got = steps.neg_sampling_loss(torch.from_numpy(scores))
        want = jsteps.neg_sampling_loss(jnp.asarray(scores))
    else:
        scores = rng.normal(0, 3, (BATCH, 1)).astype(np.float32)
        labels = rng.integers(0, 2, BATCH).astype(np.float32)
        got = steps.ranking_loss(torch.from_numpy(scores),
                                 torch.from_numpy(labels))
        want = jsteps.ranking_loss(jnp.asarray(scores), jnp.asarray(labels))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_pointwise_pipeline_keeps_every_row(naml):
    """Without negative sampling every interaction row is a sample, with
    its own item as the one candidate and its own label."""
    data = naml["tm"].data
    dp = DeviceTrainPipeline(data, batch_size=BATCH, use_neg_sampling=False,
                             device="cpu")
    store = data.inters["train"]
    assert dp.n == len(store[data.cm.label_col])
    b = dp.assemble(torch.arange(dp.n), torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(b["candidates"].numpy()[:, 0],
                                  store[data.cm.item_col])
    np.testing.assert_array_equal(b["label"].numpy(),
                                  store[data.cm.label_col])
    assert b["candidates"].shape == (dp.n, 1)
