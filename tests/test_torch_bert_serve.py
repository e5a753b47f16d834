"""bert-naml serving in the port vs the JAX package, on bridged weights.

A tiny bert-naml (BertBase item operator cut to 2 layers, D = 32, 2 heads;
Ada user operator; Dot), full-LM mode with the item-bert.yaml knobs
(LoRA folded, fused packed attention, tanh gelu, [CLS] title [SEP]
category [SEP] compacted), over 200 synthetic items with titles of up to
8 tokens (L = 12, so 10 items share an attention call) and cache pages of
64 rows. JAX Manager + init_params -> non-zero LoRA B -> numpy ->
`params_from_jax` -> the port's Manager(device="cpu") + Tester.test().
At lm_dtype f32 the repr caches and cached scores must agree within 1e-4
and the metrics within 1e-5; at lm_dtype bf16 (the card's dtype) the
reprs within 2e-2 of the largest repr, since the two frameworks round
the bf16 products and elementwise steps at different points. The
ConcatInputer must agree exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legommenders_tpu.data.processors.synthetic import (
    SyntheticProcessor as JSynthetic,
)
from legommenders_tpu.models.inputers.concat import (
    ConcatInputer as JConcatInputer,
)
from legommenders_tpu.runtime.manager import Manager as JManager
from legommenders_tpu.runtime.steps import init_params
from legommenders_tpu.runtime.tester import Tester as JTester
from legommenders_tpu_torch.bridge import params_from_jax
from legommenders_tpu_torch.data.processors.synthetic import SyntheticProcessor
from legommenders_tpu_torch.models.inputers.concat import ConcatInputer
from legommenders_tpu_torch.models.operators.lm_ops import BertBaseOperator
from legommenders_tpu_torch.runtime import tester
from legommenders_tpu_torch.runtime.manager import Manager

DATA_KW = dict(num_items=200, num_users=60, title_len=8, history_len=10,
               vocab_size=500, inters_per_user=6)


def model_cfg(lm_dtype: str) -> dict:
    return {
        "meta": {"item": "BertBase", "user": "Ada", "predictor": "Dot"},
        "config": {
            "use_item_content": True, "hidden_size": 16,
            "embedding_dim": 32, "cache_page_size": 64,
            "item_config": {
                "lm_dtype": lm_dtype, "num_hidden_layers": 2,
                "num_attention_heads": 2, "max_position": 64,
                "use_lora": True, "lora_r": 4, "lora_dropout": 0.0,
                "lora_fold": True, "fused_attention": True,
                "gelu_approximate": True, "dropout_reuse": True,
                "additive_hidden_size": 32,
                "inputer_config": {"use_cls_token": True,
                                   "use_sep_token": True, "compact": True}},
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


def _pair(lm_dtype: str):
    cfg = model_cfg(lm_dtype)
    jm = JManager({}, cfg, data=JSynthetic(**DATA_KW).as_lego_data(),
                  exp_cfg={"policy": {"batch_size": 8}})
    batch = next(jm.train_batcher(seed=0).epoch(shuffle=False))
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.jit(lambda b, c: init_params(jm.model, b, c, seed=0))(
        batch, jm.contents.columns)
    tree = _nonzero_lora(jax.tree_util.tree_map(np.asarray, params),
                         np.random.default_rng(0))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    tm = Manager(model_cfg=cfg,
                 data=SyntheticProcessor(**DATA_KW).as_lego_data(),
                 device="cpu")
    tm.model.load_state_dict(params_from_jax(tree, tm.model))
    jev = jm.evaluator()
    want = JTester(jm, params).test()     # builds the JAX caches
    got = tester.Tester(tm).test()        # builds the port's caches
    return dict(jm=jm, tm=tm, params=params, tree=tree, jev=jev,
                want=want, got=got)


@pytest.fixture(scope="module")
def pair():
    return _pair("f32")


def test_model_is_bert_naml(pair):
    model = pair["tm"].model
    assert isinstance(model.item_op, BertBaseOperator)
    assert isinstance(model.item_inputer, ConcatInputer)
    assert tuple(model.item_inputer.special_tokens.shape) == (2, 32)
    assert "item_inputer.special_tokens" in model.state_dict()
    # the init's LoRA B is replaced by non-zero values in both frameworks
    lora_b = model.item_op.lm.layer_1.attention.value.lora_B
    assert lora_b.abs().max() > 0


def test_repr_caches_match_jax(pair):
    jm, tm = pair["jm"], pair["tm"]
    item = tm.cache.item_repr.numpy()
    user = tm.cache.user_repr.numpy()
    assert item.shape == (200, 16) and user.shape == (60, 16)
    np.testing.assert_allclose(item, np.asarray(jm.cache.item_repr),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(user, np.asarray(jm.cache.user_repr),
                               rtol=1e-4, atol=1e-4)


def test_cached_scores_match_jax(pair):
    want = pair["jev"].score_phase_device(pair["params"], "test")
    got = pair["tm"].evaluator().score_phase_device("test").numpy()
    assert got.shape == want.shape == (60 * 6,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_tester_metrics_match_jax(pair):
    want, got = pair["want"], pair["got"]
    assert list(got) == list(want) == ["GAUC", "MRR", "NDCG@1", "NDCG@5",
                                       "NDCG@10"]
    for k in want:
        assert np.isfinite(got[k])
        assert abs(got[k] - want[k]) < 1e-5, (k, got[k], want[k])


def test_bf16_reprs_match_jax():
    p = _pair("bf16")
    jm, tm = p["jm"], p["tm"]
    assert tm.model.item_op.lm.dtype == torch.bfloat16
    for got, want in ((tm.cache.item_repr, jm.cache.item_repr),
                      (tm.cache.user_repr, jm.cache.user_repr)):
        want = np.asarray(want, np.float32)
        got = got.float().numpy()
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    for k, v in p["want"].items():
        assert abs(p["got"][k] - v) < 5e-2, (k, p["got"][k], v)


class _Tables:
    """A stand-in embedding hub: one table per vocab, ids clipped into it,
    as both frameworks' EmbeddingTables look tokens up."""

    def __init__(self, tables, lib):
        self.tables, self.lib = tables, lib

    def dim_of(self, vocab, col=None):
        return self.tables[vocab].shape[1]

    def embed(self, ids, vocab, col=None, training=False):
        t = self.tables[vocab]
        if self.lib == "jax":
            return jnp.take(jnp.asarray(t), jnp.clip(ids, 0, len(t) - 1),
                            axis=0)
        return torch.from_numpy(t)[ids.clamp(0, len(t) - 1)]


@pytest.mark.parametrize("cls,sep,compact", [(True, True, True),
                                             (True, False, False),
                                             (False, True, True),
                                             (False, False, True)])
def test_concat_inputer_matches_jax(cls, sep, compact):
    """Exact: the same lookups, special tokens and stable compaction; titles
    of 2..8 tokens (UNSET-padded) and a length-1 category column."""
    rng = np.random.default_rng(21)
    N, D = 9, 8
    lens = rng.integers(2, 9, N)
    title = np.where(np.arange(8)[None] < lens[:, None],
                     rng.integers(0, 50, (N, 8)), -1).astype(np.int32)
    category = rng.integers(0, 5, (N, 1)).astype(np.int32)
    tables = {"word": rng.standard_normal((50, D)).astype(np.float32),
              "cat": rng.standard_normal((5, D)).astype(np.float32)}
    cols = (("title", "word", 8), ("category", "cat", 1))
    flags = dict(use_cls_token=cls, use_sep_token=sep, compact=compact)

    jmod = JConcatInputer(cols=cols, **flags)
    jcontents = {"title": jnp.asarray(title),
                 "category": jnp.asarray(category)}
    jeh = _Tables(tables, "jax")
    tree = jax.tree_util.tree_map(np.asarray, jmod.init(
        jax.random.PRNGKey(0), jeh, jcontents, method=jmod.get_embeddings))
    want_emb, want_mask = jmod.apply(tree, jeh, jcontents,
                                     method=jmod.get_embeddings)

    tmod = ConcatInputer(cols=cols, dim=D, **flags)
    if cls or sep:
        tmod.load_state_dict(params_from_jax(tree, tmod))
    got_emb, got_mask = tmod.get_embeddings(
        _Tables(tables, "torch"),
        {"title": torch.from_numpy(title),
         "category": torch.from_numpy(category)})
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    np.testing.assert_array_equal(got_emb.detach().numpy(),
                                  np.asarray(want_emb))


def test_bridge_places_bert_names_and_rejects_strays(pair):
    tm, tree = pair["tm"], pair["tree"]
    sd = params_from_jax(tree, tm.model)
    lm = tree["params"]["item_op"]["lm"]
    np.testing.assert_array_equal(
        sd["item_op.lm.layer_0.attention.query.lora_A"].numpy(),
        lm["layer_0"]["attention"]["query"]["lora_A"].T)
    np.testing.assert_array_equal(
        sd["item_op.lm.embeddings_norm.weight"].numpy(),
        lm["embeddings_norm"]["scale"])

    def with_lm(**extra):
        return {"params": {**tree["params"], "item_op": {
            **tree["params"]["item_op"], "lm": {**lm, **extra}}}}

    stray_rule = with_lm(stray_norm={"gamma": np.zeros(32, np.float32)})
    with pytest.raises(KeyError, match="no rule"):
        params_from_jax(stray_rule, tm.model)
    key_lora = dict(lm["layer_0"]["attention"]["key"],
                    lora_A=np.zeros((32, 4), np.float32))
    stray_lora = with_lm(layer_0={**lm["layer_0"], "attention": {
        **lm["layer_0"]["attention"], "key": key_lora}})
    with pytest.raises(KeyError, match="does not have"):
        params_from_jax(stray_lora, tm.model)
    no_special = {"params": {k: v for k, v in tree["params"].items()
                             if k != "item_inputer"}}
    with pytest.raises(KeyError, match="item_inputer.special_tokens"):
        params_from_jax(no_special, tm.model)
    value = {k: v for k, v in lm["layer_1"]["attention"]["value"].items()
             if k != "lora_B"}
    no_lora_b = with_lm(layer_1={**lm["layer_1"], "attention": {
        **lm["layer_1"]["attention"], "value": value}})
    with pytest.raises(KeyError, match="left unset"):
        params_from_jax(no_lora_b, tm.model)


def test_unported_modes_raise():
    """The `ffn`/`dots` page remat policies build since the LM knobs were
    ported (their parity: tests/test_torch_lm_knobs.py); on the Llama
    family (ported: tests/test_torch_decoder_models.py) `pipeline_stages`
    builds since pp was ported (tests/test_torch_pp.py), and a stack
    that does not divide into the stages raises when it runs staged, as
    JAX's assert does.
    (Layer-split mode, `tune_from`, is ported:
    tests/test_torch_lm_train.py.)"""
    op = BertBaseOperator(hidden_size=8, input_dim=16, num_hidden_layers=2,
                          num_attention_heads=2, tune_from=1)
    assert op.use_lm_cache and op.resolved_tune_from == 1
    data = SyntheticProcessor(**dict(DATA_KW, num_items=30,
                                     num_users=10)).as_lego_data()
    for policy in ("ffn", "dots"):
        cfg = model_cfg("f32")
        cfg["config"]["item_page_remat"] = policy
        tm = Manager(model_cfg=cfg, data=data, device="cpu")
        assert tm.model.item_page_remat == policy
    cfg = model_cfg("f32")
    cfg["meta"]["item"] = "Llama"
    del cfg["config"]["item_config"]["dropout_reuse"]   # BERT/OPT only
    cfg["config"]["item_config"]["pipeline_stages"] = 2
    op = Manager(model_cfg=cfg, data=data, device="cpu").model.item_op
    assert op.lm.pipeline_stages == 2 and not op.use_lm_cache
    cfg["config"]["item_config"]["pipeline_stages"] = 3
    op = Manager(model_cfg=cfg, data=data, device="cpu").model.item_op
    from legommenders_tpu_torch.parallel import mesh as tmesh
    with tmesh.pipeline_parallel(tmesh.Mesh(1, 0, pp=3)):
        with pytest.raises(ValueError, match="pipeline_stages 3 != 0"):
            op.lm(torch.zeros(1, 3, op.input_dim), torch.ones(1, 3))
