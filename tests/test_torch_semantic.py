"""The semantic-ID family in the port vs the JAX package.

A 40-item synthetic catalog (title 8, history 6) gets a semantic-code
column of 4 codes per item and a user-code column of 3 codes per user,
each from a 32-entry codebook drawn by numpy from a seed, in both
frameworks' stores. Three compositions (JAX tests/test_semantic.py),
hidden 16, f32, on bridged weights:
  * Ada / Semantic (`return_stack`) / Poly (base Dot);
  * Ada / Semantic (pooled by the additive pool) / Dot;
  * SCSimple / SCMix / SemanticMix (base Dot): the items' code stack
    (B, K, 4, D) against the user's codes (B, 3, D).
Checked: the scores of one batch (1e-5) and the gradient of every
parameter (1e-4 of its largest, or of 1e-3 of the model's largest where
that is larger; JAX's zero gradients where the port has none), the modules the bridge places (`base_<i>`, `pool`, `mix_linear`),
the evaluation by full forwards (a flatten user operator is never
cached) against JAX's Tester (1e-5), and SemanticMixPredictor at unit
level.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legommenders_tpu.data.pipeline import TrainBatcher as JTrainBatcher
from legommenders_tpu.data.processors.synthetic import (
    SyntheticProcessor as JSynthetic,
)
from legommenders_tpu.data.vocab import Vocab as JVocab
from legommenders_tpu.models.lego_config import LegoConfig as JLegoConfig
from legommenders_tpu.runtime import steps as jsteps
from legommenders_tpu_torch.bridge import params_from_jax
from legommenders_tpu_torch.data.processors.synthetic import SyntheticProcessor
from legommenders_tpu_torch.data.vocab import Vocab
from legommenders_tpu_torch.models.lego_config import LegoConfig
from legommenders_tpu_torch.runtime import steps

DATA_KW = dict(num_items=40, num_users=20, title_len=8, history_len=6,
               inters_per_user=10)
CODES, USER_CODES, BOOK = 4, 3, 32
COMPOSITIONS = {
    "poly": dict(item_operator="Ada", user_operator="Semantic",
                 predictor="Poly",
                 user_config={"base_operator": "Ada", "return_stack": True,
                              "additive_hidden_size": 16},
                 item_config={"additive_hidden_size": 16},
                 predictor_config={"base_predictor": "Dot",
                                   "num_layers": 4}),
    "pooled": dict(item_operator="Ada", user_operator="Semantic",
                   predictor="Dot",
                   user_config={"base_operator": "Ada",
                                "base_operator_config": {
                                    "additive_hidden_size": 16},
                                "additive_hidden_size": 16},
                   item_config={"additive_hidden_size": 16}),
    "mix": dict(item_operator="SCSimple", user_operator="SCMix",
                predictor="SemanticMix",
                predictor_config={"base_predictor": "Dot"}),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _with_codes(data, vocab_cls):
    rng = np.random.default_rng(0)
    codes = rng.integers(0, BOOK, size=(DATA_KW["num_items"], CODES))
    data.items.add_seq_column("semantic", codes.astype(np.int32).tolist(),
                              vocab_cls("semantic", tokens=None)
                              .set_size(BOOK), CODES)
    data.items.vocab_hub.get("semantic").set_size(BOOK)
    data.item_inputs = [("semantic", CODES)]
    ucodes = np.random.default_rng(1).integers(
        0, BOOK, size=(DATA_KW["num_users"], USER_CODES))
    data.users.add_seq_column("semantic", ucodes.astype(np.int32).tolist(),
                              vocab_cls("semantic", tokens=None)
                              .set_size(BOOK), USER_CODES)
    data.user_inputs = [("semantic", USER_CODES)]
    return data


@pytest.fixture(scope="module")
def datas():
    return (_with_codes(JSynthetic(**DATA_KW).as_lego_data(), JVocab),
            _with_codes(SyntheticProcessor(**DATA_KW).as_lego_data(), Vocab))


def _nonzero(tree, rng):
    """Draw every leaf anew (a Dot head and zero-initialised biases would
    leave gradients trivially 0)."""
    return {k: (_nonzero(v, rng) if isinstance(v, dict) else
                rng.normal(0, 0.3, np.shape(v)).astype(np.float32))
            for k, v in tree.items()}


@pytest.fixture(scope="module", params=list(COMPOSITIONS))
def pair(request, datas):
    jdata, tdata = datas
    kw = dict(COMPOSITIONS[request.param], hidden_size=16,
              use_fast_eval=False)
    jmodel, jcontents, _ = JLegoConfig(data=jdata, **kw).build()
    tmodel, tcontents = LegoConfig(data=tdata, **kw).build()
    batch = next(JTrainBatcher(jdata, batch_size=4, neg_count=4,
                               seed=0).epoch())
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jsteps.init_params(jmodel, jbatch, jcontents.columns)
    tree = _nonzero(jax.tree_util.tree_map(np.asarray, params),
                    np.random.default_rng(2))
    tmodel.load_state_dict(params_from_jax(tree, tmodel))
    tbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    return dict(name=request.param, jmodel=jmodel, jcontents=jcontents,
                tmodel=tmodel, tcontents=tcontents, tree=tree,
                jbatch=jbatch, tbatch=tbatch, jdata=jdata, tdata=tdata)


def test_build_and_bridge(pair):
    model, name = pair["tmodel"], pair["name"]
    assert model.flatten_mode
    names = {n for n, _ in model.named_parameters()}
    if name == "mix":
        assert model.user_batch_cols == ("semantic",)
        assert model.predictor.mix_linear.in_features == CODES * USER_CODES
        assert {"predictor.mix_linear.weight",
                "predictor.mix_linear.bias"} <= names
    else:
        assert model.user_batch_cols == ()
        assert model.user_op.num_semantic_layers == CODES
        assert {f"user_op.base_{i}.attention.proj_kernel"
                for i in range(CODES)} <= names
        assert ("user_op.pool.query" in names) == (name == "pooled")


def test_scores_match_jax(pair):
    want = np.asarray(pair["jmodel"].apply(
        {"params": pair["tree"]["params"]}, pair["jbatch"],
        pair["jcontents"].columns, training=False))
    with torch.no_grad():
        got = pair["tmodel"](pair["tbatch"], pair["tcontents"].columns)
    assert got.shape == want.shape == (4, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_gradients_match_jax(pair):
    loss_fn = jsteps.make_loss_fn(pair["jmodel"], pair["jcontents"].columns,
                                  True)
    want_loss, jgrads = jax.value_and_grad(loss_fn)(
        {"params": pair["tree"]["params"]}, pair["jbatch"],
        jax.random.PRNGKey(0))
    model = pair["tmodel"]
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads),
                           model)
    model.zero_grad(set_to_none=True)
    loss = steps.make_loss_fn(model, pair["tcontents"].columns, True)(
        pair["tbatch"], torch.Generator().manual_seed(0))
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 1e-5 * abs(
        float(want_loss))
    n = 0
    # a tensor whose gradient is 0 in exact arithmetic (mix_linear's bias:
    # the softmax over the candidates ignores a shift common to them) is
    # held at the f32 rounding of the model's gradients
    floor = 1e-3 * max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name, p in model.named_parameters():
        w = want[name].numpy()
        if p.grad is None:
            assert not np.any(w), name
            continue
        n += 1
        scale = max(float(np.abs(w).max()), floor)
        assert float(np.abs(p.grad.numpy() - w).max()) <= 1e-4 * scale, name
    model.zero_grad(set_to_none=True)
    assert n >= 2


def test_full_forward_test_matches_jax(pair):
    """The Tester's evaluation: full forwards over the test rows (the user
    operator is flatten-mode, never cached), the metrics against JAX's."""
    from legommenders_tpu.runtime.evaluator import Evaluator as JEvaluator
    from legommenders_tpu_torch.runtime.evaluator import Evaluator

    params = {"params": pair["tree"]["params"]}
    jev = JEvaluator(pair["jmodel"], pair["jcontents"].columns,
                     pair["jdata"], 16, ["GAUC", "MRR"])
    want = jev.evaluate(params, "test")
    ev = Evaluator(pair["tmodel"], pair["tdata"], ["GAUC", "MRR"], None,
                   "cpu", item_contents=pair["tcontents"].columns,
                   batch_size=16)
    got = ev.evaluate("test")
    assert want.keys() == got.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5, (k, got[k], want[k])


def test_semantic_mix_predictor_unit():
    from legommenders_tpu.models.predictors.semantic_heads import (
        SemanticMixPredictor as JMix,
    )
    from legommenders_tpu_torch.models.predictors.semantic_heads import (
        SemanticMixPredictor,
    )
    rng = np.random.default_rng(5)
    B, K, Si, Su, D = 3, 5, 4, 4, 8
    user = rng.normal(size=(B, Su, D)).astype(np.float32)
    items = rng.normal(size=(B, K, Si, D)).astype(np.float32)
    jpred = JMix(hidden_size=D)
    params = jax.tree_util.tree_map(np.asarray, jpred.init(
        jax.random.PRNGKey(0), jnp.asarray(user), jnp.asarray(items)))
    want = np.asarray(jpred.apply(params, jnp.asarray(user),
                                  jnp.asarray(items)))
    pred = SemanticMixPredictor(hidden_size=D, num_pairs=Si * Su)
    pred.load_state_dict(params_from_jax(params, pred))
    with torch.no_grad():
        got = pred(torch.from_numpy(user), torch.from_numpy(items)).numpy()
    assert got.shape == (B, K)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="mix_linear"):
        pred(torch.from_numpy(user[:, :2]), torch.from_numpy(items))
