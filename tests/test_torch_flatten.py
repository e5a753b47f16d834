"""The flatten (BST-style) user paths in the port vs the JAX package, on
the CPU, on bridged weights, f32, every dropout 0.

flatten_transformer and flatten_fastformer are
`config/model/<name>.yaml` as the config parser reads it (a Transformer /
Fastformer item operator; the FlattenTransformer / FlattenFastformer user
operator over the FlattenSeqInputer sequence of the whole history), at
hidden 16, 1 item and 1 user layer, over a 60-item catalog of title 6 +
category, histories of up to 4 clicks (9 slots a click: L 36):
  * FlattenSeqInputer: the flattened embeddings and mask of a page of
    histories (padded clicks all -1), with and without [CLS], compact on
    and off, equal to JAX's within 1e-6 (the mask exactly);
  * each YAML's forward scores on a training batch within 1e-5, its
    Tester.test() (full forwards: the flatten operators refuse caching)
    within 1e-5, and one step of the port's fused device step: the loss
    within 1e-5 relative of JAX's and every gradient within 1e-4 of its
    tensor's largest value (a bias against the larger of its own and its
    weight's);
  * a flattened history longer than the operator's positions raises in
    both packages, the port's error naming the limit;
  * the pool's plain version at L 300 (the long-sequence kernel's
    reference) against JAX's `_forward_jnp` within 1e-5;
  * SCFlattenOperator is registered, in flatten mode and not cacheable;
  * flatten_transformer trains and tests through the port's CLI with
    `--device cpu` (histories cut to 4 clicks by the data config's
    `history_truncate`).
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legommenders_tpu.data.processors.synthetic import (
    SyntheticProcessor as JSynthetic,
)
from legommenders_tpu.ops import pallas_additive
from legommenders_tpu.runtime import steps as jsteps
from legommenders_tpu.runtime.manager import Manager as JManager
from legommenders_tpu.runtime.tester import Tester as JTester
from legommenders_tpu_torch import process, trainer
from legommenders_tpu_torch.bridge import params_from_jax
from legommenders_tpu_torch.config import parser
from legommenders_tpu_torch.data.device_pipeline import DeviceTrainPipeline
from legommenders_tpu_torch.data.processors.synthetic import SyntheticProcessor
from legommenders_tpu_torch.models.inputers.flatten import FlattenSeqInputer
from legommenders_tpu_torch.ops.additive import additive_pool_reference
from legommenders_tpu_torch.runtime import steps
from legommenders_tpu_torch.runtime.manager import Manager
from legommenders_tpu_torch.runtime.tester import Tester
from legommenders_tpu_torch.utils.registry import OPERATORS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_KW = dict(num_items=60, num_users=30, title_len=6, history_len=4,
               vocab_size=200, inters_per_user=6)
BATCH = 8
MODELS = ("flatten_transformer", "flatten_fastformer")
# each operator's dropout option
DROPOUT = {"Transformer": "attention_dropout", "Fastformer":
           "hidden_dropout_prob", "FlattenTransformer": "attention_dropout",
           "FlattenFastformer": "hidden_dropout_prob"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def model_cfg(name: str, **user_inputer) -> dict:
    cfg = parser.parse_four_way({"model": name, "hidden_size": 16,
                                 "item_layers": 1, "user_layers": 1},
                                config_root=os.path.join(ROOT, "config"))
    cfg = copy.deepcopy(cfg.raw()["model"])
    for side in ("item", "user"):
        op = cfg["meta"][side]
        cfg["config"][f"{side}_config"][DROPOUT[op]] = 0.0
    if user_inputer:
        cfg["config"]["user_config"]["inputer_config"] = user_inputer
    return cfg


def build_pair(cfg):
    """JAX's and the port's Managers of one config, JAX's init bridged
    into the port's model, and JAX's first training batch."""
    jm = JManager({}, cfg, data=JSynthetic(**DATA_KW).as_lego_data(),
                  exp_cfg={"policy": {"batch_size": BATCH}})
    batch = next(jm.train_batcher(seed=0).epoch(shuffle=False))
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.jit(lambda b, c: jsteps.init_params(jm.model, b, c, seed=0))(
        batch, jm.contents.columns)
    tree = jax.tree_util.tree_map(np.asarray, params)
    tm = Manager(model_cfg=cfg, data=SyntheticProcessor(**DATA_KW)
                 .as_lego_data(), device="cpu",
                 exp_cfg={"policy": {"batch_size": BATCH}})
    tm.model.load_state_dict(params_from_jax(tree, tm.model))
    return jm, tm, params, batch


@pytest.fixture(scope="module")
def pairs():
    built = {}

    def get(name):
        if name not in built:
            built[name] = build_pair(model_cfg(name))
        return built[name]

    return get


def _histories(tm, users=6):
    """The first users' clicks' item columns, -1 where a click is padded,
    as the model's forward gathers them."""
    hist = torch.as_tensor(tm.data.history_matrix()[:users]).long()
    cols = tm.contents.columns
    n = next(iter(cols.values())).shape[0]
    safe = hist.clamp(0, n - 1)
    return {c: torch.where(hist[..., None] >= 0, a[safe], -1)
            for c, a in cols.items()}


@pytest.mark.parametrize("use_cls_token", [False, True])
@pytest.mark.parametrize("compact", [False, True])
def test_flatten_inputer_matches_jax(use_cls_token, compact):
    cfg = model_cfg("flatten_transformer", use_cls_token=use_cls_token,
                    compact=compact)
    jm, tm, params, _ = build_pair(cfg)
    inp = tm.model.user_inputer
    assert isinstance(inp, FlattenSeqInputer)
    assert inp.use_cls_token == use_cls_token and inp.compact == compact
    assert inp.per_click_len == 9 and inp.seq_len(4) == 36 + use_cls_token
    contents = _histories(tm)
    # some clicks are padded
    assert (contents["title"][:, :, 0] < 0).any()
    jc = {c: jnp.asarray(a.numpy()) for c, a in contents.items()}
    want_emb, want_mask = jm.model.apply(
        params, jc, method=lambda m, c: m.user_inputer.get_embeddings(m.eh,
                                                                      c))
    with torch.no_grad():
        emb, mask = inp.get_embeddings(tm.model.eh, contents)
    assert emb.shape == (6, 36 + use_cls_token, 16)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    np.testing.assert_allclose(emb.numpy(), np.asarray(want_emb), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("name", MODELS)
def test_forward_and_tester_match_jax(name, pairs):
    jm, tm, params, batch = pairs(name)
    assert tm.model.flatten_mode and tm.cache is None and jm.cache is None
    assert type(tm.model.user_op).__name__ == tm.lego_cfg.user_operator + \
        "Operator"
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


@pytest.mark.parametrize("name", MODELS)
def test_fused_step_matches_jax(name, pairs):
    jm, tm, params, _ = pairs(name)
    dp = DeviceTrainPipeline(tm.data, batch_size=BATCH, seed=0, device="cpu")
    idx = next(dp.epoch_indices())
    batch = dp.assemble(idx, steps.step_generator(0, 0, "cpu"))
    bj = {k: jnp.asarray(v.numpy().astype(
        np.float32 if k == "label" else np.int32)) for k, v in batch.items()}
    loss_fn = jsteps.make_loss_fn(jm.model, jm.contents.columns, True)
    want_loss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(
        params, bj, jax.random.PRNGKey(0))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads),
                           tm.model)
    model = copy.deepcopy(tm.model)
    grads = {}

    class Capture(torch.optim.Optimizer):
        """Keeps the step's gradients and changes nothing."""

        def __init__(self, ps):
            super().__init__(ps, {})

        def step(self, closure=None):
            for pname, p in model.named_parameters():
                if p.grad is not None:
                    grads[pname] = p.grad.clone()

    step = dp.make_fused_train_step(model, tm.contents.columns,
                                    Capture(list(model.parameters())), seed=0)
    loss = step(idx, 0).item()
    assert abs(loss - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    # the user inputer's special tokens and the user operator train
    assert "user_inputer.special_tokens" in grads
    assert any(n.startswith("user_op.") for n in grads)
    for pname, p in model.named_parameters():
        w = want[pname].numpy()
        if pname not in grads:
            assert not np.any(w), pname
            continue
        weight = want.get(pname[:-len("bias")] + "weight", want[pname])
        scale = max(float(np.abs(w).max()), float(weight.abs().max()), 1e-6)
        err = float(np.abs(grads[pname].numpy() - w).max())
        assert err <= 1e-4 * scale, (pname, err, scale)


@pytest.mark.parametrize("name,key", [
    ("flatten_transformer", "max_position_embeddings"),
    ("flatten_fastformer", "max_position_embeddings")])
def test_history_past_the_positions_raises(name, key):
    """36 tokens against 32 positions: JAX fails on the shapes, the port
    raises naming its limit."""
    cfg = model_cfg(name)
    cfg["config"]["user_config"][key] = 32
    jm = JManager({}, cfg, data=JSynthetic(**DATA_KW).as_lego_data(),
                  exp_cfg={"policy": {"batch_size": BATCH}})
    batch = next(jm.train_batcher(seed=0).epoch(shuffle=False))
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    with pytest.raises(TypeError, match="broadcasting"):
        jsteps.init_params(jm.model, batch, jm.contents.columns, seed=0)
    tm = Manager(model_cfg=cfg, data=SyntheticProcessor(**DATA_KW)
                 .as_lego_data(), device="cpu")
    tbatch = {k: torch.from_numpy(np.array(batch[k]))
              for k in ("candidates", "history", "mask")}
    with pytest.raises(ValueError, match="36 tokens.*32 positions"):
        tm.model(tbatch, tm.contents.columns)


def test_long_pool_plain_version_matches_jax():
    rng = np.random.default_rng(0)
    N, L, D, H = 5, 300, 16, 8
    x = rng.standard_normal((N, L, D)).astype(np.float32)
    mask = (rng.random((N, L)) < 0.6).astype(np.float32)
    mask[0] = 0.0
    w1 = (rng.standard_normal((D, H)) / 4).astype(np.float32)
    b1 = (rng.standard_normal(H) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal(H) / 3).astype(np.float32)
    want = np.asarray(pallas_additive._forward_jnp(
        *(jnp.asarray(a) for a in (x, mask, w1, b1, w2))))
    got = additive_pool_reference(
        *(torch.from_numpy(a) for a in (x, mask, w1, b1, w2))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert not got[0].any()


def test_sc_flatten_is_registered():
    cls = OPERATORS["SCFlatten"]
    assert cls.flatten_mode and not cls.allow_caching
    assert issubclass(cls, OPERATORS["SCSimple"])


def test_cli_trains_flatten_transformer_on_the_cpu(tmp_path, monkeypatch):
    path = str(tmp_path / "data" / "synthetic")
    process.main(["--data", "synthetic", "--save_dir", path])
    monkeypatch.chdir(tmp_path)
    argv = ["--data", "synthetic", "--data_dir", path, "--model",
            "flatten_transformer", "--epoch", "1", "--epoch_batch", "3",
            "--batch_size", "16", "--hidden_size", "16", "--item_layers",
            "1", "--user_layers", "1", "--history_truncate", "4",
            "--device", "cpu"]
    results = trainer.main(argv)
    assert all(0.0 <= v <= 1.0 for v in results.values())
    (csv,) = (tmp_path / "checkpoints" / "synthetic" /
              "FlattenTransformer").glob("*.csv")
    assert csv.read_text().splitlines()[0].split(",") == list(results)
