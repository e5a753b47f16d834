"""Training the decoder YAMLs in the port vs the JAX package, on the CPU,
on bridged weights, and the decoder YAMLs through the port's entry points.

llama-naml and opt-naml in layer-split mode (tune_from 1: layer 0
cached, layer 1 trained with LoRA r 4 folded, the final norm), and
opt-naml in full-LM mode (both layers' LoRA, the word table, learned
positions), each made small as in tests/test_torch_decoder_models.py,
f32, dropout 0, batches of 8 with 4 negatives from the port's device
pipeline fed to both frameworks:
  * the gradient of every trainable tensor against jax.grad of JAX's loss
    (1e-4 of each tensor's largest value; a bias against the larger of
    its own and its weight's), in the three settings;
  * 20 Adam steps (lr 1e-3) of the port and of JAX's train step with
    optax.adam, each running free from the same start, in the three
    settings: every loss of the port's steps within 1e-5 relative of JAX's
    loss at the port's parameters of that step and, in layer-split mode,
    of JAX's own free-running loss of that step; every parameter within
    1e-4 of JAX's at the end. (opt-naml's full-LM run is not held to JAX's
    free-running loss: there Adam's per-element normalisation turns f32
    rounding in word-table gradients that are cancellations, such as one
    of 2e-5 in a row whose largest is 0.29, into parameter differences of
    ~1e-6 from the second step on, and at a loss of 0.12 that reads as
    1e-5 relative; FREE_RUN_EXEMPT.)
Each of the 13 YAMLs runs the port's fused device step (2 steps,
layer-split at tune_from 1 with pages of 16 under `full` remat, the
YAML's dropout) and its Trainer (one epoch of 3 steps, dev through the
caches); llama-naml trains through the CLI with `--device cpu`. A bf16
layer-split model trains after an evaluation (which runs in inference
mode). chip_smoke.py's decoder pages are what the models give at its
fixture's geometry.
"""
import copy
import os
import sys

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
from legommenders_tpu_torch import process, trainer
from legommenders_tpu_torch.bridge import _place, params_from_jax
from legommenders_tpu_torch.data.device_pipeline import DeviceTrainPipeline
from legommenders_tpu_torch.data.processors.synthetic import SyntheticProcessor
from legommenders_tpu_torch.models.operators.lm_ops import (
    LM_HIDDEN_KEY, LM_MASK_KEY,
)
from legommenders_tpu_torch.runtime import steps
from legommenders_tpu_torch.runtime.manager import Manager
from legommenders_tpu_torch.runtime.tester import Tester
from legommenders_tpu_torch.runtime.trainer import Trainer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_decoder_models import (  # noqa: E402
    DATA_KW, MODELS, ROOT, build_pair, model_cfg,
)

BATCH = 8
# (YAML, tune_from)
GRADIENTS = [("llama-naml", 1), ("opt-naml", 1), ("opt-naml", None)]
TRAJECTORIES = GRADIENTS
# held only against JAX's loss at the port's own parameters of each step:
# in full-LM mode Adam turns f32 rounding in word-table gradients that are
# cancellations (2.164e-5 against 2.171e-5 in a row whose largest value is
# 0.29) into parameter differences of ~1e-6 from step 2 on, and the two
# free runs' losses drift to 1.01e-5 relative by step 18
FREE_RUN_EXEMPT = {("opt-naml", None)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tdata():
    return SyntheticProcessor(**DATA_KW).as_lego_data()


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    built = {}

    def get(name, tune_from):
        if (name, tune_from) not in built:
            cfg = model_cfg(name, tune_from=tune_from)
            jm, tm, params, _ = build_pair(
                cfg, JSynthetic(**DATA_KW).as_lego_data(),
                SyntheticProcessor(**DATA_KW).as_lego_data())
            if tune_from:
                op = jm.model.item_op
                from legommenders_tpu.runtime import lm_cache as jlm_cache
                jm.contents.columns.update(jlm_cache.load_or_build_lm_cache(
                    jm.model, params, dict(jm.contents.columns),
                    jm.data.name, op.transformer_key, op.resolved_tune_from,
                    page_size=16, root=str(tmp_path_factory.mktemp(name))))
                assert tm.prepare_lm_cache(root=None)
            built[name, tune_from] = jm, tm, params
        return built[name, tune_from]

    return get


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


@pytest.mark.parametrize("name,tune_from", GRADIENTS)
def test_gradients_match_jax(name, tune_from, pairs):
    jm, tm, params = pairs(name, tune_from)
    (bt, bj), = _batches(tm, 1)
    loss_fn = jsteps.make_loss_fn(jm.model, jm.contents.columns, True)
    want_loss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(
        params, bj, jax.random.PRNGKey(0))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads),
                           tm.model)
    model = tm.model
    model.zero_grad(set_to_none=True)
    loss = steps.make_loss_fn(model, tm.contents.columns, True)(
        bt, torch.Generator().manual_seed(0))
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    trained = []
    for pname, p in model.named_parameters():
        w = want[pname].numpy()
        if not p.requires_grad or p.grad is None:
            assert not np.any(w), pname
            continue
        trained.append(pname)
        weight = want.get(pname[:-len("bias")] + "weight", want[pname])
        scale = max(float(np.abs(w).max()), float(weight.abs().max()), 1e-6)
        err = float(np.abs(p.grad.numpy() - w).max())
        assert err <= 1e-4 * scale, (pname, err, scale)
    model.zero_grad(set_to_none=True)
    lora = [n for n in trained if ".lora_" in n]
    # q and v of each trained layer: layer 1 (split) or layers 0-1 (full)
    assert len(lora) == (4 if tune_from else 8)


def _to_jax(model, like):
    """The port model's parameters as a tree shaped like JAX's `like` (the
    bridge's layout changes are transposes, each its own inverse)."""
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}

    def leaf(path, x):
        keys = tuple(p.key for p in path)[1:]  # under "params"
        key, _ = _place(keys, np.asarray(x))
        _, arr = _place(keys, sd[key])
        assert arr.shape == np.shape(x), (key, arr.shape, np.shape(x))
        return jnp.asarray(arr)

    return jax.tree_util.tree_map_with_path(leaf, like)


@pytest.mark.parametrize("name,tune_from", TRAJECTORIES)
def test_adam_trajectory_matches_jax(name, tune_from, pairs):
    jm, tm, params = pairs(name, tune_from)
    batches = _batches(tm, 20, seed=1)
    opt = optax.adam(1e-3)
    jstep = jsteps.make_train_step(jm.model, jm.contents.columns, opt, True)
    jloss = jax.jit(jsteps.make_loss_fn(jm.model, jm.contents.columns, True))
    jparams = jax.tree_util.tree_map(jnp.array, params)
    opt_state = opt.init(jparams)
    model = copy.deepcopy(tm.model)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    step = steps.make_train_step(model, tm.contents.columns,
                                 steps.adam(model, 1e-3))
    for i, (bt, bj) in enumerate(batches):
        want = float(jloss(_to_jax(model, params), bj,
                           jax.random.PRNGKey(i)))
        got = step(bt, torch.Generator().manual_seed(i)).item()
        assert abs(got - want) <= 1e-5 * abs(want), (i, got, want)
        jparams, opt_state, free = jstep(jparams, opt_state, bj,
                                         jax.random.PRNGKey(i))
        if (name, tune_from) not in FREE_RUN_EXEMPT:
            free = float(free)
            assert abs(got - free) <= 1e-5 * abs(free), (i, got, free)
    final = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                            model)
    moved = 0
    for pname, t in model.named_parameters():
        np.testing.assert_allclose(t.detach().numpy(), final[pname].numpy(),
                                   rtol=0, atol=1e-4, err_msg=pname)
        moved += not torch.equal(t.detach(), start[pname])
    assert moved >= 8


@pytest.mark.parametrize("name", MODELS)
def test_fused_step_and_trainer_run_the_yaml(name, tdata):
    cfg = model_cfg(name, dropout=True, tune_from=1)
    cfg["config"].update(item_page_size=16, item_page_remat="full")
    tm = Manager(model_cfg=cfg, data=tdata, device="cpu",
                 exp_cfg={"policy": {"batch_size": BATCH, "epoch": 1,
                                     "epoch_batch": 3}})
    assert tm.model.item_op.resolved_tune_from == 1
    tr = Trainer(tm, seed=0, lm_cache_root=None)
    tr.init()
    assert tm.contents.columns[LM_HIDDEN_KEY].shape[1] % 8 == 0
    cfg_l = tm.lego_cfg
    dp = DeviceTrainPipeline(tdata, batch_size=BATCH,
                             neg_count=cfg_l.neg_count,
                             use_neg_sampling=cfg_l.use_neg_sampling,
                             seed=0, device="cpu")
    step = dp.make_fused_train_step(tm.model, tm.contents.columns,
                                    steps.adam(tm.model, 1e-3), seed=0)
    idx = next(dp.epoch_indices())
    assert all(np.isfinite([step(idx, i).item() for i in range(2)]))
    out = tr.train()
    assert tr.global_step == 3
    assert np.isfinite(out["best_dev"])
    res = tr.test()
    assert all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in res.values())


def test_bf16_training_after_evaluation(tdata):
    """An evaluation (inference mode) keeps bf16 casts of the frozen
    weights; the training step after it saves them for its backward."""
    cfg = model_cfg("llama-naml", lm_dtype="bf16", tune_from=1)
    tm = Manager(model_cfg=cfg, data=tdata, device="cpu",
                 exp_cfg={"policy": {"batch_size": BATCH}})
    assert tm.prepare_lm_cache(root=None)
    Tester(tm).test()
    dp = DeviceTrainPipeline(tdata, batch_size=BATCH, seed=0, device="cpu")
    step = dp.make_fused_train_step(tm.model, tm.contents.columns,
                                    steps.adam(tm.model, 1e-3), seed=0)
    loss = step(next(dp.epoch_indices()), 0)
    assert torch.isfinite(loss).item()
    Tester(tm).test()
    assert torch.isfinite(step(next(dp.epoch_indices()), 1)).item()


def test_cache_build_drops_the_lower_slices_casts(tdata, monkeypatch):
    """The layer-split cache build runs the frozen lower slice in
    inference mode, which keeps its bf16 casts; nothing runs that slice
    after the build, so the Manager drops them (12 GB at the Llama-7B
    geometry) and keeps the upper slice's."""
    from legommenders_tpu_torch.models.lm import layers
    kept = []
    cached_casts = layers.cached_casts

    def spy(module, params, make):
        kept.append(module)
        return cached_casts(module, params, make)

    monkeypatch.setattr(layers, "cached_casts", spy)
    cfg = model_cfg("llama-naml", lm_dtype="bf16", tune_from=1)
    tm = Manager(model_cfg=cfg, data=tdata, device="cpu",
                 exp_cfg={"policy": {"batch_size": BATCH}})
    op = tm.model.item_op
    assert tm.prepare_lm_cache(root=None)
    lower = set(op.lm_lower.modules())
    assert any(m in lower for m in kept)
    assert not any("_cast_cache" in m.__dict__ for m in lower)
    Tester(tm).test()
    assert any("_cast_cache" in m.__dict__ for m in op.lm.modules())


def test_cli_trains_llama_naml_on_the_cpu(tmp_path, monkeypatch):
    """`python -m legommenders_tpu_torch.trainer --model llama-naml` with
    `--device cpu`, the LM made small by dotted overrides."""
    path = str(tmp_path / "data" / "synthetic")
    process.main(["--data", "synthetic", "--save_dir", path])
    monkeypatch.chdir(tmp_path)
    small = {"model.config.embedding_dim": "32",
             "model.config.item_config.num_hidden_layers": "2",
             "model.config.item_config.num_attention_heads": "4",
             "model.config.item_config.intermediate_size": "32",
             "model.config.item_config.lora_r": "4"}
    argv = ["--data", "synthetic", "--data_dir", path, "--model",
            "llama-naml", "--epoch", "1", "--epoch_batch", "3",
            "--batch_size", "16", "--hidden_size", "16", "--lm_dtype", "f32",
            "--device", "cpu"]
    for k, v in small.items():
        argv += [f"--{k}", v]
    results = trainer.main(argv)
    assert all(0.0 <= v <= 1.0 for v in results.values())
    (csv,) = (tmp_path / "checkpoints" / "synthetic" / "llama-naml").glob(
        "*.csv")
    assert csv.read_text().splitlines()[0].split(",") == list(results)


def test_chip_smoke_decoder_pages_are_the_models():
    """chip_smoke.py's phase 9 holds the attention at the pages its
    decoder paths give it: the compact title + category of its fixture
    (L 31 serving, the cache padded to 32), 4 items a row of 512, and the
    YAMLs' widths and heads at their defaults."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from legommenders_tpu_torch.config import parser
    from legommenders_tpu_torch.models.lm.layers import pack_group_size
    from legommenders_tpu_torch.runtime.lm_cache import device_entries
    from legommenders_tpu_torch.utils.registry import OPERATORS

    kw = dict(chip_smoke.DATA_KW, num_items=200, num_users=12,
              vocab_size=300, inters_per_user=4)
    data = SyntheticProcessor(**kw).as_lego_data()
    for family in ("llama", "opt"):
        cfg = model_cfg(f"{family}-naml")
        tm = Manager(model_cfg=cfg, data=data, device="cpu")
        with torch.no_grad():
            _, mask = tm.model.item_inputer.get_embeddings(
                tm.model.eh, tm.contents.columns)
        L = mask.shape[1]
        padded = device_entries(torch.zeros(1, L, 1), mask[:1], torch.float32,
                                "cpu")[LM_MASK_KEY].shape[1]
        full = parser.parse_four_way(
            {"model": f"{family}-naml"},
            config_root=os.path.join(ROOT, "config")).raw()["model"]
        op = OPERATORS[full["meta"]["item"]]
        for mode, length in (("serving", L), ("training", padded)):
            page = chip_smoke.DECODER_PAGES[f"{family} {mode}"]
            assert page["L"] == length
            assert page["D"] == full["config"]["embedding_dim"]
            assert page["heads"] == op.num_heads_default
            assert page["items"] == full["config"].get(
                "cache_page_size", 512) == 512
            assert pack_group_size(length, -1) == 4
