"""The BERT zoo YAMLs (bert-nrms, bert-lstur, bert-miner, bert-fastformer,
bert-dcn) in the port vs the JAX package, on the CPU, on bridged weights.

Each is `config/model/<name>.yaml` as the config parser reads it
(item-bert.yaml's BertBase: LoRA folded, fused attention, tanh gelu,
[CLS] and [SEP] compacted; the user operator and predictor of its name),
made small: 2 layers of D 32, 4 heads, LoRA r 4 with a non-zero B, hidden
16, 2 user heads, 1 user layer, 4 context codes of 8, bert-dcn's MLP [16,
16] and 2 cross layers, f32, every dropout 0, over a 60-item catalog
(title 8),
in layer-split mode at tune_from 1 (layer 0 cached on both sides):
  * Tester.test(): every metric within 1e-5 of JAX's Tester (through the
    repr caches, their item reprs within 1e-5, or, for MINER, whose user
    operator refuses caching, full forwards);
  * one step of the port's fused device step, from the same weights as
    JAX, on the batch it assembles: the loss within 1e-5 relative of
    JAX's and every trainable tensor's gradient within 1e-4 of its largest
    value (a bias against the larger of its own and its weight's; no
    tensor against less than 1e-2 of the model's largest gradient: the
    NRMS user pool's proj_kernel gradient is a cancellation, 3e-6 of the
    largest at this init, its f32 residue 2e-3 of its own size, and
    MINER's score projection's, 1.1e-3 of the largest, differs by 2.2e-4
    of its own).
JAX's fused attention runs as its own tests run it off the TPU.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legommenders_tpu.data.processors.synthetic import (
    SyntheticProcessor as JSynthetic,
)
from legommenders_tpu.runtime import lm_cache as jlm_cache
from legommenders_tpu.runtime import steps as jsteps
from legommenders_tpu.runtime.tester import Tester as JTester
from legommenders_tpu_torch.bridge import params_from_jax
from legommenders_tpu_torch.data.device_pipeline import DeviceTrainPipeline
from legommenders_tpu_torch.data.processors.synthetic import SyntheticProcessor
from legommenders_tpu_torch.runtime import steps
from legommenders_tpu_torch.runtime.tester import Tester

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_decoder_models import (  # noqa: E402
    DATA_KW, build_pair, model_cfg,
)

MODELS = ("bert-nrms", "bert-lstur", "bert-miner", "bert-fastformer",
          "bert-dcn")
BATCH = 8
# the user operators' dropouts, 0 here (JAX and the port draw other masks)
USER_DROPOUT = {"bert-nrms": "attention_dropout",
                "bert-fastformer": "hidden_dropout_prob"}


def zoo_cfg(name: str) -> dict:
    cfg = model_cfg(name, tune_from=1)
    if name in USER_DROPOUT:
        cfg["config"]["user_config"][USER_DROPOUT[name]] = 0.0
    return cfg


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """Each YAML's JAX and port Managers at tune_from 1, JAX's init (LoRA
    B non-zero) bridged into the port's model, both layer-split caches
    built; once a module."""
    built = {}

    def get(name):
        if name not in built:
            jm, tm, params, _ = build_pair(
                zoo_cfg(name),
                JSynthetic(**DATA_KW).as_lego_data(),
                SyntheticProcessor(**DATA_KW).as_lego_data())
            op = jm.model.item_op
            jm.contents.columns.update(jlm_cache.load_or_build_lm_cache(
                jm.model, params, dict(jm.contents.columns), jm.data.name,
                op.transformer_key, op.resolved_tune_from, page_size=16,
                root=str(tmp_path_factory.mktemp(name))))
            assert tm.prepare_lm_cache(root=None)
            built[name] = jm, tm, params
        return built[name]

    return get


@pytest.mark.parametrize("name", MODELS)
def test_tester_matches_jax(name, pairs):
    jm, tm, params = pairs(name)
    op = tm.model.item_op
    assert type(op).__name__ == "BertBaseOperator"
    assert op.resolved_tune_from == 1 and op.input_dim == 32
    jres = JTester(jm, params).test()
    res = Tester(tm).test()
    assert (tm.cache is None) == (jm.cache is None)
    if tm.cache is not None:
        np.testing.assert_allclose(tm.cache.item_repr.numpy(),
                                   np.asarray(jm.cache.item_repr),
                                   rtol=1e-5, atol=1e-5)
    assert list(res) == list(jres)
    for k in jres:
        assert np.isfinite(res[k])
        assert abs(res[k] - jres[k]) < 1e-5, (k, res[k], jres[k])


@pytest.mark.parametrize("name", MODELS)
def test_fused_step_gradients_match_jax(name, pairs):
    jm, tm, params = pairs(name)
    cfg = tm.lego_cfg
    dp = DeviceTrainPipeline(tm.data, batch_size=BATCH,
                             neg_count=cfg.neg_count,
                             use_neg_sampling=cfg.use_neg_sampling, seed=0,
                             device="cpu")
    idx = next(dp.epoch_indices())
    # the batch the fused step assembles: its generator of step 0
    batch = dp.assemble(idx, steps.step_generator(0, 0, "cpu"))
    bj = {k: jnp.asarray(v.numpy().astype(
        np.float32 if k == "label" else np.int32)) for k, v in batch.items()}
    loss_fn = jsteps.make_loss_fn(jm.model, jm.contents.columns,
                                  cfg.use_neg_sampling)
    want_loss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(
        params, bj, jax.random.PRNGKey(0))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads),
                           tm.model)

    model = tm.model
    grads = {}

    class Capture(torch.optim.Optimizer):
        """Keeps the step's gradients and changes nothing."""

        def __init__(self, ps):
            super().__init__(ps, {})

        def step(self, closure=None):
            for name_, p in model.named_parameters():
                if p.grad is not None:
                    grads[name_] = p.grad.clone()

    trainable = [p for p in model.parameters() if p.requires_grad]
    step = dp.make_fused_train_step(model, tm.contents.columns,
                                    Capture(trainable), seed=0)
    loss = step(idx, 0).item()
    assert abs(loss - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    assert grads
    largest = max(float(t.abs().max()) for t in want.values())
    for pname, p in model.named_parameters():
        w = want[pname].numpy()
        if pname not in grads:
            assert not p.requires_grad or not np.any(w), pname
            continue
        weight = want.get(pname[:-len("bias")] + "weight", want[pname])
        scale = max(float(np.abs(w).max()), float(weight.abs().max()),
                    1e-2 * largest)
        err = float(np.abs(grads[pname].numpy() - w).max())
        assert err <= 1e-4 * scale, (pname, err, scale)
    # the upper layer's LoRA on q and v trained
    assert sum(".lora_" in n for n in grads) == 4
