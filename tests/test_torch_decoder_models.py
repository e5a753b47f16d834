"""The 13 decoder YAMLs end to end in the port vs the JAX package, on the
CPU, on bridged weights.

Each of llama-{naml,nrms,lstur,miner,fastformer,dcn}, glm-{naml,nrms,
lstur} and opt-{naml,nrms,lstur,miner} is `config/model/<name>.yaml` as
the config parser reads it (Llama1, GLM and OPTBase item operators with
the YAMLs' knobs: LoRA folded, fused attention, the compact inputer, OPT's
dropout_reuse), made small through `item_config` (2 layers of D 32, 4
heads, Llama's and GLM's SwiGLU 32, GLM's 2 kv heads, LoRA r 4 with a
non-zero B, f32, dropout 0) and the YAMLs' placeholders (hidden 16, 2
user heads, 1 user layer, 4 context codes of 8, llama-dcn's MLP [16, 16]
and 2 cross layers), over a 60-item catalog (title 8), eval mode:
  * Manager + Tester.test(): every metric within 1e-5 of JAX's Tester,
    through the repr caches (their item reprs within 1e-5) or, for MINER's
    and the Pooling user of llama-dcn as JAX decides, full forwards;
  * the forward's scores on one training batch within 1e-5;
  * the registry builds every YAML's operator class under its YAML name,
    the IISAN YAMLs' too.
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
from legommenders_tpu.runtime import steps as jsteps
from legommenders_tpu.runtime.manager import Manager as JManager
from legommenders_tpu.runtime.tester import Tester as JTester
from legommenders_tpu_torch.bridge import params_from_jax
from legommenders_tpu_torch.config import parser
from legommenders_tpu_torch.data.processors.synthetic import SyntheticProcessor
from legommenders_tpu_torch.runtime.manager import Manager
from legommenders_tpu_torch.runtime.tester import Tester

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_KW = dict(num_items=60, num_users=30, title_len=8, history_len=6,
               vocab_size=200, inters_per_user=6)
BATCH = 8
MODELS = ("llama-naml", "llama-nrms", "llama-lstur", "llama-miner",
          "llama-fastformer", "llama-dcn", "glm-naml", "glm-nrms",
          "glm-lstur", "opt-naml", "opt-nrms", "opt-lstur", "opt-miner")
OPERATORS = {"llama": "Llama1Operator", "glm": "GLMOperator",
             "opt": "OPTBaseOperator"}
SMALL = {"hidden_size": 16, "num_user_heads": 2, "user_layers": 1,
         "num_context_codes": 4, "context_code_dim": 8, "cross_num": 2,
         "lm_dtype": "f32"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def model_cfg(name: str, dropout: bool = False, **item_config) -> dict:
    """The YAML made small; `dropout` keeps the YAML's dropouts (OPT's
    hidden 0.1, DCN's MLP 0.1), else 0."""
    cfg = parser.parse_four_way({"model": name, **SMALL},
                                config_root=os.path.join(ROOT, "config"))
    cfg = copy.deepcopy(cfg.raw()["model"])
    c = cfg["config"]
    c.update(embedding_dim=32, cache_page_size=16)
    ic = c["item_config"]
    ic.update(num_hidden_layers=2, num_attention_heads=4, lora_r=4,
              additive_hidden_size=16, **item_config)
    if not name.startswith("opt"):
        ic["intermediate_size"] = 32
    else:
        ic["max_position"] = 64
    if not dropout:
        ic["dropout"] = 0.0
    pc = c.get("predictor_config") or {}
    if "dnn_hidden_units" in pc:
        pc["dnn_hidden_units"] = [16, 16]
        if not dropout:
            pc["dnn_dropout"] = 0.0
    return cfg


def _nonzero_lora(tree, rng):
    return {k: (_nonzero_lora(v, rng) if isinstance(v, dict) else
                (rng.normal(0, 0.05, np.shape(v)).astype(np.float32)
                 if k == "lora_B" else np.asarray(v)))
            for k, v in tree.items()}


def build_pair(cfg, jdata, tdata, batch_size=BATCH):
    """The JAX Manager and the port's of one config, JAX's init (lora_B
    drawn non-zero) bridged into the port's model, and JAX's first
    training batch."""
    jm = JManager({}, cfg, data=jdata,
                  exp_cfg={"policy": {"batch_size": batch_size}})
    batch = next(jm.train_batcher(seed=0).epoch(shuffle=False))
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.jit(lambda b, c: jsteps.init_params(jm.model, b, c, seed=0))(
        batch, jm.contents.columns)
    tree = _nonzero_lora(jax.tree_util.tree_map(np.asarray, params),
                         np.random.default_rng(0))
    tm = Manager(model_cfg=cfg, data=tdata, device="cpu",
                 exp_cfg={"policy": {"batch_size": batch_size}})
    tm.model.load_state_dict(params_from_jax(tree, tm.model))
    return jm, tm, jax.tree_util.tree_map(jnp.asarray, tree), batch


@pytest.fixture(scope="module")
def jdata():
    return JSynthetic(**DATA_KW).as_lego_data()


@pytest.fixture(scope="module")
def tdata():
    return SyntheticProcessor(**DATA_KW).as_lego_data()


@pytest.mark.parametrize("name", MODELS)
def test_tester_and_forward_match_jax(name, jdata, tdata):
    jm, tm, params, batch = build_pair(model_cfg(name), jdata, tdata)
    op = tm.model.item_op
    assert type(op).__name__ == OPERATORS[name.split("-")[0]]
    assert op.num_hidden_layers == 2 and op.input_dim == 32
    want = np.asarray(jax.jit(lambda q, b, c: jm.model.apply(
        q, b, c, training=False))(params, batch, jm.contents.columns))
    tbatch = {k: torch.from_numpy(np.array(batch[k]))
              for k in ("candidates", "history", "mask")}
    with torch.no_grad():
        got = tm.model(tbatch, tm.contents.columns).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

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


@pytest.mark.parametrize("name", ["llama-naml", "glm-nrms", "opt-naml"])
def test_bf16_reprs_match_jax(name, jdata, tdata):
    """bf16 (the YAMLs' lm_dtype): the item reprs within 2e-2 of the
    largest."""
    cfg = model_cfg(name, lm_dtype="bf16")
    jm, tm, params, _ = build_pair(cfg, jdata, tdata)
    assert tm.model.item_op.lm.dtype == torch.bfloat16
    JTester(jm, params).test()
    Tester(tm).test()
    want = np.asarray(jm.cache.item_repr, np.float32)
    got = tm.cache.item_repr.float().numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("name", ["llama-iisan-naml", "llama-iisan-nrms",
                                  "llama-iisan-lstur", "llama-iisan-miner",
                                  "bert-iisan-naml"])
def test_iisan_yamls_raise(name, tdata):
    """The IISAN YAMLs raised until IISAN was ported; they build now
    (their parity with JAX: tests/test_torch_iisan_models.py), and what
    JAX refuses with them, `pipeline_stages` over the pooled states,
    raises when the slice runs staged under a pp mesh."""
    cfg = model_cfg(name)
    tm = Manager(model_cfg=cfg, data=tdata, device="cpu")
    op = tm.model.item_op
    assert type(op).__name__ == name.split("-")[0].title().replace(
        "Bert", "BertIISAN").replace("Llama", "LlamaIISAN") + "Operator"
    assert op.is_iisan and op.get_selected_layers() == [1]
    from legommenders_tpu_torch.parallel import mesh as tmesh

    cfg["config"]["item_config"]["pipeline_stages"] = 2
    op = Manager(model_cfg=cfg, data=tdata, device="cpu").model.item_op
    with tmesh.pipeline_parallel(tmesh.Mesh(1, 0, pp=2)):
        with pytest.raises(ValueError, match="IISAN pooled collection"):
            op.lm(torch.zeros(1, 3, op.input_dim),
                  torch.ones(1, 3, dtype=torch.int32))
