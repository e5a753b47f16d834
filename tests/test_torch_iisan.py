"""IISAN's parts in the port vs the JAX package, on the CPU, on bridged
weights, f32 unless stated:
  * `collect_pooled` of the BERT, Llama (grouped-query), GLM and OPT
    slices (2 layers, D 32, from the embedding stage, no LoRA, no final
    norm: IISAN's frozen LM) over 7 items of 9 tokens of random valid
    lengths, with packing off and auto: the per-layer masked means (7, 2,
    32) within 1e-5 (the port's slice through the attention kernel's plain
    version, as IISAN builds it; JAX's through XLA's attention, as JAX's
    IISAN builds it); bf16 within 2e-2 of the largest;
  * SANBlock, and each IISAN operator (BertIISAN, LlamaIISAN, OPTIISAN,
    GLMIISAN) over 3 layers: its selected layers, the all-layer pooled
    states of `encode_lower` and the side network's output over random
    cached states, with and without `global_proj_size` /
    `local_proj_size`, at `layer_selection_step` 1 and 2, within 1e-5;
  * the IISAN cache of bert-iisan-naml (a 60-item catalog) against JAX's
    `load_or_build_iisan_cache`, the f32 states on disk read back, and the
    operator's refusal of states that are not its cached layers.
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
from legommenders_tpu.models.lm import layers as jlayers
from legommenders_tpu.models.operators import iisan as jiisan
from legommenders_tpu.runtime import lm_cache as jlm_cache
from legommenders_tpu.runtime import steps as jsteps
from legommenders_tpu.runtime.manager import Manager as JManager
from legommenders_tpu_torch.bridge import params_from_jax
from legommenders_tpu_torch.config import parser
from legommenders_tpu_torch.data.processors.synthetic import SyntheticProcessor
from legommenders_tpu_torch.models.lm import layers
from legommenders_tpu_torch.models.operators import iisan
from legommenders_tpu_torch.models.operators.lm_ops import (
    LM_HIDDEN_KEY, LM_MASK_KEY,
)
from legommenders_tpu_torch.runtime.manager import Manager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, L, D = 7, 9, 32
# the frozen LM of each family: 2 layers from the embedding stage
SLICES = {
    "bert": dict(num_heads=2),
    "llama_gqa": dict(num_heads=4, num_kv_heads=2, intermediate_size=48,
                      final_norm=False),
    "glm": dict(num_heads=4, num_kv_heads=2, qkv_bias=True,
                rotary_fraction=0.5, rotary_interleaved=True,
                intermediate_size=48, final_norm=False),
    "opt": dict(num_heads=2, max_position=64, final_norm=False),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    lens = rng.integers(1, L + 1, B)
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int32)
    return x, mask


def _slice_pair(family, pack, jdtype=jnp.float32, tdtype=torch.float32):
    kw = dict(SLICES[family], num_layers=2, attention_pack=pack,
              collect_pooled=True)
    if family == "bert":
        jmod = jlayers.BertEncoderSlice(dropout=0.0, dtype=jdtype, **kw)
        tmod = layers.BertEncoderSlice(dim=D, dropout=0.0, dtype=tdtype,
                                       fused_attention=True, **kw)
    elif family == "opt":
        jmod = jlayers.OPTDecoderSlice(dtype=jdtype, **kw)
        tmod = layers.OPTDecoderSlice(dim=D, dtype=tdtype,
                                      fused_attention=True, **kw)
    else:
        jmod = jlayers.LlamaDecoderSlice(dtype=jdtype, **kw)
        tmod = layers.LlamaDecoderSlice(dim=D, dtype=tdtype,
                                        fused_attention=True, **kw)
    x, mask = _inputs()
    tree = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(mask),
                     False)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    tmod.load_state_dict(params_from_jax(tree, tmod))
    return jmod, tree, tmod


@pytest.mark.parametrize("pack", [0, -1])
@pytest.mark.parametrize("family", list(SLICES))
def test_collect_pooled_matches_jax(family, pack):
    jmod, tree, tmod = _slice_pair(family, pack)
    x, mask = _inputs()
    want = np.asarray(jmod.apply(tree, jnp.asarray(x), jnp.asarray(mask),
                                 False))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (B, 2, D)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("family", ["bert", "llama_gqa"])
def test_collect_pooled_bf16_matches_jax(family):
    """The mean in the LM dtype, as JAX takes it: within 2e-2."""
    jmod, tree, tmod = _slice_pair(family, -1, jnp.bfloat16, torch.bfloat16)
    x, mask = _inputs(1)
    want = np.asarray(jmod.apply(tree, jnp.asarray(x), jnp.asarray(mask),
                                 False), np.float32)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16 or family != "bert"
    got = got.float().numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_san_block_matches_jax():
    x = np.random.default_rng(2).standard_normal((5, D)).astype(np.float32)
    jmod = jiisan.SANBlock()
    tree = jax.tree_util.tree_map(
        np.asarray, jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    tmod = iisan.SANBlock(D)
    tmod.load_state_dict(params_from_jax(tree, tmod))
    want = np.asarray(jmod.apply(tree, jnp.asarray(x)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


FAMILY_OPS = {
    "bert": ("BertIISANOperator", dict(num_attention_heads=2)),
    "llama": ("LlamaIISANOperator", dict(num_attention_heads=4,
                                          num_kv_heads=2,
                                          intermediate_size=48)),
    "opt": ("OPTIISANOperator", dict(num_attention_heads=2,
                                      max_position=64)),
    "glm": ("GLMIISANOperator", dict(num_attention_heads=4,
                                      intermediate_size=48)),
}
# (global_proj_size, local_proj_size, layer_selection_step)
SIDES = [(None, None, 2), (16, None, 2), (None, 8, 1), (16, 8, 1)]


def _op_pair(family, global_proj, local_proj, step):
    name, kw = FAMILY_OPS[family]
    common = dict(hidden_size=16, num_hidden_layers=3, lm_dtype=jnp.float32,
                  layer_selection_step=step, global_proj_size=global_proj,
                  local_proj_size=local_proj, dropout=0.0, **kw)
    jop = getattr(jiisan, name)(**common)
    n_sel = len(jop.get_selected_layers())
    x, mask = _inputs(3)
    states = np.random.default_rng(4).standard_normal(
        (B, n_sel, D)).astype(np.float32)

    def both(m, e, mk, s):
        return m.encode_lower(e, mk), m(s)

    tree = jop.init(jax.random.PRNGKey(5), jnp.asarray(x), jnp.asarray(mask),
                    jnp.asarray(states), method=both)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    common.update(lm_dtype=torch.float32, input_dim=D)
    top = getattr(iisan, name)(**common)
    top.load_state_dict(params_from_jax(tree, top))
    return jop, tree, top, (x, mask, states, both)


@pytest.mark.parametrize("global_proj,local_proj,step", SIDES)
@pytest.mark.parametrize("family", list(FAMILY_OPS))
def test_iisan_operator_matches_jax(family, global_proj, local_proj, step):
    jop, tree, top, (x, mask, states, both) = _op_pair(
        family, global_proj, local_proj, step)
    assert top.get_selected_layers() == jop.get_selected_layers() == (
        [0, 1, 2] if step == 1 else [0, 2])
    assert top.transformer_key == family and top.is_iisan
    assert top.use_lm_cache and not any(p.requires_grad
                                         for p in top.lm.parameters())
    want_lower, want = jop.apply(tree, jnp.asarray(x), jnp.asarray(mask),
                                 jnp.asarray(states), method=both)
    with torch.no_grad():
        lower = top.encode_lower(torch.from_numpy(x), torch.from_numpy(mask))
        got = top(torch.from_numpy(states))
    assert lower.shape == (B, 3, D) and got.shape == (B, 16)
    np.testing.assert_allclose(lower.numpy(), np.asarray(want_lower),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_iisan_operator_refuses_uncached_input():
    _, _, top, (x, mask, _, _) = _op_pair("bert", None, None, 2)
    with pytest.raises(ValueError, match="prepare_lm_cache"):
        top(torch.from_numpy(x), torch.from_numpy(mask))


DATA_KW = dict(num_items=60, num_users=30, title_len=8, history_len=6,
               vocab_size=200, inters_per_user=6)


def iisan_cfg(name: str, **item_config) -> dict:
    """An IISAN YAML made small: 3 layers of D 32 (2 selected), 4 heads,
    hidden 16, f32, dropout 0."""
    cfg = parser.parse_four_way({"model": name, "hidden_size": 16,
                                 "lm_dtype": "f32"},
                                config_root=os.path.join(ROOT, "config"))
    cfg = copy.deepcopy(cfg.raw()["model"])
    c = cfg["config"]
    c.update(embedding_dim=32, cache_page_size=16)
    ic = c["item_config"]
    ic.update(num_hidden_layers=3, num_attention_heads=4, dropout=0.0,
              **item_config)
    if name.startswith(("llama", "glm")):
        ic["intermediate_size"] = 32
    if name.startswith("opt"):
        ic["max_position"] = 64
    return cfg


def test_iisan_cache_matches_jax(tmp_path):
    cfg = iisan_cfg("bert-iisan-naml")
    jm = JManager({}, cfg, data=JSynthetic(**DATA_KW).as_lego_data(),
                  exp_cfg={"policy": {"batch_size": 8}})
    batch = next(jm.train_batcher(seed=0).epoch(shuffle=False))
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jsteps.init_params(jm.model, batch, jm.contents.columns, seed=0)
    tree = jax.tree_util.tree_map(np.asarray, params)
    tm = Manager(model_cfg=cfg, data=SyntheticProcessor(**DATA_KW)
                 .as_lego_data(), device="cpu")
    tm.model.load_state_dict(params_from_jax(tree, tm.model))
    op = jm.model.item_op
    want = jlm_cache.load_or_build_iisan_cache(
        jm.model, params, dict(jm.contents.columns), jm.data.name,
        op.transformer_key, op.get_selected_layers(), page_size=16,
        root=str(tmp_path / "jax"))
    root = str(tmp_path / "port")
    assert tm.prepare_lm_cache(root=root)
    got = tm.contents.columns
    assert got[LM_HIDDEN_KEY].dtype == torch.float32
    assert got[LM_HIDDEN_KEY].shape == (60, 2, 32)
    np.testing.assert_allclose(got[LM_HIDDEN_KEY].numpy(),
                               np.asarray(want[LM_HIDDEN_KEY]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(got[LM_MASK_KEY].numpy(),
                                  np.asarray(want[LM_MASK_KEY]))
    # the all-layer f32 states on disk, under the family's iisan directory
    d = os.path.join(root, tm.data.name, "bertiisan")
    (f,) = os.listdir(d)
    assert f.startswith("torch_states.")
    assert np.load(os.path.join(d, f)).shape == (60, 3, 32)
    again = Manager(model_cfg=cfg, data=tm.data, device="cpu")
    again.model.load_state_dict(tm.model.state_dict())
    assert again.prepare_lm_cache(root=root)
    assert torch.equal(again.contents.columns[LM_HIDDEN_KEY],
                       got[LM_HIDDEN_KEY])
