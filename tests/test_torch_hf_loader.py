"""The HF weight maps of the port (models/lm/hf_loader.py) vs the JAX
package's, and the checkpoint load through Manager.load_lm_weights.

State dicts: tiny random-init `transformers` models (BERT, Llama with
grouped-query attention, OPT; 2 layers, D 32) and a synthetic ChatGLM3
dict (fused query_key_value with bias over 2 kv groups, fused
dense_h_to_4h, `transformer.encoder.` prefixes), as tests/test_hf_golden.py
and tests/test_glm_golden.py build them. Checked:
  * each family's map, for the whole LM, a lower slice and an upper slice,
    holds the tensors of JAX's map (through the bridge's renames and
    transposes), exactly;
  * a port slice loaded from the HF dict gives HF's own hidden states at
    f32 within 1e-5 (BERT and OPT at the valid positions, Llama with full
    masks, as the golden tests compare them), and a lower and an upper
    slice HF's intermediate and last ones; GLM's slice gives the JAX
    slice's outputs on the same dict within 1e-5;
  * Manager.load_lm_weights with a `.model` dotfile naming a directory
    that holds a pytorch_model.bin (or a model.safetensors) loads it as
    JAX's does: item reprs within 1e-5 and Tester.test() metrics within
    1e-5 of JAX's, in full-LM and layer-split mode; without an entry it
    warns and keeps the init; a stray or misshapen tensor raises.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legommenders_tpu.config import dotfiles as jdotfiles
from legommenders_tpu.data.processors.synthetic import (
    SyntheticProcessor as JSynthetic,
)
from legommenders_tpu.models.lm import hf_loader as jhf
from legommenders_tpu.models.lm import layers as jlayers
from legommenders_tpu.runtime.manager import Manager as JManager
from legommenders_tpu.runtime.steps import init_params
from legommenders_tpu.runtime.tester import Tester as JTester
from legommenders_tpu_torch.bridge import params_from_jax
from legommenders_tpu_torch.config import dotfiles
from legommenders_tpu_torch.data.processors.synthetic import SyntheticProcessor
from legommenders_tpu_torch.models.lm import hf_loader, layers
from legommenders_tpu_torch.runtime.manager import Manager
from legommenders_tpu_torch.runtime.tester import Tester

transformers = pytest.importorskip("transformers")

D, N = 32, 2
GLM_H, GLM_KV, GLM_FFN = 4, 2, 48


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hf(family):
    """A tiny random-init HF model of `family` in eval mode."""
    torch.manual_seed({"bert": 0, "llama": 2, "opt": 1}[family])
    if family == "bert":
        cfg = transformers.BertConfig(
            vocab_size=50, hidden_size=D, num_hidden_layers=N,
            num_attention_heads=2, intermediate_size=4 * D,
            max_position_embeddings=40, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
        return transformers.BertModel(cfg).eval()
    if family == "llama":
        cfg = transformers.LlamaConfig(
            vocab_size=50, hidden_size=D, num_hidden_layers=N,
            num_attention_heads=4, num_key_value_heads=2,
            intermediate_size=64, max_position_embeddings=64,
            rope_theta=10000.0, attention_dropout=0.0)
        return transformers.LlamaModel(cfg).eval()
    cfg = transformers.OPTConfig(
        vocab_size=50, hidden_size=D, num_hidden_layers=N,
        num_attention_heads=2, ffn_dim=4 * D, max_position_embeddings=40,
        dropout=0.0, attention_dropout=0.0, do_layer_norm_before=True,
        word_embed_proj_dim=D)
    return transformers.OPTModel(cfg).eval()


def _glm_sd(seed=0, d_model=D, layers_=N, ffn=GLM_FFN):
    """A ChatGLM3-layout state dict (torch tensors)."""
    rng = np.random.default_rng(seed)
    d = d_model // GLM_H
    sd = {}

    def w(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32) * 0.1)

    for i in range(layers_):
        p = f"transformer.encoder.layers.{i}."
        sd[p + "input_layernorm.weight"] = 1.0 + w(d_model)
        sd[p + "self_attention.query_key_value.weight"] = w(
            (GLM_H + 2 * GLM_KV) * d, d_model)
        sd[p + "self_attention.query_key_value.bias"] = w(
            (GLM_H + 2 * GLM_KV) * d)
        sd[p + "self_attention.dense.weight"] = w(d_model, d_model)
        sd[p + "post_attention_layernorm.weight"] = 1.0 + w(d_model)
        sd[p + "mlp.dense_h_to_4h.weight"] = w(2 * ffn, d_model)
        sd[p + "mlp.dense_4h_to_h.weight"] = w(d_model, ffn)
    sd["transformer.encoder.final_layernorm.weight"] = 1.0 + w(d_model)
    return sd


def _port_slice(family, start, n, top):
    """The port slice a map fills, at f32, without LoRA."""
    if family == "bert":
        return layers.BertEncoderSlice(n, D, num_heads=2, start=start,
                                       embed=start == 0, max_position=40,
                                       dropout=0.0)
    if family == "llama":
        return layers.LlamaDecoderSlice(n, D, num_heads=4, num_kv_heads=2,
                                        intermediate_size=64, start=start,
                                        final_norm=top, dtype=torch.float32)
    if family == "glm":
        return layers.LlamaDecoderSlice(
            n, D, num_heads=GLM_H, num_kv_heads=GLM_KV,
            intermediate_size=GLM_FFN, start=start, final_norm=top,
            qkv_bias=True, rotary_fraction=0.5, rotary_interleaved=True,
            dtype=torch.float32)
    return layers.OPTDecoderSlice(n, D, num_heads=2, start=start,
                                  embed_positions=start == 0,
                                  final_norm=top, max_position=40,
                                  dtype=torch.float32)


def _maps(family, sd, start, n, top):
    """(JAX's map on numpy arrays, the port's map)."""
    npsd = {k: v.detach().float().numpy() for k, v in sd.items()}
    if family == "bert":
        return (jhf.bert_slice_params(npsd, start, n, embed=True),
                hf_loader.bert_slice_params(sd, start, n, embed=True))
    if family == "llama":
        return (jhf.llama_slice_params(npsd, start, n, final_norm=top),
                hf_loader.llama_slice_params(sd, start, n, final_norm=top))
    if family == "glm":
        return (jhf.glm_slice_params(npsd, start, n, GLM_H, GLM_KV, top),
                hf_loader.glm_slice_params(sd, start, n, GLM_H, GLM_KV, top))
    return (jhf.opt_slice_params(npsd, start, n, True, top),
            hf_loader.opt_slice_params(sd, start, n, True, top))


def _state_dict(family):
    return _glm_sd() if family == "glm" else _hf(family).state_dict()


SLICES = [(0, N, True), (0, 1, False), (1, 1, True)]


@pytest.mark.parametrize("family", ["bert", "llama", "opt", "glm"])
@pytest.mark.parametrize("start,n,top", SLICES)
def test_maps_equal_jax(family, start, n, top):
    sd = _state_dict(family)
    jmap, tmap = _maps(family, sd, start, n, top)
    slice_ = _port_slice(family, start, n, top)
    want = params_from_jax(jmap, slice_)   # raises on a stray or a gap
    assert sorted(tmap) == sorted(want)
    for k, v in tmap.items():
        assert torch.equal(v.float(), want[k]), k


def _ids_mask(L=7):
    rng = np.random.default_rng(3)
    ids = rng.integers(1, 50, size=(2, L))
    mask = np.ones((2, L), np.int64)
    mask[1, L - 2:] = 0
    return torch.from_numpy(ids), torch.from_numpy(mask)


def _loaded(family, sd, start, n, top):
    slice_ = _port_slice(family, start, n, top)
    hf_loader.merge_lm_params(slice_, _maps(family, sd, start, n, top)[1],
                              path="")
    return slice_.eval()


@pytest.mark.parametrize("family", ["bert", "llama", "opt"])
def test_port_slice_matches_hf(family):
    model = _hf(family)
    sd = model.state_dict()
    ids, mask = _ids_mask()
    if family == "llama":
        mask = torch.ones_like(mask)    # HF Llama's padding is another rule
    with torch.no_grad():
        hs = model(input_ids=ids, attention_mask=mask,
                   output_hidden_states=True).hidden_states
        table = {"bert": "embeddings.word_embeddings.weight",
                 "llama": "embed_tokens.weight",
                 "opt": "decoder.embed_tokens.weight"}[family]
        x = sd[table][ids]
        full = _loaded(family, sd, 0, N, True)(x, mask)
        lower = _loaded(family, sd, 0, 1, False)(x, mask)
        upper = _loaded(family, sd, 1, 1, True)(lower, mask)
    valid = mask.bool()
    # BERT's and OPT's hidden_states[1] is layer 0's output; the last
    # entry of each is the slice's output (OPT and Llama after the norm)
    for got, want in ((full, hs[-1]), (lower, hs[1]), (upper, hs[-1])):
        torch.testing.assert_close(got[valid].float(), want[valid],
                                   rtol=1e-5, atol=1e-5)


def test_glm_port_slice_matches_jax_slice():
    """The GLM slices on the synthetic ChatGLM dict: the port's map into
    the port's slice against JAX's map into JAX's, whole and split."""
    sd = _glm_sd(seed=4)
    npsd = {k: v.numpy() for k, v in sd.items()}
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 7, D)).astype(np.float32)
    mask = np.ones((3, 7), np.int32)
    mask[1, 5:] = 0
    mask[2, 2:] = 0
    for start, n, top in SLICES:
        jmod = jlayers.LlamaDecoderSlice(
            num_layers=n, num_heads=GLM_H, num_kv_heads=GLM_KV,
            intermediate_size=GLM_FFN, start=start, final_norm=top,
            qkv_bias=True, rotary_fraction=0.5, rotary_interleaved=True,
            dtype=jnp.float32)
        want = np.asarray(jmod.apply(
            {"params": jhf.glm_slice_params(npsd, start, n, GLM_H, GLM_KV,
                                            top)},
            jnp.asarray(x), jnp.asarray(mask)))
        with torch.no_grad():
            got = _loaded("glm", sd, start, n, top)(
                torch.from_numpy(x), torch.from_numpy(mask)).numpy()
        valid = mask.astype(bool)
        np.testing.assert_allclose(got[valid], want[valid], rtol=1e-5,
                                   atol=1e-5)


def test_load_torch_state_dict_reads_both_formats(tmp_path):
    sd = {k: v.clone() for k, v in _hf("llama").state_dict().items()}
    torch.save(sd, tmp_path / "pytorch_model.bin")
    got = hf_loader.load_torch_state_dict(str(tmp_path))
    assert sorted(got) == sorted(sd)
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    st = pytest.importorskip("safetensors.torch")
    st.save_file(sd, str(tmp_path / "model.safetensors"))
    got = hf_loader.load_torch_state_dict(str(tmp_path))
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    with pytest.raises(FileNotFoundError):
        hf_loader.load_torch_state_dict(str(tmp_path / "none"))


def test_merge_refuses_strays_and_shapes():
    sd = _hf("llama").state_dict()
    mapped = hf_loader.llama_slice_params(sd, 0, N, final_norm=True)
    slice_ = _port_slice("llama", 0, N, True)
    with pytest.raises(KeyError, match="not a parameter"):
        hf_loader.merge_lm_params(slice_, {**mapped, "layer_9.x": sd[
            "norm.weight"]}, path="")
    bad = dict(mapped, **{"final_norm.weight": torch.zeros(D + 1)})
    with pytest.raises(ValueError, match="checkpoint's"):
        hf_loader.merge_lm_params(slice_, bad, path="")
    # the LoRA factors a map does not hold stay as they are
    lora = layers.LlamaDecoderSlice(N, D, num_heads=4, num_kv_heads=2,
                                    intermediate_size=64, lora_r=2,
                                    dtype=torch.float32)
    before = lora.layer_0.q_proj.lora_A.detach().clone()
    loaded = hf_loader.merge_lm_params(lora, mapped, path="")
    assert loaded == sorted(mapped)
    assert torch.equal(lora.layer_0.q_proj.lora_A, before)
    assert torch.equal(lora.layer_1.down_proj.weight,
                       sd["layers.1.mlp.down_proj.weight"])


DATA_KW = dict(num_items=40, num_users=20, title_len=8, history_len=6,
               vocab_size=200, inters_per_user=6)
# (YAML item operator, operator key of the dotfile, item_config, HF dict)
LOADS = {
    "llama": ("Llama1", "llama1", dict(num_attention_heads=4,
                                       num_kv_heads=2, intermediate_size=64)),
    "opt": ("OPTBase", "optbase", dict(num_attention_heads=2,
                                       max_position=40)),
    "glm": ("GLM", "glm", dict(num_attention_heads=GLM_H,
                               num_kv_heads=GLM_KV,
                               intermediate_size=GLM_FFN)),
    "bert": ("BertBase", "bertbase", dict(num_attention_heads=2,
                                          max_position=40)),
}


def _model_cfg(family, tune_from):
    item, _, extra = LOADS[family]
    return {"meta": {"item": item, "user": "Ada", "predictor": "Dot"},
            "config": {"use_item_content": True, "hidden_size": 16,
                       "embedding_dim": D, "cache_page_size": 16,
                       "item_config": {
                           "lm_dtype": "f32", "num_hidden_layers": N,
                           "tune_from": tune_from, "use_lora": True,
                           "lora_r": 4, "lora_dropout": 0.0,
                           "lora_fold": True, "fused_attention": True,
                           "dropout": 0.0, "additive_hidden_size": 16,
                           **extra},
                       "user_config": {"additive_hidden_size": 16}}}


@pytest.mark.parametrize("family,tune_from", [("llama", 1), ("opt", None),
                                              ("glm", None), ("bert", 1)])
def test_manager_loads_a_local_checkpoint(family, tune_from, tmp_path,
                                          monkeypatch):
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    torch.save(_state_dict(family), ckpt / "pytorch_model.bin")
    key = LOADS[family][1]
    (tmp_path / ".model").write_text(f"{key}: {ckpt}\n")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    jdotfiles.ModelInit.reload()
    dotfiles.ModelInit.reload()
    try:
        cfg = _model_cfg(family, tune_from)
        jm = JManager({}, cfg, data=JSynthetic(**DATA_KW).as_lego_data(),
                      exp_cfg={"policy": {"batch_size": 4}})
        batch = next(jm.train_batcher(seed=0).epoch(shuffle=False))
        params = jax.jit(lambda b, c: init_params(jm.model, b, c, seed=0))(
            {k: jnp.asarray(v) for k, v in batch.items()},
            jm.contents.columns)
        tm = Manager(model_cfg=cfg, device="cpu",
                     data=SyntheticProcessor(**DATA_KW).as_lego_data())
        tm.model.load_state_dict(params_from_jax(
            jax.tree_util.tree_map(np.asarray, params), tm.model))
        init = {k: v.clone() for k, v in tm.model.state_dict().items()}
        params, loaded = jm.load_lm_weights(params)
        assert loaded and tm.load_lm_weights()
        # the LM's base weights changed; the LoRA factors and the head not
        changed = {k for k, v in tm.model.state_dict().items()
                   if not torch.equal(v, init[k])}
        assert changed and all(k.startswith("item_op.lm") and "lora_" not in k
                               for k in changed)
        if tune_from:
            assert jm.prepare_lm_cache(params) and tm.prepare_lm_cache(
                root=None)
        want = JTester(jm, params).test()
        got = Tester(tm).test()
    finally:
        jdotfiles.ModelInit.reload()
        dotfiles.ModelInit.reload()
    np.testing.assert_allclose(tm.cache.item_repr.numpy(),
                               np.asarray(jm.cache.item_repr), rtol=1e-5,
                               atol=1e-5)
    for k in want:
        assert abs(got[k] - want[k]) < 1e-5, (k, got[k], want[k])


def test_manager_without_a_checkpoint_keeps_the_init(tmp_path, monkeypatch,
                                                     caplog):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HOME", str(tmp_path))
    dotfiles.ModelInit.reload()
    try:
        tm = Manager(model_cfg=_model_cfg("llama", None), device="cpu",
                     data=SyntheticProcessor(**DATA_KW).as_lego_data())
        before = {k: v.clone() for k, v in tm.model.state_dict().items()}
        assert not tm.load_lm_weights()
    finally:
        dotfiles.ModelInit.reload()
    assert all(torch.equal(v, before[k])
               for k, v in tm.model.state_dict().items())
    assert not os.path.exists(tmp_path / "cache")
