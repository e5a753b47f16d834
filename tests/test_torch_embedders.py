"""The port's embedders and its embed CLI vs the JAX package's.

Small sizes: a GloVe text of 6 words x 4, tiny random-init `transformers`
models (BERT, Llama, OPT: vocab 64-ish, D 16-32) saved with
save_pretrained into tmp_path (safetensors, and pytorch_model.bin for
one), and a synthetic ChatGLM3-layout state dict (`pytorch_model.bin`;
JAX's AutoModel cannot read it: the port's table is held against the
tensor written). Tolerances: the exported `.npy` and YAML equal JAX's bit
for bit (the tables are f32 in both).
"""
import os
import sys

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _glove(tmp_path):
    path = tmp_path / "glove.txt"
    rng = np.random.default_rng(0)
    lines = [" ".join([w] + [f"{v:.5f}" for v in rng.normal(size=4)])
             for w in ("the", "a", "news", "sport", "bad", "x")]
    lines.insert(3, "short 0.1 0.2")   # a line of another width is skipped
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _export(embedder_cls, model_path, where, monkeypatch):
    os.makedirs(where, exist_ok=True)
    monkeypatch.chdir(where)
    path, cfg_path = embedder_cls(model_path=model_path).export()
    return (np.load(os.path.join(where, path)),
            open(os.path.join(where, cfg_path)).read(), path, cfg_path)


def test_glove_export_equals_jax(tmp_path, monkeypatch):
    from legommenders_tpu.embedders.glove import GloVeEmbedder as JGloVe
    from legommenders_tpu_torch.embedders.glove import GloVeEmbedder

    src = _glove(tmp_path)
    want = _export(lambda model_path: JGloVe(model_path, dim=4), src,
                   tmp_path / "jax", monkeypatch)
    got = _export(lambda model_path: GloVeEmbedder(model_path, dim=4), src,
                  tmp_path / "port", monkeypatch)
    assert got[0].dtype == np.float32 and got[0].shape == (6, 4)
    assert got[0].tobytes() == want[0].tobytes()
    assert got[1:] == want[1:]
    assert GloVeEmbedder(src, dim=4).get_vocab() == [
        "the", "a", "news", "sport", "bad", "x"]


def _hf_model(family, seed=0):
    torch.manual_seed(seed)
    if family == "bert":
        cfg = transformers.BertConfig(
            vocab_size=61, hidden_size=32, num_hidden_layers=1,
            num_attention_heads=2, intermediate_size=48)
        return transformers.BertModel(cfg)
    if family == "llama":
        cfg = transformers.LlamaConfig(
            vocab_size=67, hidden_size=32, num_hidden_layers=1,
            num_attention_heads=4, num_key_value_heads=2,
            intermediate_size=48)
        return transformers.LlamaModel(cfg)
    cfg = transformers.OPTConfig(
        vocab_size=71, hidden_size=32, num_hidden_layers=1,
        num_attention_heads=2, ffn_dim=48, word_embed_proj_dim=32)
    return transformers.OPTModel(cfg)


# the registered name of each family's embedder, and whether the
# checkpoint is written as pytorch_model.bin (else model.safetensors)
HF_CASES = [("bertbase", "bert", False), ("bertlarge", "bert", True),
            ("llama", "llama", False), ("opt", "opt", False)]


@pytest.mark.parametrize("name,family,as_bin", HF_CASES)
def test_hf_export_equals_jax(name, family, as_bin, tmp_path, monkeypatch):
    from legommenders_tpu.utils.registry import EMBEDDERS as JEMBEDDERS
    from legommenders_tpu_torch.utils.registry import EMBEDDERS
    import legommenders_tpu.embedders  # noqa: F401
    import legommenders_tpu_torch.embedders  # noqa: F401

    ckpt = tmp_path / "ckpt"
    model = _hf_model(family)
    model.save_pretrained(str(ckpt), safe_serialization=not as_bin)
    assert (ckpt / ("pytorch_model.bin" if as_bin
                    else "model.safetensors")).is_file()
    want = _export(JEMBEDDERS[name], str(ckpt), tmp_path / "jax",
                   monkeypatch)
    # the port reads the checkpoint without transformers
    monkeypatch.setitem(sys.modules, "transformers", None)
    got = _export(EMBEDDERS[name], str(ckpt), tmp_path / "port",
                  monkeypatch)
    assert got[0].shape == tuple(
        model.get_input_embeddings().weight.shape)
    assert got[0].tobytes() == want[0].tobytes()
    assert got[1:] == want[1:]


def test_glm_export_reads_the_chatglm_layout(tmp_path, monkeypatch):
    from legommenders_tpu_torch.embedders.hf import GLMEmbedder

    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.normal(size=(50, 16)).astype(np.float32))
    sd = {"transformer.embedding.word_embeddings.weight": table,
          "transformer.encoder.layers.0.input_layernorm.weight":
              torch.ones(16)}
    ckpt = tmp_path / "glm"
    ckpt.mkdir()
    torch.save(sd, str(ckpt / "pytorch_model.bin"))
    monkeypatch.setitem(sys.modules, "transformers", None)
    got, cfg, path, _ = _export(GLMEmbedder, str(ckpt), tmp_path / "port",
                                monkeypatch)
    assert got.tobytes() == table.numpy().tobytes()
    assert "vocab_name: glm" in cfg and path == "data/embeddings/glm.npy"


def test_hf_embedder_without_a_checkpoint_raises():
    from legommenders_tpu_torch.embedders.hf import BertBaseEmbedder

    with pytest.raises(FileNotFoundError, match="local HF checkpoint"):
        BertBaseEmbedder().get_embeddings()


def test_embed_cli_equals_jax(tmp_path, monkeypatch):
    sys.path.insert(0, ROOT)
    import embed as jembed     # the JAX package's CLI at the repo root
    from legommenders_tpu_torch import embed

    # the CLI's GloVe is 300 wide (glove.6B.300d)
    rng = np.random.default_rng(2)
    src = str(tmp_path / "glove.6B.300d.txt")
    with open(src, "w") as f:
        for w in ("the", "a", "news"):
            f.write(" ".join([w] + [f"{v:.5f}" for v in rng.normal(
                size=300)]) + "\n")
    outs = {}
    for side, main in (("jax", jembed.main), ("port", embed.main)):
        where = tmp_path / side
        where.mkdir()
        monkeypatch.chdir(where)
        main(["--model", "GloVeEmbedder", "--model_path", src])
        outs[side] = ((where / "data/embeddings/glove.npy").read_bytes(),
                      (where / "config/embed/glove.yaml").read_text())
    assert outs["port"] == outs["jax"]
    with pytest.raises(SystemExit, match="unknown embedder"):
        embed.main(["--model", "nope"])
    with pytest.raises(SystemExit, match="--model is required"):
        embed.main([])


def test_exported_table_loads_frozen(tmp_path, monkeypatch):
    """An exported config (its vocab_name set to the data's, as the CLI
    asks) gives a NAML Manager that table, frozen, behind the auto
    transform."""
    from legommenders_tpu_torch.data.processors.synthetic import (
        SyntheticProcessor,
    )
    from legommenders_tpu_torch.embedders.glove import GloVeEmbedder
    from legommenders_tpu_torch.runtime.manager import Manager
    from legommenders_tpu_torch.utils.io import yaml_load

    rng = np.random.default_rng(1)
    src = tmp_path / "vectors.txt"
    src.write_text("".join(
        " ".join([f"w{i}"] + [f"{v:.4f}" for v in rng.normal(size=8)])
        + "\n" for i in range(60)))
    monkeypatch.chdir(tmp_path)
    path, cfg_path = GloVeEmbedder(str(src), dim=8).export()
    embed_cfg = yaml_load(cfg_path)
    embed_cfg["embeddings"][0]["vocab_name"] = "word"
    data = SyntheticProcessor(num_items=20, num_users=10, title_len=5,
                              history_len=4, vocab_size=60,
                              inters_per_user=4).as_lego_data()
    m = Manager(model_cfg={
        "meta": {"item": "CNN", "user": "Ada", "predictor": "Dot"},
        "config": {"use_item_content": True, "hidden_size": 16}},
        embed_cfg=embed_cfg, data=data, device="cpu")
    table = m.model.eh.tables["vocab__word"]
    assert not table.requires_grad
    assert torch.equal(table.detach(), torch.from_numpy(np.load(path)))
    assert "vocab__word" in m.model.eh.transforms
