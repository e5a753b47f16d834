"""The port's offline drivers (sizer, transfer, extractor, splitter) vs the
JAX package's, called in-process (`SizerCLI(argv).run()`, `main(argv)`),
and the port's Trainer reading the splitter's cache.

Small sizes: the synthetic processor's default catalog (400 items, 200
users) processed once into a module tmp dir; NAML at hidden 16; bert-naml
cut to 2 layers of D 32 with 2 heads (f32; 3 layers where the splitter
caches two of them); dcn_id with its YAML's MLPs.
Both packages run from a working directory of their own in tmp_path (the
JAX CLI reads `config/` there: a link to the checkout's). Tolerances:
  * sizer totals: equal;
  * transfer's `.npy` and YAML: equal bit for bit;
  * extractor reprs from one JAX checkpoint: rtol and atol 1e-5 (as
    tests/test_torch_naml_serve.py);
  * splitter hidden states against JAX's build_lm_hidden on the same
    (bridged) weights: within 1e-5 of the largest value; masks equal.
"""
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BERT_SMALL = ["--hidden_size", "16", "--batch_size", "4", "--tune_from", "1",
              "--model.config.embedding_dim", "32",
              "--model.config.item_config.num_hidden_layers", "2",
              "--model.config.item_config.num_attention_heads", "2",
              "--model.config.item_config.lm_dtype", "f32"]
SIZER_CASES = {
    "naml": ["--model", "naml", "--hidden_size", "16"],
    "bert-naml": ["--model", "bert-naml"] + BERT_SMALL,
    "dcn_id": ["--model", "dcn_id", "--hidden_size", "16"],
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def synth_dir(tmp_path_factory):
    from legommenders_tpu_torch import process

    d = str(tmp_path_factory.mktemp("synth"))
    process.main(["--data", "synthetic", "--save_dir", d])
    return d


def _cwd(tmp_path, name, monkeypatch):
    """A working directory of its own, with `config` linked in."""
    where = tmp_path / name
    where.mkdir()
    os.symlink(os.path.join(ROOT, "config"), str(where / "config"))
    monkeypatch.chdir(where)
    return where


def _args(synth_dir, extra):
    return ["--data", "synthetic", "--data_dir", synth_dir] + extra


@pytest.mark.parametrize("case", sorted(SIZER_CASES))
def test_sizer_totals_equal_jax(case, synth_dir, tmp_path, monkeypatch,
                                capsys):
    import sizer as jsizer
    from legommenders_tpu_torch import sizer

    argv = _args(synth_dir, SIZER_CASES[case])
    _cwd(tmp_path, "jax", monkeypatch)
    want = jsizer.SizerCLI(argv).run()
    _cwd(tmp_path, "port", monkeypatch)
    got = sizer.SizerCLI(argv + ["--device", "cpu"]).run()
    assert got == want
    out = capsys.readouterr().out
    assert f"total: {got / 1e6:.3f}M params" in out
    if case == "bert-naml":
        # the frozen lower slice counts, as JAX's leaves do
        assert " frozen" in out and "item_op.lm_lower." in out


def _recbench(tmp_path, synth_dir):
    """A RecBench-style export: shuffled ids, one item missing."""
    from legommenders_tpu_torch.data.token_store import TokenStore

    vocab = TokenStore.load(os.path.join(synth_dir, "items")).vocab_of(
        "item_id")
    rng = np.random.default_rng(0)
    order = rng.permutation(len(vocab))
    ids = [vocab.tokens[i] for i in order[:-1]]
    emb = rng.standard_normal((len(vocab), 8)).astype(np.float32)
    np.save(str(tmp_path / "emb.npy"), emb)
    (tmp_path / "ids.txt").write_text("\n".join(ids))
    return vocab, ids, emb


@pytest.mark.parametrize("with_ids", [False, True])
def test_transfer_equals_jax(with_ids, synth_dir, tmp_path, monkeypatch):
    import transfer as jtransfer
    from legommenders_tpu_torch import transfer

    vocab, ids, emb = _recbench(tmp_path, synth_dir)
    argv = ["--data", "synthetic", "--data_dir", synth_dir,
            "--embed_path", str(tmp_path / "emb.npy")]
    if with_ids:
        argv += ["--item_id_file", str(tmp_path / "ids.txt")]
    outs = {}
    for side, main in (("jax", jtransfer.main), ("port", transfer.main)):
        where = tmp_path / side
        where.mkdir()
        monkeypatch.chdir(where)
        main(argv)
        outs[side] = (
            (where / "data/embeddings/synthetic-item-embeds.npy").read_bytes(),
            (where / "config/embed/synthetic-item-embeds.yaml").read_text())
    assert outs["port"] == outs["jax"]
    mat = np.load(str(tmp_path / "port/data/embeddings/"
                      "synthetic-item-embeds.npy"))
    if with_ids:
        assert mat[vocab.tokens.index(ids[0])].tobytes() == emb[0].tobytes()
        missing = (set(vocab.tokens) - set(ids)).pop()
        assert not mat[vocab.tokens.index(missing)].any()
    else:
        assert mat.tobytes() == emb.tobytes()


def test_extractor_equals_jax(synth_dir, tmp_path, monkeypatch):
    import extractor as jextractor
    from legommenders_tpu.runtime.checkpoint import save_checkpoint
    from legommenders_tpu.runtime.steps import init_params
    from legommenders_tpu_torch import extractor

    import jax.numpy as jnp

    argv = _args(synth_dir, ["--model", "naml", "--hidden_size", "16",
                             "--batch_size", "4", "--load_sign", "jaxinit"])
    _cwd(tmp_path, "jax", monkeypatch)
    jcli = jextractor.ExtractorCLI(argv + ["--export_dir", "out"])
    m = jcli.manager
    batch = next(m.train_batcher(jcli.seed).epoch(shuffle=False))
    params = init_params(m.model, {k: jnp.asarray(v) for k, v in
                                   batch.items()},
                         m.contents.columns, seed=5)
    ckpt = os.path.abspath(f"{jcli.ph.dir}/jaxinit.ckpt")
    save_checkpoint(ckpt, params)
    jcli.run()
    want = [np.load(f"out/{jcli.ph.signature}.{side}.npy")
            for side in ("items", "users")]

    where = _cwd(tmp_path, "port", monkeypatch)
    tcli = extractor.ExtractorCLI(argv + ["--export_dir", "out", "--device",
                                          "cpu"])
    os.makedirs(tcli.ph.dir, exist_ok=True)
    os.symlink(ckpt, f"{tcli.ph.dir}/jaxinit.ckpt")
    paths = tcli.run()
    assert paths == tuple(str(where / "out" / f"{tcli.ph.signature}.{s}.npy")
                          .replace(str(where) + "/", "")
                          for s in ("items", "users"))
    for path, w in zip(paths, want):
        got = np.load(path)
        assert got.dtype == np.float32 and got.shape == w.shape
        np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-5)


def _bert_cfgs(synth_dir, tune_from, layers=2):
    """The small bert-naml's raw configs, through the port's parser."""
    from legommenders_tpu_torch.cli.base import CONFIG_ROOT
    from legommenders_tpu_torch.config.parser import parse_four_way
    from legommenders_tpu_torch.utils.function import parse_cli

    cli = parse_cli(_args(synth_dir, ["--model", "bert-naml"] + BERT_SMALL))
    cli["tune_from"] = tune_from
    cli["model.config.item_config.num_hidden_layers"] = layers
    cfg = parse_four_way(cli, config_root=CONFIG_ROOT)
    return cfg.data.raw(), cfg.model.raw()


def test_splitter_equals_jax_build_lm_hidden(synth_dir, tmp_path):
    import jax
    import jax.numpy as jnp

    from legommenders_tpu.data.dataset import LegoData as JLegoData
    from legommenders_tpu.runtime import lm_cache as jlm_cache
    from legommenders_tpu.runtime.manager import Manager as JManager
    from legommenders_tpu.runtime.steps import init_params
    from legommenders_tpu_torch import splitter
    from legommenders_tpu_torch.bridge import params_from_jax
    from legommenders_tpu_torch.data.dataset import LegoData
    from legommenders_tpu_torch.runtime.manager import Manager

    data_cfg, model_cfg = _bert_cfgs(synth_dir, 1, layers=3)
    jdata, tdata = JLegoData.from_config(data_cfg), LegoData.from_config(
        data_cfg)
    want = {}

    def make_manager(layer):
        cfg = splitter.with_tune_from(model_cfg, layer)
        jm = JManager({}, cfg, data=jdata)
        batch = next(jm.train_batcher(0).epoch(shuffle=False))
        params = init_params(jm.model, {k: jnp.asarray(v) for k, v in
                                        batch.items()},
                             jm.contents.columns, seed=layer)
        want[layer] = jlm_cache.build_lm_hidden(
            jm.model, params, dict(jm.contents.columns), page_size=64)
        m = Manager(model_cfg=cfg, data=tdata, device="cpu")
        m.model.load_state_dict(params_from_jax(
            jax.tree_util.tree_map(np.asarray, params), m.model))
        return m

    op = Manager(model_cfg=model_cfg, data=tdata, device="cpu").model.item_op
    layers = splitter.resolve_layers("1+-1", op.num_hidden_layers)
    assert layers == [1, 2]
    out = splitter.split(make_manager, layers, root=str(tmp_path / "cache"),
                         log=lambda *_: None)
    for layer in layers:
        hpath = out[layer]
        assert len(hpath) == 1 and os.path.basename(hpath[0]).startswith(
            f"torch_layer_{layer}.")
        hidden = np.load(hpath[0])
        mask = np.load(hpath[0].replace(f"torch_layer_{layer}.",
                                        "torch_mask."))
        jh, jmask = want[layer]
        assert hidden.shape == jh.shape
        scale = float(np.abs(jh).max())
        assert float(np.abs(hidden - jh).max()) <= 1e-5 * scale
        assert np.array_equal(mask, jmask)


def test_trainer_reads_the_splitter_cache(synth_dir, tmp_path, monkeypatch):
    from legommenders_tpu_torch import splitter
    from legommenders_tpu_torch.data.dataset import LegoData
    from legommenders_tpu_torch.models.operators.lm_ops import LM_HIDDEN_KEY
    from legommenders_tpu_torch.runtime import lm_cache
    from legommenders_tpu_torch.runtime.manager import Manager
    from legommenders_tpu_torch.runtime.trainer import Trainer

    data_cfg, model_cfg = _bert_cfgs(synth_dir, 1)
    data = LegoData.from_config(data_cfg)
    exp = {"policy": {"batch_size": 4, "epoch": 1, "epoch_batch": 1}}
    root = str(tmp_path / "cache")

    def make_manager(layer):
        return Manager(model_cfg=splitter.with_tune_from(model_cfg, layer),
                       exp_cfg=exp, data=data, device="cpu", seed=3)

    files = splitter.split(make_manager, [1], root=root,
                           log=lambda *_: None)[1]
    m = make_manager(1)
    monkeypatch.setattr(lm_cache, "build_lm_hidden", _no_rebuild)
    tr = Trainer(m, seed=3, lm_cache_root=root)
    tr.init()
    hidden = m.contents.columns[LM_HIDDEN_KEY]
    disk = torch.from_numpy(np.load(files[0]))
    assert torch.equal(hidden[:, :disk.shape[1]], disk)
    assert np.isfinite(tr.train()["best_dev"])
    # another seed draws other weights: its cache is another file
    monkeypatch.undo()
    assert splitter.split(
        lambda layer: Manager(model_cfg=splitter.with_tune_from(
            model_cfg, layer), exp_cfg=exp, data=data, device="cpu",
            seed=4), [1], root=root, log=lambda *_: None)[1] != files


def _no_rebuild(*a, **k):
    raise AssertionError("the Trainer rebuilt a cache the splitter wrote")


def test_splitter_cli_wraps_and_regenerates(synth_dir, tmp_path,
                                            monkeypatch):
    from legommenders_tpu_torch import splitter

    _cwd(tmp_path, "port", monkeypatch)
    argv = _args(synth_dir, ["--model", "bert-naml"] + BERT_SMALL
                 + ["--layers", "-1", "--device", "cpu"])
    out = splitter.SplitterCLI(argv).run()
    assert list(out) == [1] and len(out[1]) == 1
    first = os.path.getmtime(out[1][0])
    again = splitter.SplitterCLI(argv + ["--regenerate", "1"]).run()
    assert again[1] == out[1] and os.path.getmtime(out[1][0]) >= first
    with pytest.raises(SystemExit, match="LM item operator"):
        splitter.SplitterCLI(_args(synth_dir, [
            "--model", "naml", "--hidden_size", "16", "--device",
            "cpu"])).run()
