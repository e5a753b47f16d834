"""The real-dataset processors and tokenizers in the port vs the JAX package.

Each JAX test of tests/test_processors.py has its counterpart here, on
the same fake raw layouts (a tiny MIND `train/` + `dev/` with news.tsv and
behaviors.tsv, xMIND news, RecBench parquet, a GloVe text file, an HF
tokenizer built in tmp_path from the installed `tokenizers`), run through
both packages: every store must agree with JAX's column by column
exactly, with the same vocabularies (tokens in order, sizes) and column
bindings. Besides: the port's `process` CLI with `--tokenizers` (glove
on MIND, an xMIND language; `word` on MIND is refused by both packages,
its vocabulary's name being MIND's own), the HF tokenizer through the
`.model` dotfile, and NAML
trained through the port for 10 Adam steps on the processed MIND stores,
each loss within 1e-5 relative of JAX's on the same batches and weights,
then tested.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from legommenders_tpu.utils.registry import PROCESSORS as JPROCESSORS
import legommenders_tpu.data.processors  # noqa: F401
from legommenders_tpu_torch.utils.registry import PROCESSORS
import legommenders_tpu_torch.data.processors  # noqa: F401


@pytest.fixture(scope="module")
def fake_mind(tmp_path_factory):
    """Tiny MIND raw layout: train/ + dev/ with news.tsv + behaviors.tsv
    (tests/test_processors.py's, from its own seed)."""
    rng = np.random.default_rng(2023)
    root = tmp_path_factory.mktemp("mind_raw")
    cats = ["news", "sports", "finance"]
    nids = [f"N{i}" for i in range(30)]
    for split in ("train", "dev"):
        d = root / split
        d.mkdir()
        with open(d / "news.tsv", "w") as f:
            for i, nid in enumerate(nids):
                f.write(f"{nid}\t{cats[i % 3]}\tsub{i % 5}\t"
                        f"Title words number {i} extra\t"
                        f"Abstract text for item {i}\n")
        with open(d / "behaviors.tsv", "w") as f:
            for b in range(40):
                uid = f"U{b % 15}"
                hist = " ".join(rng.choice(nids, size=4, replace=False))
                imps = " ".join(
                    f"{n}-{int(rng.random() < 0.3)}"
                    for n in rng.choice(nids, size=5, replace=False))
                f.write(f"{b}\t{uid}\t2020-01-01\t{hist}\t{imps}\n")
    return str(root)


def _vocab_state(v):
    return None if v is None else (v.name, v.tokens, len(v))


def assert_same_stores(got: dict, want: dict):
    """Store by store, column by column: the same arrays (exactly) and the
    same vocabularies bound to them."""
    assert sorted(got) == sorted(want)
    for part in want:
        g, w = got[part], want[part]
        assert g.col_names() == w.col_names(), part
        assert len(g) == len(w), part
        for col in w.col_names():
            np.testing.assert_array_equal(g[col], w[col],
                                          err_msg=f"{part}.{col}")
            assert g[col].dtype == w[col].dtype, (part, col)
            assert _vocab_state(g.vocab_of(col)) == _vocab_state(
                w.vocab_of(col)), (part, col)


def _both(name, **kw):
    """(port stores, JAX stores) of processor `name` built with kw, each
    into its own save_dir (`save` names the directory)."""
    save = kw.pop("save")
    got = PROCESSORS[name](save_dir=f"{save}_torch", **kw).load(True)
    want = JPROCESSORS[name](save_dir=f"{save}_jax", **kw).load(True)
    return got, want


def test_registries_match():
    assert sorted(PROCESSORS.keys()) == sorted(JPROCESSORS.keys())
    for key in ("mind", "oncemind", "xmind-cmn", "xmind-fin",
                "goodreadsrb", "mindrb"):
        assert key in PROCESSORS


def test_mind_processor(fake_mind, tmp_path):
    got, want = _both("mind", raw_dir=fake_mind, save=str(tmp_path / "m"))
    assert_same_stores(got, want)
    assert len(got["items"]) == 30 and got["items"]["title"].shape[1] == 30
    assert set(got["items"].col_names()) >= {
        "title", "abstract", "category", "subcategory", "item_id"}
    tr_u = set(got["train"]["user_id"].tolist())
    va_u = set(got["valid"]["user_id"].tolist())
    assert not (tr_u & va_u) and len(got["test"]) > 0
    assert "neg" in got["users"]
    # cache-hit reload, through the port's own save and load
    again = PROCESSORS["mind"](raw_dir=fake_mind,
                               save_dir=str(tmp_path / "m_torch")).load(False)
    assert_same_stores(again, got)


def test_xmind_processor(fake_mind, tmp_path):
    mind_dir = str(tmp_path / "mind")
    PROCESSORS["mind"](raw_dir=fake_mind, save_dir=mind_dir).load(True)
    xroot = tmp_path / "xmind_raw" / "xMINDsmall_train"
    xroot.mkdir(parents=True)
    with open(xroot / "news.tsv", "w") as f:
        for i in range(30):
            f.write(f"N{i}\tTitel nummer {i}\tZusammenfassung {i}\n")
    kw = dict(raw_dir=str(tmp_path / "xmind_raw"), mind_dir=mind_dir)
    got = PROCESSORS["xmind-cmn"](save_dir=str(tmp_path / "x_t"),
                                  **kw).build()
    want = JPROCESSORS["xmind-cmn"](save_dir=str(tmp_path / "x_j"),
                                    **kw).build()
    assert_same_stores(got, want)
    assert got["items"]["title@cmn"].shape[0] == 30


def _recbench_raw(tmp_path):
    pd = pytest.importorskip("pandas")
    pytest.importorskip("pyarrow")
    rng = np.random.default_rng(2023)
    raw = tmp_path / "rb"
    raw.mkdir()
    pd.DataFrame({"item_id": [f"b{i}" for i in range(20)],
                  "title": [f"book title {i} words" for i in range(20)]}
                 ).to_parquet(raw / "items.parquet")
    pd.DataFrame({"user_id": [f"u{i}" for i in range(10)],
                  "history": [[f"b{j}" for j in rng.choice(20, 3,
                                                            replace=False)]
                              for _ in range(10)]}
                 ).to_parquet(raw / "users.parquet")
    rows = [(f"u{u}", f"b{int(rng.integers(20))}", int(rng.random() < 0.4))
            for u in range(10) for _ in range(6)]
    cols = ["user_id", "item_id", "click"]
    pd.DataFrame(rows[:40], columns=cols).to_parquet(
        raw / "finetune.parquet")
    pd.DataFrame(rows[40:], columns=cols).to_parquet(raw / "test.parquet")
    with open(raw / "valid_user_set_0.1.txt", "w") as f:
        f.write("u0\n")
    return raw


def test_recbench_processor(tmp_path, monkeypatch):
    raw = _recbench_raw(tmp_path)
    stores = {}
    for which, registry in (("torch", PROCESSORS), ("jax", JPROCESSORS)):
        cwd = tmp_path / which
        (cwd / "config" / "data").mkdir(parents=True)
        monkeypatch.chdir(cwd)
        stores[which] = registry["goodreadsrb"](
            raw_dir=str(raw), save_dir=str(cwd / "out")).build()
        assert (cwd / "config" / "data" / "goodreadsrb.yaml").exists()
    assert_same_stores(stores["torch"], stores["jax"])
    assert ((tmp_path / "torch" / "config" / "data" / "goodreadsrb.yaml")
            .read_text().replace("torch", "jax")
            == (tmp_path / "jax" / "config" / "data" / "goodreadsrb.yaml")
            .read_text())
    assert len(stores["torch"]["items"]) == 20
    assert set(stores["torch"]["valid"]["user_id"].tolist()) <= {0}


def test_oncemind_processor(fake_mind, tmp_path):
    imp_file = tmp_path / "imps.json"
    with open(imp_file, "w") as f:
        json.dump(list(range(1, 10)), f)
    got, want = _both("oncemind", raw_dir=fake_mind,
                      save=str(tmp_path / "o"), imp_list_path=str(imp_file))
    assert_same_stores(got, want)
    assert set(got["valid"]["imp_id"].tolist()) <= set(range(1, 10))


def _fake_tok(text):
    return [min(ord(c), 99) for c in (text or "")[:10]]


def test_mind_extra_tokenizer_and_prompt_columns(fake_mind, tmp_path):
    from legommenders_tpu.data.vocab import Vocab as JVocab
    from legommenders_tpu_torch.data.vocab import Vocab

    got = PROCESSORS["mind"](
        raw_dir=fake_mind, save_dir=str(tmp_path / "t"),
        extra_tokenizers={"fakelm": (_fake_tok, 12,
                                     Vocab("fakelm").set_size(128))}).build()
    want = JPROCESSORS["mind"](
        raw_dir=fake_mind, save_dir=str(tmp_path / "j"),
        extra_tokenizers={"fakelm": (_fake_tok, 12,
                                     JVocab("fakelm").set_size(128))}).build()
    assert_same_stores(got, want)
    items = got["items"]
    assert items["title@fakelm"].shape == (30, 12)
    assert items.vocab_name("title@fakelm") == "fakelm"
    for col in ("prompt", "prompt_title", "prompt_category"):
        assert f"{col}@fakelm" in items and (items[col] == items[col][0]).all()
    assert items.vocab_name("prompt") == "word"


def _glove(tmp_path, words):
    path = tmp_path / "glove.txt"
    with open(path, "w") as f:
        for w in words:
            f.write(w + " " + " ".join(["0.1"] * 5) + "\n")
        f.write("broken 0.1\n")          # another width: skipped
    return path


def test_tokenizer_resolution(tmp_path):
    from legommenders_tpu.data.tokenizers import resolve as jresolve
    from legommenders_tpu.embedders.glove import (
        parse_glove_text as jparse,
    )
    from legommenders_tpu_torch.data.tokenizers import resolve
    from legommenders_tpu_torch.embedders.glove import parse_glove_text

    glove = _glove(tmp_path, ["title", "words", "number", "extra"])
    words, mat = parse_glove_text(str(glove))
    jwords, jmat = jparse(str(glove))
    assert words == jwords and mat.shape == (4, 5)
    np.testing.assert_array_equal(mat, jmat)
    for spec in (f"glove:{glove}", "word"):
        name, fn, vocab = resolve(spec)
        jname, jfn, jvocab = jresolve(spec)
        text = "Title words UNKNOWNTOKEN number, extra's"
        assert (name, fn(text), fn(text)) == (jname, jfn(text), jfn(text))
        assert vocab.tokens == jvocab.tokens
    assert resolve(f"glove:{glove}")[1]("Title words UNKNOWN") == [0, 1]
    with pytest.raises(SystemExit, match="dotfile"):
        resolve("bertbase")
    with pytest.raises(SystemExit, match="GloVe"):
        resolve(f"glove:{tmp_path / 'missing.txt'}")


def _hf_tokenizer(path):
    """A word-level HF tokenizer saved to `path` (no download)."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    words = ["[UNK]", "title", "words", "number", "extra", "abstract",
             "text", "for", "item"] + [str(i) for i in range(30)]
    tok = Tokenizer(models.WordLevel(
        vocab={w: i for i, w in enumerate(words)}, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok,
                            unk_token="[UNK]").save_pretrained(str(path))


def test_hf_tokenizer_through_dotfile(fake_mind, tmp_path, monkeypatch):
    pytest.importorskip("transformers")
    from legommenders_tpu.config.dotfiles import ModelInit as JModelInit
    from legommenders_tpu.data.tokenizers import resolve as jresolve
    from legommenders_tpu_torch.config.dotfiles import ModelInit
    from legommenders_tpu_torch.data.tokenizers import resolve

    _hf_tokenizer(tmp_path / "tinytok")
    monkeypatch.chdir(tmp_path)
    (tmp_path / ".model").write_text(f"tinytok: {tmp_path / 'tinytok'}\n")
    ModelInit.reload()
    JModelInit.reload()
    try:
        name, fn, vocab = resolve("tinytok")
        jname, jfn, jvocab = jresolve("tinytok")
        assert name == jname == "tinytok" and len(vocab) == len(jvocab) == 39
        assert fn("Title words 7 unseen") == jfn("Title words 7 unseen")
        got = PROCESSORS["mind"](
            raw_dir=fake_mind, save_dir=str(tmp_path / "t"),
            extra_tokenizers={name: (fn, 8, vocab)}).build()
        want = JPROCESSORS["mind"](
            raw_dir=fake_mind, save_dir=str(tmp_path / "j"),
            extra_tokenizers={jname: (jfn, 8, jvocab)}).build()
        assert_same_stores(got, want)
        assert got["items"]["title@tinytok"].shape == (30, 8)
    finally:
        monkeypatch.undo()
        ModelInit.reload()
        JModelInit.reload()


def test_process_cli_tokenizers(fake_mind, tmp_path, capsys):
    """The port's `process --tokenizers` (JAX process.py:27-47): glove
    columns on MIND; an xMIND language re-tokenized by the spec."""
    from legommenders_tpu_torch.process import main
    from process import main as jmain

    glove = _glove(tmp_path, ["titel", "nummer", "title", "words"])
    stores = main(["--data", "mind", "--raw_dir", fake_mind, "--save_dir",
                   str(tmp_path / "m"), "--tokenizers", f"glove:{glove}",
                   "--lm_truncate", "6", "--regenerate", "1"])
    assert "title@glove" in capsys.readouterr().out
    assert stores["items"]["title@glove"].shape == (30, 6)
    # `word` names its vocabulary as MIND's own word columns do, with
    # other contents: both packages refuse the second binding
    for run in (main, jmain):
        with pytest.raises(ValueError, match="vocab size conflict"):
            run(["--data", "mind", "--raw_dir", fake_mind, "--save_dir",
                 str(tmp_path / "w"), "--tokenizers", "word",
                 "--regenerate", "1"])
    xroot = tmp_path / "xmind_raw" / "xMINDsmall_train"
    xroot.mkdir(parents=True)
    with open(xroot / "news.tsv", "w") as f:
        for i in range(30):
            f.write(f"N{i}\tTitel nummer {i}\tZusammenfassung {i}\n")
    main(["--data", "xmind-fin", "--raw_dir", str(tmp_path / "xmind_raw"),
          "--save_dir", str(tmp_path / "xm"), "--mind_dir",
          str(tmp_path / "m"), "--tokenizers", f"glove:{glove}",
          "--regenerate", "1"])
    assert "title@fin" in capsys.readouterr().out


MIND_CFG = """
name: mind
base_dir: {save_dir}
item:
  ut: ${{base_dir}}/items
  inputs:
    - title: 20
    - category
user:
  ut: ${{base_dir}}/users
  truncate: 10
inter:
  train: ${{base_dir}}/train
  dev: ${{base_dir}}/valid
  test: ${{base_dir}}/test
  filters:
    history:
      - "lambda x: x"
column_map:
  item_col: item_id
  user_col: user_id
  history_col: history
  neg_col: neg
  label_col: click
  group_col: imp_id
"""
NAML = {"meta": {"item": "CNN", "user": "Ada", "predictor": "Dot"},
        "config": {"use_item_content": True, "hidden_size": 16,
                   "neg_count": 4,
                   "item_config": {"dropout": 0.0,
                                   "additive_hidden_size": 16},
                   "user_config": {"additive_hidden_size": 16}}}


def test_mind_end_to_end_training_matches_jax(fake_mind, tmp_path):
    """process -> data config -> Manager -> 10 Adam steps on the same
    batches and weights (losses within 1e-5 relative of JAX's) -> test."""
    from legommenders_tpu.config.parser import load_config as jload
    from legommenders_tpu.data.dataset import LegoData as JLegoData
    from legommenders_tpu.runtime import steps as jsteps
    from legommenders_tpu.runtime.manager import Manager as JManager
    from legommenders_tpu_torch.bridge import params_from_jax
    from legommenders_tpu_torch.config.parser import load_config
    from legommenders_tpu_torch.data.dataset import LegoData
    from legommenders_tpu_torch.runtime import steps
    from legommenders_tpu_torch.runtime.manager import Manager
    from legommenders_tpu_torch.runtime.tester import Tester

    from test_torch_lm_train import _batches  # noqa: E402

    save_dir = str(tmp_path / "mind")
    PROCESSORS["mind"](raw_dir=fake_mind, save_dir=save_dir).load(True)
    cfg_path = tmp_path / "mind.yaml"
    cfg_path.write_text(MIND_CFG.format(save_dir=save_dir))
    data = LegoData.from_config(load_config(str(cfg_path)))
    jdata = JLegoData.from_config(jload(str(cfg_path)))
    assert data.items["title"].shape[1] == 20
    jm = JManager({}, NAML, exp_cfg={"policy": {"batch_size": 8}},
                  data=jdata)
    batch = next(jm.train_batcher(seed=0).epoch(shuffle=False))
    params = jsteps.init_params(
        jm.model, {k: jnp.asarray(v) for k, v in batch.items()},
        jm.contents.columns, seed=0)
    tm = Manager(model_cfg=NAML, data=data, device="cpu",
                 exp_cfg={"policy": {"batch_size": 8}})
    tm.model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tm.model))
    opt = optax.adam(3e-3)
    jstep = jsteps.make_train_step(jm.model, jm.contents.columns, opt, True)
    opt_state = opt.init(params)
    step = steps.make_train_step(tm.model, tm.contents.columns,
                                 steps.adam(tm.model, 3e-3))
    for i, (bt, bj) in enumerate(_batches(tm, 10, seed=1)):
        params, opt_state, want = jstep(params, opt_state, bj,
                                        jax.random.PRNGKey(i))
        got = step(bt, torch.Generator().manual_seed(i)).item()
        assert abs(got - float(want)) <= 1e-5 * abs(float(want)), (i, got,
                                                                    want)
    res = Tester(tm).test()
    assert np.isfinite(res["GAUC"])
