"""The 8 IISAN YAMLs end to end in the port vs the JAX package, on the
CPU, on bridged weights.

Each of {bert,llama}-iisan-{naml,nrms,lstur,miner} is
`config/model/<name>.yaml` as the config parser reads it (BertIISAN /
LlamaIISAN item operators at layer_selection_step 2, the compact
inputer), made small: 3 layers of D 32 (layers 0 and 2 selected), 4 heads,
Llama's SwiGLU 32, hidden 16, 2 user heads, 1 user layer, 4 context codes
of 8, f32, dropout 0, over a 60-item catalog (title 8). The IISAN caches
are built on both sides (JAX's `load_or_build_iisan_cache`, the port's
`Manager.prepare_lm_cache`):
  * Tester.test(): every metric within 1e-5 of JAX's Tester, and the
    cached item reprs within 1e-5 (MINER by full forwards, as JAX decides);
  * 20 Adam steps (lr 1e-3) of bert-iisan-naml against optax on the same
    batches: every loss within 1e-5 relative of JAX's free-running loss,
    every parameter within 1e-4 of JAX's at the end (the LM, whose
    gradient is zero, unmoved on both sides);
  * bert-iisan-naml through the port's fused device step and its Trainer,
    and through the CLI with `--device cpu`.
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from legommenders_tpu.data.processors.synthetic import (
    SyntheticProcessor as JSynthetic,
)
from legommenders_tpu.runtime import lm_cache as jlm_cache
from legommenders_tpu.runtime import steps as jsteps
from legommenders_tpu.runtime.manager import Manager as JManager
from legommenders_tpu.runtime.tester import Tester as JTester
from legommenders_tpu_torch import process, trainer
from legommenders_tpu_torch.bridge import params_from_jax
from legommenders_tpu_torch.config import parser
from legommenders_tpu_torch.data.device_pipeline import DeviceTrainPipeline
from legommenders_tpu_torch.data.processors.synthetic import SyntheticProcessor
from legommenders_tpu_torch.models.operators.lm_ops import LM_HIDDEN_KEY
from legommenders_tpu_torch.runtime import steps
from legommenders_tpu_torch.runtime.manager import Manager
from legommenders_tpu_torch.runtime.tester import Tester
from legommenders_tpu_torch.runtime.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_KW = dict(num_items=60, num_users=30, title_len=8, history_len=6,
               vocab_size=200, inters_per_user=6)
BATCH = 8
MODELS = tuple(f"{lm}-iisan-{user}" for lm in ("bert", "llama")
               for user in ("naml", "nrms", "lstur", "miner"))
SMALL = {"hidden_size": 16, "num_user_heads": 2, "user_layers": 1,
         "num_context_codes": 4, "context_code_dim": 8, "lm_dtype": "f32"}
OPERATORS = {"bert": "BertIISANOperator", "llama": "LlamaIISANOperator"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def model_cfg(name: str) -> dict:
    cfg = parser.parse_four_way({"model": name, **SMALL},
                                config_root=os.path.join(ROOT, "config"))
    cfg = copy.deepcopy(cfg.raw()["model"])
    c = cfg["config"]
    c.update(embedding_dim=32, cache_page_size=16)
    ic = c["item_config"]
    ic.update(num_hidden_layers=3, num_attention_heads=4, dropout=0.0)
    if name.startswith("llama"):
        ic["intermediate_size"] = 32
    return cfg


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """Each YAML's JAX and port Managers, JAX's init bridged into the
    port's model, both IISAN caches built; built once a module."""
    built = {}

    def get(name):
        if name not in built:
            cfg = model_cfg(name)
            jm = JManager({}, cfg, data=JSynthetic(**DATA_KW).as_lego_data(),
                          exp_cfg={"policy": {"batch_size": BATCH}})
            batch = next(jm.train_batcher(seed=0).epoch(shuffle=False))
            batch = {k: jnp.asarray(v) for k, v in batch.items()}
            params = jax.jit(lambda b, c: jsteps.init_params(
                jm.model, b, c, seed=0))(batch, jm.contents.columns)
            tree = jax.tree_util.tree_map(np.asarray, params)
            tm = Manager(model_cfg=cfg,
                         data=SyntheticProcessor(**DATA_KW).as_lego_data(),
                         device="cpu",
                         exp_cfg={"policy": {"batch_size": BATCH}})
            tm.model.load_state_dict(params_from_jax(tree, tm.model))
            op = jm.model.item_op
            jm.contents.columns.update(jlm_cache.load_or_build_iisan_cache(
                jm.model, params, dict(jm.contents.columns), jm.data.name,
                op.transformer_key, op.get_selected_layers(), page_size=16,
                root=str(tmp_path_factory.mktemp(name))))
            assert tm.prepare_lm_cache(root=None)
            built[name] = jm, tm, params
        return built[name]

    return get


@pytest.mark.parametrize("name", MODELS)
def test_tester_matches_jax(name, pairs):
    jm, tm, params = pairs(name)
    op = tm.model.item_op
    assert type(op).__name__ == OPERATORS[name.split("-")[0]]
    assert op.get_selected_layers() == [0, 2]
    assert tm.contents.columns[LM_HIDDEN_KEY].shape == (60, 2, 32)
    jres = JTester(jm, params).test()
    res = Tester(tm).test()
    assert (tm.cache is None) == (jm.cache is None) == name.endswith("miner")
    if tm.cache is not None:
        np.testing.assert_allclose(tm.cache.item_repr.numpy(),
                                   np.asarray(jm.cache.item_repr),
                                   rtol=1e-5, atol=1e-5)
    assert list(res) == list(jres)
    for k in jres:
        assert np.isfinite(res[k])
        assert abs(res[k] - jres[k]) < 1e-5, (k, res[k], jres[k])


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


def test_adam_trajectory_matches_jax(pairs):
    jm, tm, params = pairs("bert-iisan-naml")
    batches = _batches(tm, 20, seed=1)
    opt = optax.adam(1e-3)
    jstep = jsteps.make_train_step(jm.model, jm.contents.columns, opt, True)
    jparams = jax.tree_util.tree_map(jnp.array, params)
    opt_state = opt.init(jparams)
    model = copy.deepcopy(tm.model)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    step = steps.make_train_step(model, tm.contents.columns,
                                 steps.adam(model, 1e-3))
    for i, (bt, bj) in enumerate(batches):
        got = step(bt, torch.Generator().manual_seed(i)).item()
        jparams, opt_state, want = jstep(jparams, opt_state, bj,
                                         jax.random.PRNGKey(i))
        want = float(want)
        assert abs(got - want) <= 1e-5 * abs(want), (i, got, want)
    final = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                            model)
    moved = set()
    for pname, t in model.named_parameters():
        np.testing.assert_allclose(t.detach().numpy(), final[pname].numpy(),
                                   rtol=0, atol=1e-4, err_msg=pname)
        if not torch.equal(t.detach(), start[pname]):
            moved.add(pname.split(".")[1])
    # the side network (SAN blocks, gates, linear) and the user side
    # trained; the frozen LM did not move
    assert {"san_0", "gates", "linear"} <= moved and "lm" not in moved


def test_fused_step_and_trainer_run_bert_iisan(tmp_path):
    tdata = SyntheticProcessor(**DATA_KW).as_lego_data()
    tm = Manager(model_cfg=model_cfg("bert-iisan-naml"), data=tdata,
                 device="cpu", exp_cfg={"policy": {"batch_size": BATCH,
                                                   "epoch": 1,
                                                   "epoch_batch": 3}})
    tr = Trainer(tm, seed=0, lm_cache_root=str(tmp_path))
    tr.init()
    assert tm.contents.columns[LM_HIDDEN_KEY].shape == (60, 2, 32)
    dp = DeviceTrainPipeline(tdata, batch_size=BATCH, seed=0, device="cpu")
    step = dp.make_fused_train_step(tm.model, tm.contents.columns,
                                    steps.adam(tm.model, 1e-3), seed=0)
    idx = next(dp.epoch_indices())
    assert all(np.isfinite([step(idx, i).item() for i in range(2)]))
    out = tr.train()
    assert tr.global_step == 3 and np.isfinite(out["best_dev"])
    res = tr.test()
    assert all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in res.values())


def test_cli_trains_bert_iisan_naml_on_the_cpu(tmp_path, monkeypatch):
    """`python -m legommenders_tpu_torch.trainer --model bert-iisan-naml`
    with `--device cpu`, the LM made small by dotted overrides."""
    path = str(tmp_path / "data" / "synthetic")
    process.main(["--data", "synthetic", "--save_dir", path])
    monkeypatch.chdir(tmp_path)
    small = {"model.config.embedding_dim": "32",
             "model.config.item_config.num_hidden_layers": "3",
             "model.config.item_config.num_attention_heads": "4"}
    argv = ["--data", "synthetic", "--data_dir", path, "--model",
            "bert-iisan-naml", "--epoch", "1", "--epoch_batch", "3",
            "--batch_size", "16", "--hidden_size", "16", "--lm_dtype", "f32",
            "--device", "cpu"]
    for k, v in small.items():
        argv += [f"--{k}", v]
    results = trainer.main(argv)
    assert all(0.0 <= v <= 1.0 for v in results.values())
    (csv,) = (tmp_path / "checkpoints" / "synthetic" /
              "bert-iisan-naml").glob("*.csv")
    assert csv.read_text().splitlines()[0].split(",") == list(results)
    # the IISAN cache went under the working directory's cache/
    assert list((tmp_path / "cache").rglob("torch_states.*.npy"))

