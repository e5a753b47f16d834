"""The port's run loop vs the JAX package: host batches, Monitor, warmup +
gradient accumulation, the Trainer (NAML and bert-naml layer-split with
two LR groups) and checkpoints in both formats.

Small sizes: an 80-item synthetic catalog (40 users, title 8, history 6),
batches of 8 with 4 negatives, NAML hidden 16, a Bert item operator of 2
layers (D 32, 2 heads) split at tune_from 1 with LoRA r 4; f32, dropout 0.
The JAX side runs on the CPU; weights move JAX -> port through the bridge.
Tolerances:
  * batches (TrainBatcher, EvalBatcher, both negative samplers): equal;
  * Monitor signals: equal;
  * warmup LR and every parameter after every mini-step against optax's
    linear_schedule + MultiSteps(adam): 1e-7;
  * Trainer.train() + test() against JAX's Trainer: every parameter within
    1e-4 of its tensor's largest value, best_dev and the test metrics
    within 1e-5; the item LR group equal to JAX's label_fn. The additive
    pools' `proj_bias` are held within 1e-2 instead: their gradient is zero
    to first order (the softmax backward's weights sum to zero over the
    positions, and tanh' is ~1 near the init), so it is the float-rounding
    residue of its terms, below Adam's eps, and Adam's update (about the
    gradient over eps) carries that residue (NAML on the CPU: 8.6e-4 of
    the largest value; every other tensor within 1e-5);
  * the port's checkpoint round trip: exact; a JAX msgpack checkpoint
    through load_jax_checkpoint: scores within 1e-5 of JAX's.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from legommenders_tpu import native as jnative
from legommenders_tpu.data import pipeline as jpipeline
from legommenders_tpu.data.processors.synthetic import (
    SyntheticProcessor as JSynthetic,
)
from legommenders_tpu.runtime import checkpoint as jcheckpoint
from legommenders_tpu.runtime import trainer as jtrainer
from legommenders_tpu.runtime.manager import Manager as JManager
from legommenders_tpu.utils import monitor as jmonitor
from legommenders_tpu_torch import bridge, native
from legommenders_tpu_torch.bridge import params_from_jax
from legommenders_tpu_torch.data import pipeline
from legommenders_tpu_torch.data.processors.synthetic import SyntheticProcessor
from legommenders_tpu_torch.runtime import checkpoint, trainer
from legommenders_tpu_torch.runtime.manager import Manager
from legommenders_tpu_torch.utils import monitor

DATA_KW = dict(num_items=80, num_users=40, title_len=8, history_len=6,
               vocab_size=200, inters_per_user=8)
BATCH = 8
NAML_CFG = {
    "meta": {"item": "CNN", "user": "Ada", "predictor": "Dot"},
    "config": {"use_item_content": True, "hidden_size": 16, "neg_count": 4,
               "cache_page_size": 32,
               "item_config": {"dropout": 0.0, "kernel_size": 3,
                               "additive_hidden_size": 32},
               "user_config": {"additive_hidden_size": 32}},
}
BERT_CFG = {
    "meta": {"item": "Bert", "user": "Ada", "predictor": "Dot"},
    "config": {
        "use_item_content": True, "hidden_size": 16, "embedding_dim": 32,
        "cache_page_size": 32, "neg_count": 4,
        "item_config": {
            "lm_dtype": "f32", "num_hidden_layers": 2,
            "num_attention_heads": 2, "max_position": 64, "tune_from": 1,
            "use_lora": True, "lora_r": 4, "lora_dropout": 0.0,
            "lora_fold": True, "fused_attention": True,
            "gelu_approximate": True, "dropout_reuse": True, "dropout": 0.0,
            "additive_hidden_size": 32,
            "inputer_config": {"use_cls_token": True, "use_sep_token": True,
                               "compact": True}},
        "user_config": {"additive_hidden_size": 32}},
}
# host batches, 2 epochs cut to 5 steps, 3 warmup updates, 2 mini-steps
# per update (the cut leaves one mini-step pending across the epochs)
POLICY = {"epoch": 2, "lr": 3e-3, "batch_size": BATCH, "epoch_batch": 5,
          "n_warmup": 3, "accumulate_batch": 2}
EXP = {"policy": POLICY, "store": {"metric": "GAUC", "patience": 3},
       "metrics": ["GAUC", "MRR", "NDCG@5"]}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Single-threaded torch while this module runs (the suite runs in
    parallel workers); restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_pair():
    return (JSynthetic(**DATA_KW).as_lego_data(),
            SyntheticProcessor(**DATA_KW).as_lego_data())


# --------------------------------------------------------------------- #
# host batches                                                          #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("sampler", ["c", "numpy"])
def test_host_batches_equal_jax(data_pair, sampler, monkeypatch):
    jdata, tdata = data_pair
    if sampler == "numpy":
        monkeypatch.setattr(jnative, "sample_negatives",
                            lambda *a, **k: None)
        monkeypatch.setattr(native, "sample_negatives",
                            lambda *a, **k: None)
    else:
        assert native.backend() == "c"
    for phase in ("train", "dev"):
        want = list(jpipeline.TrainBatcher(jdata, BATCH, seed=5,
                                           phase=phase).epoch())
        got = list(pipeline.TrainBatcher(tdata, BATCH, seed=5,
                                         phase=phase).epoch())
        assert len(got) == len(want) > 3
        for g, w in zip(got, want):
            assert list(g) == list(w)
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    want = list(jpipeline.EvalBatcher(jdata, "test", 48).epoch())
    got = list(pipeline.EvalBatcher(tdata, "test", 48).epoch())
    assert len(got) == len(want) == 7      # 320 rows: the tail padded
    for g, w in zip(got, want):
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_native_sampler_builds_into_the_port():
    """The port's C sampler is built into its own _build/ and the JAX
    package's library is neither built nor loaded by it."""
    lib = native.get_lib()
    assert lib is not None
    assert lib._name == native._LIB
    assert "legommenders_tpu_torch/_build/" in lib._name


@pytest.mark.parametrize("minimize", [False, True])
@pytest.mark.parametrize("patience", [1, 3])
def test_monitor_matches_jax(minimize, patience):
    rng = np.random.default_rng(patience + 10 * minimize)
    for _ in range(20):
        seq = rng.normal(size=12).round(1).tolist()
        jm = jmonitor.Monitor(patience=patience, minimize=minimize)
        tm = monitor.Monitor(patience=patience, minimize=minimize)
        assert ([tm.push(v).value for v in seq]
                == [jm.push(v).value for v in seq])


# --------------------------------------------------------------------- #
# warmup + MultiSteps                                                   #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n_warmup,k", [(0, 1), (3, 1), (3, 2), (4, 3)])
def test_warmup_and_multisteps_match_optax(n_warmup, k):
    """Per mini-step: the update (parameters after minus before), and,
    before each real update, the LR the optimizer uses, against optax
    (1e-7). optax computes Adam's bias corrections in f32, where
    1 - 0.999^t cancels (1.5e-5 relative at t = 2), torch in double: at
    lr 1e-3 that is below 2e-8 of an update. The parameters start at scale
    1e-3, so that f32 resolves the updates far below the tolerance."""
    rng = np.random.default_rng(n_warmup + 7 * k)
    lr = 1e-3
    shapes = {"a": (3, 4), "b": (5,)}
    init = {n: (1e-3 * rng.normal(size=s)).astype(np.float32)
            for n, s in shapes.items()}
    opt = optax.adam(jtrainer.linear_warmup(lr, n_warmup))
    if k > 1:
        opt = optax.MultiSteps(opt, k)
    jparams = {n: jnp.asarray(v) for n, v in init.items()}
    state = opt.init(jparams)
    tparams = {n: torch.nn.Parameter(torch.tensor(v))
               for n, v in init.items()}
    adam = torch.optim.Adam(list(tparams.values()), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(adam,
                                              trainer.linear_warmup(n_warmup))
    ms = trainer.MultiSteps(adam, sched, k)
    schedule = jtrainer.linear_warmup(lr, n_warmup)
    updates = 0
    for i in range(4 * k + 3):
        grads = {n: rng.normal(size=s).astype(np.float32)
                 for n, s in shapes.items()}
        if (i + 1) % k == 0:
            assert abs(ms.param_groups[0]["lr"]
                       - float(schedule(updates))) <= 1e-7 * lr
        upd, state = opt.update({n: jnp.asarray(g) for n, g in grads.items()},
                                state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        before = {n: p.detach().double().clone() for n, p in tparams.items()}
        ms.zero_grad()
        for n, p in tparams.items():
            p.grad = torch.tensor(grads[n])
        moved = ms.step()
        assert moved == ((i + 1) % k == 0)
        updates += moved
        for n, p in tparams.items():
            np.testing.assert_allclose(
                (p.detach().double() - before[n]).numpy(),
                np.asarray(upd[n], np.float64), rtol=0, atol=1e-7,
                err_msg=f"{n} step {i}")
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[n]), rtol=0,
                                       atol=1e-7, err_msg=f"{n} step {i}")
    assert updates == (4 * k + 3) // k
    if n_warmup:
        # the first update read lr 0: Adam's moments moved, the weights not
        assert float(schedule(0)) == 0.0


# --------------------------------------------------------------------- #
# the Trainer against JAX's                                             #
# --------------------------------------------------------------------- #
def _nonzero_lora(tree, rng):
    return {k: (_nonzero_lora(v, rng) if isinstance(v, dict) else
                (rng.normal(0, 0.05, np.shape(v)).astype(np.float32)
                 if k == "lora_B" else np.asarray(v)))
            for k, v in tree.items()}


def _jax_item_group(opt_state):
    """The port's names of the parameters in the `item` partition of JAX's
    multi_transform (its label_fn's verdict), from the masked Adam state."""
    inner = getattr(opt_state, "inner_opt_state", opt_state)
    mu = inner.inner_states["item"].inner_state[0].mu
    out = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            mu, is_leaf=lambda x: isinstance(x, optax.MaskedNode))[0]:
        if not isinstance(leaf, optax.MaskedNode):
            keys = [str(p.key) for p in path]
            assert keys[0] == "params"
            out.add(bridge._place(keys[1:], np.asarray(leaf))[0])
    return out


def _run_pair(cfg, policy, data_pair, tmp_path, monkeypatch, lm=False):
    """JAX's Trainer and the port's on the same weights and data; returns
    both trainers, their train() and test() results."""
    monkeypatch.chdir(tmp_path)      # JAX's LM cache goes to ./cache
    exp = {**EXP, "policy": policy}
    jm = JManager({}, cfg, data=data_pair[0], exp_cfg=exp)
    jt = jtrainer.Trainer(jm, seed=0, ckpt_path=str(tmp_path / "j.ckpt"))
    jt.init()
    tree = jax.tree_util.tree_map(np.asarray, jt.params)
    if lm:
        tree = _nonzero_lora(tree, np.random.default_rng(0))
        jt.params = jax.tree_util.tree_map(jnp.asarray, tree)
        jt.opt_state = jt.optimizer.init(jt.params)
    tm = Manager(model_cfg=cfg, exp_cfg=exp, data=data_pair[1],
                 device="cpu")
    tm.model.load_state_dict(params_from_jax(tree, tm.model))
    tt = trainer.Trainer(tm, seed=0, ckpt_path=str(tmp_path / "t.ckpt"),
                         lm_cache_root=None)
    out = dict(jt=jt, tt=tt, jtrain=jt.train(), ttrain=tt.train())
    out["jtest"], out["ttest"] = jt.test(), tt.test()
    return out


def _check_pair(out):
    jt, tt = out["jt"], out["tt"]
    assert np.isfinite(out["ttrain"]["best_dev"])
    assert abs(out["ttrain"]["best_dev"] - out["jtrain"]["best_dev"]) <= 1e-5
    assert list(out["ttest"]) == list(out["jtest"])
    for k, v in out["jtest"].items():
        assert abs(out["ttest"][k] - v) <= 1e-5, (k, out["ttest"], out["jtest"])
    model = tt.m.model
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jt.params),
                           model)
    moved = 0
    for name, p in model.named_parameters():
        w = want[name].numpy()
        scale = max(float(np.abs(w).max()), 1e-6)
        err = float(np.abs(p.detach().numpy() - w).max())
        tol = 1e-2 if name.endswith("proj_bias") else 1e-4
        assert err <= tol * scale, (name, err, scale)
        moved += p.requires_grad
    assert moved >= 8
    # 2 epochs x 5 mini-steps, 2 per update: 5 updates; the accumulation
    # carried one mini-step over the epoch cut
    assert tt.global_step == 10 and tt.optimizer.mini_step == 0
    assert tt.optimizer.scheduler.last_epoch == 5


def test_naml_trainer_matches_jax(data_pair, tmp_path, monkeypatch):
    out = _run_pair(NAML_CFG, POLICY, data_pair, tmp_path, monkeypatch)
    _check_pair(out)
    # simple_dev: the training loss over the dev split's batches
    got, want = out["tt"]._simple_dev_loss(), out["jt"]._simple_dev_loss()
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    # the best epoch's checkpoint of each framework, with its meta
    meta = checkpoint.load_checkpoint(str(tmp_path / "t.ckpt"),
                                      copy.deepcopy(out["tt"].m.model))
    jmeta = jcheckpoint.load_checkpoint(str(tmp_path / "j.ckpt"),
                                        out["jt"].params)[2]
    assert meta == jmeta


def test_bert_trainer_item_lr_matches_jax(data_pair, tmp_path, monkeypatch):
    policy = {**POLICY, "item_lr": 1e-3}
    out = _run_pair(BERT_CFG, policy, data_pair, tmp_path, monkeypatch,
                    lm=True)
    _check_pair(out)
    tt = out["tt"]
    groups = {g["name"]: g for g in tt.optimizer.param_groups}
    assert sorted(groups) == ["item", "other"]
    names = {id(p): n for n, p in tt.m.model.named_parameters()}
    item = {names[id(p)] for p in groups["item"]["params"]}
    assert item and all(n.startswith("item_op.lm.") for n in item)
    # JAX's item partition, on the port's names, restricted to what trains
    jitem = _jax_item_group(out["jt"].opt_state)
    trainable = {n for n, p in tt.m.model.named_parameters()
                 if p.requires_grad}
    assert item == jitem & trainable


# --------------------------------------------------------------------- #
# checkpoints                                                           #
# --------------------------------------------------------------------- #
def test_checkpoint_round_trip_is_exact(data_pair, tmp_path):
    """Weights, Adam's moments and counts, the scheduler, the pending
    accumulation and the meta come back as they were written."""
    policy = {**POLICY, "epoch": 1, "epoch_batch": 3}
    tm = Manager(model_cfg=NAML_CFG, exp_cfg={**EXP, "policy": policy},
                 data=data_pair[1], device="cpu", seed=1)
    tt = trainer.Trainer(tm, seed=0)
    tt.train()
    assert tt.optimizer.mini_step == 1 and tt.optimizer.acc
    path = str(tmp_path / "m.ckpt")
    checkpoint.save_checkpoint(path, tm.model, tt.optimizer,
                               meta={"epoch": 1, "dev": 0.5})
    with open(path, "rb") as f:
        assert f.read(4) == b"PK\x03\x04"
    model = copy.deepcopy(tm.model)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    opt = trainer.build_optimizer(model, tm.policy)
    meta = checkpoint.load_auto(path, model, opt)
    assert meta == {"epoch": 1, "dev": 0.5}
    for (n, a), b in zip(tm.model.state_dict().items(),
                         model.state_dict().values()):
        assert torch.equal(a, b), n
    want, got = tt.optimizer.state_dict(), opt.state_dict()
    assert got["mini_step"] == want["mini_step"] == 1
    assert got["scheduler"] == want["scheduler"]
    assert want["scheduler"]["last_epoch"] == 1
    for a, b in zip(want["acc"], got["acc"]):
        assert (a is None and b is None) or torch.equal(a, b)
    ws, gs = want["optimizer"]["state"], got["optimizer"]["state"]
    assert ws.keys() == gs.keys() and len(ws) >= 8
    for i in ws:
        for k in ws[i]:
            assert torch.equal(ws[i][k], gs[i][k]), (i, k)
    assert (want["optimizer"]["param_groups"]
            == got["optimizer"]["param_groups"])
    # model_only leaves the optimizer alone
    opt2 = trainer.build_optimizer(model, tm.policy)
    checkpoint.load_checkpoint(path, model, opt2, model_only=True)
    assert not opt2.optimizer.state


def test_jax_msgpack_checkpoint_loads_and_scores_as_jax(data_pair, tmp_path):
    jm = JManager({}, NAML_CFG, data=data_pair[0], exp_cfg=EXP)
    jt = jtrainer.Trainer(jm, seed=3)
    jt.init()
    path = str(tmp_path / "jax.ckpt")
    jcheckpoint.save_checkpoint(path, jt.params, jt.opt_state,
                                meta={"epoch": 4})
    tm = Manager(model_cfg=NAML_CFG, exp_cfg=EXP, data=data_pair[1],
                 device="cpu")
    assert checkpoint.load_auto(path, tm.model) == {"epoch": 4}
    jt.evaluator.evaluate(jt.params, "test")      # builds JAX's caches
    want = jt.evaluator.score_phase_device(jt.params, "test")
    tm.cache.cache()
    got = tm.evaluator().score_phase_device("test").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_msgpack_reader_decodes_flax_leaves(tmp_path, monkeypatch):
    """bf16, int and scalar leaves, and an array flax splits into chunks,
    decode to flax's own values."""
    from flax import serialization

    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(0)
    tree = {"params": {
        "w": jnp.asarray(rng.normal(size=(3, 5)), jnp.bfloat16),
        "big": rng.normal(size=(7, 9)).astype(np.float32),
        "ids": np.arange(6, dtype=np.int32).reshape(2, 3)},
        "count": np.int32(7)}
    path = tmp_path / "t.msgpack"
    path.write_bytes(serialization.msgpack_serialize(
        jax.tree_util.tree_map(np.asarray, tree)))
    got = checkpoint.read_jax_checkpoint(str(path))
    want = serialization.msgpack_restore(path.read_bytes())
    np.testing.assert_array_equal(got["params"]["w"],
                                  np.asarray(want["params"]["w"], np.float32))
    for k in ("big", "ids"):
        assert got["params"][k].dtype == want["params"][k].dtype
        np.testing.assert_array_equal(got["params"][k], want["params"][k])
    assert int(got["count"]) == 7


def test_load_auto_refuses_other_files(tmp_path):
    path = tmp_path / "x.ckpt"
    path.write_bytes(b"\x00\x01\x02\x03")
    with pytest.raises(ValueError, match="neither"):
        checkpoint.load_auto(str(path), torch.nn.Linear(2, 2))


def test_trainer_device_batching_runs(data_pair):
    """`device_batching`: the device pipeline's fused step under the same
    loop (its draws are not JAX's: held to running, counting and
    learning-rate bookkeeping)."""
    policy = {**POLICY, "device_batching": True, "accumulate_batch": 1}
    tm = Manager(model_cfg=NAML_CFG, exp_cfg={**EXP, "policy": policy},
                 data=data_pair[1], device="cpu")
    tt = trainer.Trainer(tm, seed=0)
    out = tt.train()
    assert np.isfinite(out["best_dev"]) and tt.global_step == 10
    assert tt.optimizer.scheduler.last_epoch == 10
    assert len(tt.epochs) == 2 and tt.prefetch_wait_s == 0.0


@pytest.mark.parametrize("what", ["mp", "sp", "pp", "catalog_parallel",
                                  "pipeline_stages"])
def test_trainer_session_and_mesh_raise(data_pair, what):
    """The multi-device policies in one process (the session and the
    mesh's dp axis run since they were ported: tests/test_torch_server.py,
    tests/test_torch_dp.py). mp, sp and pp are ported: one process asking
    for 2 of any gets JAX's "only 1 visible"; catalog_parallel builds its
    dp-1 mesh (tests/test_torch_mp.py, tests/test_torch_sp.py,
    tests/test_torch_pp.py, tests/test_torch_catalog_parallel.py);
    pipeline_stages without a pp mesh builds the staged slice and runs it
    serial, as JAX does."""
    cfg, mesh = NAML_CFG, {what: 2 if what != "catalog_parallel" else True}
    if what == "pipeline_stages":
        cfg = copy.deepcopy(BERT_CFG)
        cfg["config"]["item_config"]["pipeline_stages"] = 2
        mesh = True

    def build():
        return Manager(model_cfg=cfg, data=data_pair[1], device="cpu",
                       exp_cfg={"policy": {"mesh": mesh}})
    if what in ("mp", "sp", "pp"):
        with pytest.raises(ValueError, match="only 1 visible"):
            build()
    elif what == "catalog_parallel":
        m = build()
        assert m.catalog_parallel and m.mesh.shape == {"dp": 1}
    else:
        from legommenders_tpu_torch.parallel.mesh import get_pp_mesh
        m = build()
        assert m.model.item_op.lm.pipeline_stages == 2
        assert m.mesh.pp == 1 and get_pp_mesh() is None


def test_trainer_requires_cuda_unless_cpu(data_pair, monkeypatch):
    """The Trainer runs on its Manager's device, which defaults to the
    card and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.Trainer(Manager(model_cfg=NAML_CFG, exp_cfg=EXP,
                                data=data_pair[1]))


def test_model_copies_after_eval_and_training(data_pair):
    """A fault the run loop found: the pool's cached weight casts kept, at
    f32, a view of `query` made in inference mode; once Adam wrote the
    parameter in place, the model could not be deep-copied (or pickled).
    The cast cache now keeps such a view as a copy."""
    policy = {**POLICY, "epoch": 1, "epoch_batch": 2}
    tm = Manager(model_cfg=NAML_CFG, exp_cfg={**EXP, "policy": policy},
                 data=data_pair[1], device="cpu")
    tt = trainer.Trainer(tm, seed=0)
    tt.train()                       # dev (inference mode), then steps
    copied = copy.deepcopy(tm.model)
    for (n, a), b in zip(tm.model.state_dict().items(),
                         copied.state_dict().values()):
        assert torch.equal(a, b), n
    att = tm.model.item_op.attention
    cached = att._cast_cache[1]
    assert all(t._base is None for t in cached)
