"""Reading JAX's orbax checkpoint directories in the port
(runtime/checkpoint.py `load_orbax`, `load_auto`).

JAX's `save_sharded` writes the params and the Adam state of a NAML
(row-sharded tables) and of a 2-layer BERT-naml (Megatron-TP kernels)
placed on a (dp 2, mp 2) mesh of the virtual CPU devices, after one Adam
step, so that the moments are not zero. The port reads each directory
in one process through `load_auto` and is held against JAX's
`load_sharded` of the same directory, bridged: the weights and Adam's
moments and step bit for bit. Small sizes: the synthetic catalog of
tests/test_torch_mp.py (80 items, 40 users, title 8, history 6), hidden
16, 2 negatives.
"""
import copy
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DATA_KW = dict(num_items=80, num_users=40, title_len=8, history_len=6,
               inters_per_user=10)
CONFIGS = {
    "naml": {
        "meta": {"item": "CNN", "user": "Ada", "predictor": "Dot"},
        "config": {"use_item_content": True, "hidden_size": 16,
                   "use_neg_sampling": True, "neg_count": 2,
                   "item_config": {"dropout": 0.0},
                   "user_config": {"dropout": 0.0}}},
    "bert": {
        "meta": {"item": "Bert", "user": "Ada", "predictor": "Dot"},
        "config": {"use_item_content": True, "hidden_size": 16,
                   "use_neg_sampling": True, "neg_count": 2,
                   "item_config": {"num_hidden_layers": 2,
                                   "num_attention_heads": 2,
                                   "dropout": 0.0, "lora_dropout": 0.0},
                   "user_config": {"dropout": 0.0}}},
}


def _data():
    from legommenders_tpu_torch.data.processors.synthetic import (
        SyntheticProcessor,
    )
    return SyntheticProcessor(**DATA_KW).as_lego_data()


def _manager(case):
    from legommenders_tpu_torch.runtime.manager import Manager
    return Manager(model_cfg=copy.deepcopy(CONFIGS[case]), data=_data(),
                   device="cpu")


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Each case's directory, written by JAX's save_sharded at (dp 2,
    mp 2) after one Adam step, and JAX's load_sharded of it."""
    import jax
    import jax.numpy as jnp
    import optax

    from legommenders_tpu.data.pipeline import TrainBatcher
    from legommenders_tpu.data.processors.synthetic import (
        SyntheticProcessor as JSynthetic,
    )
    from legommenders_tpu.parallel.mesh import make_mesh
    from legommenders_tpu.parallel.train import make_sharded_train_step
    from legommenders_tpu.runtime.checkpoint import (
        load_sharded, params_are_sharded, save_sharded,
    )
    from legommenders_tpu.runtime.manager import Manager as JManager
    from legommenders_tpu.runtime.steps import init_params

    tmp = str(tmp_path_factory.mktemp("orbax"))
    mesh = make_mesh(n_dp=2, n_mp=2, devices=jax.devices()[:4])
    opt = optax.adam(1e-3)
    out = {}
    for case, cfg in CONFIGS.items():
        jdata = JSynthetic(**DATA_KW).as_lego_data()
        jm = JManager({}, copy.deepcopy(cfg), data=jdata,
                      exp_cfg={"policy": {"batch_size": 16}})
        batch = next(TrainBatcher(jdata, 16, neg_count=2, seed=0).epoch())
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        params = init_params(jm.model, jbatch, jm.contents.columns, seed=0)
        step, place = make_sharded_train_step(
            jm.model, jm.contents.columns, opt, mesh, min_rows_to_shard=2)
        with mesh:
            p, o, b = place(params, opt.init(params), jbatch)
            p, o, _ = step(p, o, b, jax.random.PRNGKey(0))
        assert params_are_sharded(p)
        path = os.path.join(tmp, f"{case}.ckpt.orbax")
        save_sharded(path, p, o, meta={"epoch": 3})
        with mesh:
            lp, lo, meta = load_sharded(path, p, o)
        out[case] = {"path": path[:-len(".orbax")], "meta": meta,
                     "params": jax.tree_util.tree_map(np.asarray, lp),
                     "opt": jax.tree_util.tree_map(
                         np.asarray, jax.device_get(lo[0]))}
    return out


@pytest.mark.parametrize("case", list(CONFIGS))
def test_port_reads_jax_orbax_bit_for_bit(written, case):
    """load_auto tells JAX's directory from the port's by what is in it
    and restores the weights and Adam's state that JAX's load_sharded
    returns, bit for bit."""
    from legommenders_tpu_torch.bridge import params_from_jax
    from legommenders_tpu_torch.runtime import steps
    from legommenders_tpu_torch.runtime.checkpoint import load_auto

    w = written[case]
    m = _manager(case)
    opt = steps.adam(m.model, 1e-3)
    meta = load_auto(w["path"], m.model, opt)
    assert meta == w["meta"] == {"epoch": 3}
    want = params_from_jax(w["params"], m.model)
    got = m.model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    adam = w["opt"]
    mu = params_from_jax(adam.mu, m.model)
    nu = params_from_jax(adam.nu, m.model)
    moved = 0
    for name, p in m.model.named_parameters():
        if not p.requires_grad:
            continue
        st = opt.state[p]
        assert float(st["step"]) == float(adam.count) == 1.0
        assert torch.equal(st["exp_avg"], mu[name]), name
        assert torch.equal(st["exp_avg_sq"], nu[name]), name
        moved += bool(torch.count_nonzero(st["exp_avg"]))
    assert moved >= 5


def test_model_only_read_leaves_the_optimizer(written):
    from legommenders_tpu_torch.runtime import steps
    from legommenders_tpu_torch.runtime.checkpoint import load_auto

    m = _manager("naml")
    opt = steps.adam(m.model, 1e-3)
    load_auto(written["naml"]["path"], m.model, opt, model_only=True)
    assert not opt.state


def test_without_tensorstore_the_read_names_the_package(written,
                                                        monkeypatch):
    from legommenders_tpu_torch.runtime.checkpoint import load_auto

    monkeypatch.setitem(sys.modules, "tensorstore", None)
    m = _manager("naml")
    with pytest.raises(ImportError, match="`tensorstore` package"):
        load_auto(written["naml"]["path"], m.model)
