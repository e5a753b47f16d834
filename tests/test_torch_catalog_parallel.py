"""Catalog-parallel training in the port (parallel/catalog.py): the item
catalog, token columns or the layer-split LM cache, held by rows over
every rank; each rank encodes its own rows; the updated weights are one
process's at dropout 0.

Small sizes: the synthetic catalog of JAX's tests/test_catalog_parallel.py
(96 or 98 items, 40 users, title 8, history 6), NAML hidden 16 with 2
negatives, a 2-layer BERT (hidden 16, 2 heads, tune_from 1, LoRA r 2, f32),
dropout 0. The multi-rank run is 4 processes of this file (`python
tests/test_torch_catalog_parallel.py <init> <rank> <tmp>`) at (dp 2, mp 2)
with catalog_parallel, over gloo through `file://` in tmp_path, 120 s a
rank. Tolerances (JAX's test_catalog_parallel.py and
test_mesh_policy.py): parameters rtol 2e-4, atol 2e-5; losses rel 2e-5;
test metrics within 5e-3; the sharded encode against the whole one rtol
1e-5, atol 1e-5.

With sp (tests/torch_mesh_cases.py's case, runs and tolerances; `python
tests/test_torch_catalog_parallel.py spcat <init> <rank> <tmp>`): the
flatten Transformer at (dp 2, sp 2) with catalog_parallel, the catalog
over (dp, mp) only, against the catalog-parallel step in one process and
JAX's on (2, 1, 2). The evaluation paths under catalog_parallel are
tests/test_torch_mesh_combos_eval.py's.
"""
import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from legommenders_tpu_torch.parallel import catalog as tcat  # noqa: E402
from legommenders_tpu_torch.parallel import mesh as tmesh  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mesh_cases as mc  # noqa: E402

GROUPS = {"spcat": ["spcat"]}

DATA_KW = dict(num_users=40, title_len=8, history_len=6, inters_per_user=10)
NAML_CFG = {
    "meta": {"item": "CNN", "user": "Ada", "predictor": "Dot"},
    "config": {"use_item_content": True, "hidden_size": 16,
               "use_neg_sampling": True, "neg_count": 2,
               "full_catalog_encode": "on", "cache_page_size": 32,
               "item_config": {"dropout": 0.0},
               "user_config": {"dropout": 0.0}},
}
BERT_CFG = {
    "meta": {"item": "Bert", "user": "Ada", "predictor": "Dot"},
    "config": {"use_item_content": True, "hidden_size": 16,
               "use_neg_sampling": True, "neg_count": 2,
               "full_catalog_encode": "on", "cache_page_size": 16,
               "item_config": {"tune_from": 1, "num_hidden_layers": 2,
                               "num_attention_heads": 2, "hidden_size": 16,
                               "use_lora": True, "lora_r": 2,
                               "lora_dropout": 0.0, "dropout": 0.0,
                               "attn_dropout": 0.0, "lm_dtype": "f32"},
               "user_config": {"dropout": 0.0}},
}
POLICY = {"batch_size": 16, "epoch": 2, "epoch_batch": 4, "lr": 1e-3,
          "check_interval": 2}
MESH = {"dp": 2, "mp": 2, "catalog_parallel": True}
METRICS = ["GAUC", "MRR", "NDCG@1", "NDCG@5", "NDCG@10"]
RANK_TIMEOUT_S = 120
TOL = dict(rtol=2e-4, atol=2e-5)


def _data(num_items):
    from legommenders_tpu_torch.data.processors.synthetic import (
        SyntheticProcessor,
    )
    return SyntheticProcessor(num_items=num_items, **DATA_KW).as_lego_data()


def _manager(cfg, data, policy=None, mesh=None):
    from legommenders_tpu_torch.runtime.manager import Manager

    policy = dict(policy or POLICY)
    if mesh is not None:
        policy["mesh"] = mesh
    return Manager(model_cfg=copy.deepcopy(cfg),
                   exp_cfg={"policy": policy, "metrics": METRICS},
                   data=data, device="cpu")


def _batch(data):
    from legommenders_tpu_torch.data.pipeline import TrainBatcher

    b = next(TrainBatcher(data, 16, neg_count=2, seed=0).epoch(
        shuffle=False))
    return {k: np.asarray(v) for k, v in b.items()}


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def one_step(m, batch):
    """One process's step (Adam 1e-3) on the whole batch."""
    from legommenders_tpu_torch.runtime import steps

    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss = steps.make_train_step(m.model, m.contents.columns,
                                 steps.adam(m.model, 1e-3))(
        tb, steps.step_generator(0, 0, "cpu"))
    return float(loss), _state(m.model)


def catalog_step(m, batch):
    """One catalog-parallel step of this rank on its dp rows."""
    from legommenders_tpu_torch.runtime import steps

    step = tcat.make_catalog_parallel_step(
        m.model, steps.adam(m.model, 1e-3), m.mesh, m.catalog_contents(),
        len(next(iter(m.contents.columns.values()))))
    tb = tmesh.shard_rows({k: torch.as_tensor(v) for k, v in batch.items()},
                          m.mesh)
    return float(step(tb, 0)), _state(m.model)


def _trainer_run(cfg, data, weights, mesh=None, policy=None):
    from legommenders_tpu_torch.runtime.trainer import Trainer

    m = _manager(cfg, data, policy, mesh)
    m.model.load_state_dict(weights)
    tr = Trainer(m, seed=7, lm_cache_root=None)
    tr.train()
    out = {"test": tr.test(), "state": _state(m.model),
           "steps": tr.global_step}
    if m.catalog_parallel and m._catalog_contents is not None:
        out["local_rows"] = {c: a.shape[0]
                             for c, a in m._catalog_contents.items()}
    return out


# --------------------------------------------------------------------- #
# the ranks                                                             #
# --------------------------------------------------------------------- #
def rank_main(argv):
    """One rank: <init file> <rank> <tmp dir>."""
    init, rank, tmp = argv
    torch.set_num_threads(1)
    tmesh.initialize_multihost(f"file://{init}", 4, int(rank), device="cpu")
    try:
        inputs = torch.load(os.path.join(tmp, "inputs.pt"),
                            weights_only=False)
        out = {}
        for case, cfg, n in (("naml", NAML_CFG, 98), ("bert", BERT_CFG, 96)):
            data = _data(n)
            m = _manager(cfg, data, mesh=MESH)
            m.model.load_state_dict(inputs[case])
            if case == "bert":
                assert m.prepare_lm_cache(root=None)
            out[f"{case}_step"] = catalog_step(m, inputs[f"{case}_batch"])
            out[f"{case}_rows"] = {c: a.shape[0] for c, a in
                                   m.catalog_contents().items()}
        data = _data(98)
        out["naml_trainer"] = _trainer_run(NAML_CFG, data, inputs["naml"],
                                           MESH)
        out["naml_fused"] = _trainer_run(
            NAML_CFG, data, inputs["naml"], MESH,
            {**POLICY, "device_batching": True})
        out["bert_trainer"] = _trainer_run(BERT_CFG, _data(96),
                                           inputs["bert"], MESH,
                                           {**POLICY, "epoch": 1})
        torch.save(out, os.path.join(tmp, f"out.{rank}.pt"))
    finally:
        tmesh.shutdown()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks, one process's runs and JAX's catalog-parallel
    steps at (dp 2, mp 2), from the same weights."""
    import jax
    import jax.numpy as jnp
    import optax

    from legommenders_tpu.data.processors.synthetic import (
        SyntheticProcessor as JSynthetic,
    )
    from legommenders_tpu.parallel.catalog import (
        make_catalog_parallel_step, place_catalog,
    )
    from legommenders_tpu.parallel.mesh import make_mesh
    from legommenders_tpu.runtime.manager import Manager as JManager
    from legommenders_tpu.runtime.steps import init_params
    from legommenders_tpu_torch.bridge import params_from_jax

    tmp = str(tmp_path_factory.mktemp("catalog"))
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    inputs, jax_runs = {}, {}
    mesh = make_mesh(n_dp=2, n_mp=2, devices=jax.devices()[:4])
    for case, cfg, n in (("naml", NAML_CFG, 98), ("bert", BERT_CFG, 96)):
        data = _data(n)
        batch = _batch(data)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        jm = JManager({}, copy.deepcopy(cfg), data=JSynthetic(
            num_items=n, **DATA_KW).as_lego_data(),
            exp_cfg={"policy": {"batch_size": 16}})
        params = init_params(jm.model, jbatch, jm.contents.columns, seed=0)
        target = _manager(cfg, data).model
        inputs[case] = params_from_jax(
            jax.tree_util.tree_map(np.asarray, params), target)
        inputs[f"{case}_batch"] = batch
        if case == "bert":
            assert jm.prepare_lm_cache(params)
        opt = optax.adam(1e-3)
        step = make_catalog_parallel_step(jm.model, opt, mesh,
                                          rng_impl="threefry2x32")
        contents, _ = place_catalog(dict(jm.contents.columns), mesh)
        with mesh:
            p8, _, loss8 = step(jax.tree.map(jnp.copy, params),
                                opt.init(params), contents, jbatch, 0)
        jax_runs[case] = (float(loss8), params_from_jax(
            jax.tree_util.tree_map(np.asarray, jax.device_get(p8)), target))
    torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    init = os.path.join(tmp, "group.init")
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), init, str(r), tmp],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(4)]
    try:
        out = {"inputs": inputs, "jax": jax_runs}
        for case, cfg, n in (("naml", NAML_CFG, 98), ("bert", BERT_CFG, 96)):
            m = _manager(cfg, _data(n))
            m.model.load_state_dict(inputs[case])
            if case == "bert":
                assert m.prepare_lm_cache(root=None)
            out[f"{case}_one"] = one_step(m, inputs[f"{case}_batch"])
        data = _data(98)
        out["naml_trainer_one"] = _trainer_run(NAML_CFG, data,
                                               inputs["naml"])
        out["naml_fused_one"] = _trainer_run(
            NAML_CFG, data, inputs["naml"],
            policy={**POLICY, "device_batching": True})
        out["bert_trainer_one"] = _trainer_run(BERT_CFG, _data(96),
                                               inputs["bert"],
                                               policy={**POLICY, "epoch": 1})
        logs = []
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
        assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-6000:]
        out["ranks"] = [torch.load(os.path.join(tmp, f"out.{r}.pt"),
                                   weights_only=False) for r in range(4)]
    finally:
        torch.set_num_threads(n_threads)
        for p in procs:
            if p.poll() is None:
                p.kill()
    return out


def _close(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].float().numpy(),
                                   want[k].float().numpy(), err_msg=k, **TOL)


# --------------------------------------------------------------------- #
# one process                                                           #
# --------------------------------------------------------------------- #
def test_pad_and_place_catalog():
    """98 rows over 4 ranks: padded to 100 by the last row, 25 a rank."""
    cols = {"title": torch.arange(98 * 3).reshape(98, 3)}
    padded, n = tcat.pad_catalog(cols, 8)
    assert n == 98 and padded["title"].shape[0] == 104
    assert torch.equal(padded["title"][98:], cols["title"][-1:].expand(6, 3))
    parts = []
    for r in range(4):
        local, n = tcat.place_catalog(cols, tmesh.Mesh(2, r, 2, True))
        assert n == 98 and local["title"].shape[0] == 25
        parts.append(local["title"])
    assert torch.equal(torch.cat(parts)[:98], cols["title"])
    assert tcat.catalog_axes(tmesh.Mesh(2, 0, 2)) == ("dp", "mp")


def test_local_encodes_are_the_whole_encode():
    """Each rank's encode of its rows, in rank order, is the whole
    catalog's encode."""
    m = _manager(NAML_CFG, _data(98))
    whole = m.model.encode_item_content(m.contents.columns).detach()
    parts = [m.model.encode_item_content(tcat.place_catalog(
        m.contents.columns, tmesh.Mesh(2, r, 2, True))[0]).detach()
        for r in range(4)]
    torch.testing.assert_close(torch.cat(parts)[:98], whole, rtol=1e-5,
                               atol=1e-5)


# --------------------------------------------------------------------- #
# four ranks                                                            #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("case", ["naml", "bert"])
def test_catalog_parallel_step_matches_one_process_and_jax(runs, case):
    """One catalog-parallel step of NAML, and of a tune_from BERT from its
    row-held cache, against one process's step and JAX's
    make_catalog_parallel_step on make_mesh(2, 2)."""
    one_loss, one_state = runs[f"{case}_one"]
    jax_loss, jax_state = runs["jax"][case]
    for rank in runs["ranks"]:
        loss, state = rank[f"{case}_step"]
        assert loss == pytest.approx(one_loss, rel=2e-5)
        assert loss == pytest.approx(jax_loss, rel=2e-5)
        _close(state, one_state)
        _close(state, jax_state)


def test_lm_cache_is_held_by_rows(runs):
    """Under catalog_parallel each of the 4 ranks holds 96 / 4 rows of the
    layer-split cache (and of every column), never the whole."""
    for rank in runs["ranks"]:
        rows = rank["bert_rows"]
        assert "__lm_hidden__" in rows
        assert set(rows.values()) == {24}
        assert set(rank["naml_rows"].values()) == {25}
        assert set(rank["bert_trainer"]["local_rows"].values()) == {24}


@pytest.mark.parametrize("case", ["naml_trainer", "naml_fused",
                                  "bert_trainer"])
def test_trainer_catalog_parallel_matches_one_process(runs, case):
    """Trainer.train() + test() under catalog_parallel (host batches; the
    device pipeline's batches, assembled in the step; the tune_from BERT
    from its row-held cache) against one process."""
    one = runs[f"{case}_one"]
    for rank in runs["ranks"]:
        got = rank[case]
        assert got["steps"] == one["steps"]
        _close(got["state"], one["state"])
        for k, v in one["test"].items():
            assert abs(got["test"][k] - v) < 5e-3, (k, got["test"],
                                                    one["test"])


# --------------------------------------------------------------------- #
# with sp, and the evaluation paths                                     #
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def combos(tmp_path_factory):
    return mc.run_groups(os.path.abspath(__file__), GROUPS,
                         str(tmp_path_factory.mktemp("catalog_combos")))


def test_sp_ranks_of_a_cell_hold_the_same_catalog_rows():
    """At (dp 2, mp 2, sp 2) the catalog axis is the (dp, mp) ranks at one
    sp index: the sp ranks of a cell hold the same rows, the four cells
    the whole catalog."""
    cols = {"title": torch.arange(98 * 3).reshape(98, 3)}
    by_cell = {}
    for r in range(8):
        mesh = tmesh.Mesh(2, r, 2, True, 0, 2)
        axis = mesh.catalog_axis
        assert axis.size == 4
        assert axis.index == mesh.dp_index * 2 + mesh.mp_index
        local, n = tcat.place_catalog(cols, mesh)
        by_cell.setdefault(axis.index, []).append(local["title"])
    for parts in by_cell.values():
        assert len(parts) == 2 and torch.equal(parts[0], parts[1])
    whole = torch.cat([by_cell[i][0] for i in range(4)])
    assert torch.equal(whole[:98], cols["title"])


def test_catalog_parallel_with_sp_matches_one_process_and_jax(combos):
    """The loss, every gradient, the Adam update, the dev value, the first
    test pages' scores and Tester.test()."""
    mc.check_case(combos["ranks"]["spcat"], combos["one"]["spcat"],
                  combos["jax"]["spcat"], combos["init"]["spcat"])


if __name__ == "__main__":
    if len(sys.argv) == 5:
        mc.rank_main(sys.argv[1:], GROUPS)
    else:
        rank_main(sys.argv[1:])
