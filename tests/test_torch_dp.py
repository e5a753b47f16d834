"""The dp axis of exp.policy.mesh in the port: the policy's variants, two
gloo ranks against one process and against JAX's Trainer at dp 2.

Small sizes: the synthetic catalog of JAX's tests/test_mesh_policy.py (80
items, 40 users, title 8, history 6), NAML hidden 16 with 2 negatives, 2
epochs of 4 batches of 16, dropout 0; DIN (din_text: its attention unit's
Dice takes batch statistics; MLPs of 16) on the same data, pointwise,
batches of 16. Each dp run is two
processes of this file (`python tests/test_torch_dp.py <case> ...`), a
gloo group opened through `init_method=file://` in the test's tmp_path,
each process under a timeout of 120 s; both cases' ranks run at once.
Every run starts from the same weights (JAX's init bridged into the port,
or the port's own from seed 0, saved by the test). Tolerances:
  * NAML parameters at dp 2 against one process and against JAX's Trainer
    at `mesh: {dp: 2}` (the conftest's virtual devices): rtol 2e-4, atol
    2e-5; test metrics within 5e-3 (JAX's
    test_trainer_mesh_dp_parity_vs_single_device);
  * evaluation under dp 2 (cached and full-forward) against one process:
    every metric within 1e-6;
  * DIN under dp 2 (batch statistics over the whole batch) against one
    process: parameters rtol 2e-4, atol 2e-5; full-forward test scores
    within 1e-5.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from legommenders_tpu_torch.parallel import mesh as tmesh  # noqa: E402

DATA_KW = dict(num_items=80, num_users=40, title_len=8, history_len=6,
               inters_per_user=10)
NAML_CFG = {
    "meta": {"item": "CNN", "user": "Ada", "predictor": "Dot"},
    "config": {"use_item_content": True, "hidden_size": 16,
               "use_neg_sampling": True, "neg_count": 2,
               "cache_page_size": 32,
               "item_config": {"dropout": 0.0},
               "user_config": {"dropout": 0.0}},
}
POLICY = {"batch_size": 16, "epoch": 2, "epoch_batch": 4, "lr": 1e-3,
          "check_interval": 2}
DIN_POLICY = {"batch_size": 16, "epoch": 1, "epoch_batch": 4, "lr": 1e-3,
              "eval_batch_size": 32}
METRICS = ["GAUC", "MRR", "NDCG@1", "NDCG@5", "NDCG@10"]
RANK_TIMEOUT_S = 120


def din_cfg() -> dict:
    from legommenders_tpu_torch.config import parser

    cfg = parser.parse_four_way(
        {"model": "din_text", "hidden_size": 16},
        config_root=os.path.join(ROOT, "config")).raw()["model"]
    pc = cfg["config"]["predictor_config"]
    pc.update(dnn_hidden_units=[16, 16], attention_hidden_units=[16],
              attention_dropout=0.0, net_dropout=0.0)
    cfg["config"]["cache_page_size"] = 32
    return cfg


def _data():
    from legommenders_tpu_torch.data.processors.synthetic import (
        SyntheticProcessor,
    )
    return SyntheticProcessor(**DATA_KW).as_lego_data()


def _manager(cfg, policy, data, mesh=None):
    from legommenders_tpu_torch.runtime.manager import Manager

    if mesh is not None:
        policy = {**policy, "mesh": mesh}
    return Manager(model_cfg=cfg, exp_cfg={"policy": policy,
                                           "metrics": METRICS},
                   data=data, device="cpu")


def run_case(cfg, policy, weights, data, mesh=None) -> dict:
    """From `weights`: the test metrics before training (cached where the
    model caches, and by full forwards), then Trainer.train() + test(),
    the final parameters and the full-forward test scores."""
    from legommenders_tpu_torch.runtime.trainer import Trainer

    m = _manager(cfg, policy, data, mesh)
    m.model.load_state_dict(weights)
    ev = m.evaluator()
    out = {"eval": {}}
    if m.cache is not None:
        out["eval"]["cached"] = ev.evaluate("test")
    out["eval"]["full"] = ev.evaluate("test", use_cache=False)
    tr = Trainer(m, seed=7, lm_cache_root=None)
    tr.train()
    out["test"] = tr.test()
    out["scores"] = ev.score_phase_device_full("test").numpy()
    out["params"] = {k: v.detach().clone()
                     for k, v in m.model.state_dict().items()}
    out["steps"] = tr.global_step
    return out


def rank_main(argv):
    """One dp rank: <case> <init file> <rank> <world> <weights> <out>."""
    case, init, rank, world, weights, out = argv
    torch.set_num_threads(1)
    tmesh.initialize_multihost(f"file://{init}", int(world), int(rank),
                               device="cpu")
    try:
        cfg, policy = ((NAML_CFG, POLICY) if case == "naml"
                       else (din_cfg(), DIN_POLICY))
        res = run_case(cfg, policy, torch.load(weights), _data(),
                       mesh=True)
        if int(rank) == 0:
            torch.save(res, out)
    finally:
        tmesh.shutdown()
    assert not torch.distributed.is_initialized()


def spawn(case, tmp, weights):
    """Start the two ranks of `case`; returns (processes, out path)."""
    init = os.path.join(tmp, f"{case}.init")
    out = os.path.join(tmp, f"{case}.out")
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), case, init, str(r),
         "2", weights, out], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    return procs, out


def wait(procs, out):
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    return torch.load(out, weights_only=False)


# --------------------------------------------------------------------- #
# the policy                                                            #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("cfg,dp", [({"dp": 2}, 2), (True, 2), ({}, 2),
                                    ({"dp": None}, 2)])
def test_mesh_from_policy_dp(cfg, dp, monkeypatch):
    monkeypatch.setattr(tmesh, "world", lambda: (1, 2))
    mesh = tmesh.mesh_from_policy(cfg)
    assert mesh.shape == {"dp": dp} and mesh.rank == 1
    assert not mesh.is_main


@pytest.mark.parametrize("cfg", [{"dp": 97}, "yes", {"dp": 1}])
def test_mesh_from_policy_refuses(cfg, monkeypatch):
    monkeypatch.setattr(tmesh, "world", lambda: (0, 2))
    with pytest.raises(ValueError):
        tmesh.mesh_from_policy(cfg)


def jax_layout(cfg, n):
    """JAX's mesh_from_policy over the first n virtual devices: its shape
    (mp left out at 1, as the port's `shape` leaves it) and each device's
    [dp, mp, sp, pp] coordinates (an axis JAX lays not, 0)."""
    import jax

    from legommenders_tpu.parallel.mesh import mesh_from_policy
    mesh = mesh_from_policy(cfg, devices=jax.devices()[:n])
    shape = {k: v for k, v in mesh.shape.items() if k != "mp" or v > 1}
    coords = {}
    for idx in np.ndindex(mesh.devices.shape):
        named = dict(zip(mesh.axis_names, idx))
        coords[mesh.devices[idx].id] = tuple(
            named.get(a, 0) for a in ("dp", "mp", "sp", "pp"))
    return shape, coords


def assert_laid_as_jax(cfg, n, monkeypatch):
    """The port's mesh on each rank of a group of n: JAX's shape and each
    rank's coordinates."""
    shape, coords = jax_layout(cfg, n)
    for r in range(n):
        monkeypatch.setattr(tmesh, "world", lambda r=r: (r, n))
        mesh = tmesh.mesh_from_policy(cfg)
        assert mesh.shape == shape and mesh.size == n
        assert mesh.coords == coords[r], (r, mesh.coords, coords[r])


@pytest.mark.parametrize("cfg", [{"mp": 2}, {"sp": 2}, {"pp": 2},
                                 {"dp": 1, "mp": 2},
                                 {"catalog_parallel": True}])
def test_other_axes_lay_as_jax(cfg, monkeypatch):
    """mp, sp, pp and catalog_parallel build what JAX's mesh_from_policy
    builds over a group of 2 (the (1, 2) mesh of the axis, or dp 2 with
    catalog_parallel set), and sp or pp beside mp over a group of 4 JAX's
    (1, 2, 2) mesh, with JAX's rank order."""
    import numpy as np  # noqa: F811

    assert_laid_as_jax(cfg, 2, monkeypatch)
    if "catalog_parallel" in cfg:
        assert tmesh.mesh_from_policy(cfg).catalog_parallel
    if "sp" in cfg or "pp" in cfg:
        assert_laid_as_jax({**cfg, "mp": 2}, 4, monkeypatch)


def test_one_process_mesh_is_dp_1():
    assert tmesh.mesh_from_policy(True) == tmesh.Mesh(1, 0)
    with pytest.raises(ValueError, match="only 1 visible"):
        tmesh.mesh_from_policy({"dp": 2})


def test_batch_size_must_divide_by_dp(monkeypatch):
    from legommenders_tpu_torch.runtime.trainer import Trainer

    monkeypatch.setattr(tmesh, "world", lambda: (0, 2))
    m = _manager(NAML_CFG, {**POLICY, "batch_size": 15}, _data(), mesh=True)
    assert m.mesh == tmesh.Mesh(2, 0)
    with pytest.raises(SystemExit, match="must divide by mesh dp=2"):
        Trainer(m, seed=7, lm_cache_root=None).train()


def test_shard_rows_and_generators():
    batch = {"a": np.arange(8), "b": np.arange(16).reshape(8, 2)}
    got = tmesh.shard_rows(batch, tmesh.Mesh(2, 1))
    assert got["a"].tolist() == [4, 5, 6, 7]
    assert got["b"].tolist() == [[8, 9], [10, 11], [12, 13], [14, 15]]
    from legommenders_tpu_torch.runtime.steps import step_generator

    def draw(rank):
        return torch.rand(4, generator=step_generator(3, 5, "cpu", rank))
    # rank 0 draws what one process draws; another rank draws otherwise
    assert torch.equal(draw(0), torch.rand(4, generator=step_generator(
        3, 5, "cpu")))
    assert not torch.equal(draw(0), draw(1))


# --------------------------------------------------------------------- #
# two ranks                                                             #
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """Both cases at dp 2 (their four ranks at once) and in one process,
    and JAX's NAML Trainer at dp 2, from the same weights."""
    import jax

    from legommenders_tpu.data.processors.synthetic import (
        SyntheticProcessor as JSynthetic,
    )
    from legommenders_tpu.runtime.manager import Manager as JManager
    from legommenders_tpu.runtime.trainer import Trainer as JTrainer
    from legommenders_tpu_torch.bridge import params_from_jax

    tmp = str(tmp_path_factory.mktemp("dp"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    data = _data()
    jm = JManager({}, NAML_CFG, data=JSynthetic(**DATA_KW).as_lego_data(),
                  exp_cfg={"policy": {**POLICY, "mesh": {"dp": 2}},
                           "metrics": METRICS})
    jt = JTrainer(jm, seed=7)
    jt.init()
    tree = jax.tree_util.tree_map(np.asarray, jt.params)
    weights = {"naml": params_from_jax(
        tree, _manager(NAML_CFG, POLICY, data).model)}
    weights["din"] = _manager(din_cfg(), DIN_POLICY, data).model.state_dict()
    started = {}
    for case, w in weights.items():
        path = os.path.join(tmp, f"{case}.weights")
        torch.save(w, path)
        started[case] = spawn(case, tmp, path)
    try:
        runs = {"naml_init": weights["naml"],
                "naml_one": run_case(NAML_CFG, POLICY, weights["naml"],
                                     data),
                "din_one": run_case(din_cfg(), DIN_POLICY, weights["din"],
                                    data)}
        jt.train()
        runs["jax_test"] = jt.test()
        runs["jax_params"] = params_from_jax(
            jax.tree_util.tree_map(np.asarray, jt.params),
            _manager(NAML_CFG, POLICY, data).model)
        for case, (procs, out) in started.items():
            runs[f"{case}_dp"] = wait(procs, out)
    finally:
        torch.set_num_threads(n)
        for procs, _ in started.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
    return runs


def _close_params(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].float().numpy(),
                                   want[k].float().numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=k)


def test_naml_dp2_matches_one_process(dp_runs):
    dp, one = dp_runs["naml_dp"], dp_runs["naml_one"]
    assert dp["steps"] == one["steps"] == 8
    _close_params(dp["params"], one["params"])
    for k, v in one["test"].items():
        assert abs(dp["test"][k] - v) < 5e-3, (k, dp["test"], one["test"])
    # training moved the weights: the comparison is not of two inits
    init = dp_runs["naml_init"]
    assert sum(not torch.equal(v, init[k]) for k, v in one["params"].items()
               if v.is_floating_point()) >= 8


def test_naml_dp2_matches_jax_dp2(dp_runs):
    dp = dp_runs["naml_dp"]
    _close_params(dp["params"], dp_runs["jax_params"])
    for k, v in dp_runs["jax_test"].items():
        assert abs(dp["test"][k] - v) < 5e-3, (k, dp["test"],
                                                dp_runs["jax_test"])


@pytest.mark.parametrize("case,path", [("naml", "cached"), ("naml", "full"),
                                       ("din", "full")])
def test_evaluation_under_dp2_matches_one_process(dp_runs, case, path):
    got = dp_runs[f"{case}_dp"]["eval"][path]
    want = dp_runs[f"{case}_one"]["eval"][path]
    assert list(got) == METRICS
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-6, (k, got, want)


def test_din_dp2_matches_one_process(dp_runs):
    dp, one = dp_runs["din_dp"], dp_runs["din_one"]
    assert dp["steps"] == one["steps"] == 4
    _close_params(dp["params"], one["params"])
    np.testing.assert_allclose(dp["scores"], one["scores"], rtol=0,
                               atol=1e-5)
    for k, v in one["test"].items():
        assert abs(dp["test"][k] - v) < 5e-3, (k, dp["test"], one["test"])


def test_din_scores_depend_on_the_batch_statistics():
    """Each half of a page normalized by its own statistics scores
    otherwise than the whole page: DIN under dp 2 matches one process only
    because its statistics span the ranks."""
    data = _data()
    m = _manager(din_cfg(), DIN_POLICY, data)
    ev = m.evaluator()
    sub, ph = ev.substrate(), ev.phase("test")
    u, i = ph.users[:32].long(), ph.items[:32]

    def scores(rows):
        batch = {"history": sub["hist"][u[rows]], "mask": sub["mask"][u[rows]],
                 "candidates": i[rows][:, None], "user_id": u[rows].int()}
        for c, mat in sub["extra"].items():
            batch[c] = mat[u[rows]]
        with torch.no_grad():
            return m.model(batch, m.contents.columns).reshape(-1)

    whole = scores(slice(0, 32))
    halves = torch.cat([scores(slice(0, 16)), scores(slice(16, 32))])
    assert float((whole - halves).abs().max()) > 0.05 * float(
        whole.abs().max())


if __name__ == "__main__":
    rank_main(sys.argv[1:])
