"""The port's scaling sweep, multi-chip dry run and collective counter
(legommenders_tpu_torch/scaling.py, graft.py, parallel/launch.py,
parallel/mesh.count_collectives) on the CPU.

Every multi-rank run is processes of a gloo group (parallel/launch.py,
`file://` in a temporary directory), each rank under a timeout of 120 s.
  * the counter on 2 ranks: one call of each transfer wrapper counts its
    result's bytes in its dtype (bf16 at 2 bytes, though gloo sums it in
    f32), a barrier and an axis of size 1 count nothing, and nothing is
    counted while the counter is off;
  * sweep(n=4) started from JAX's init bridged in, against JAX's
    scaling.sweep(n_devices=4) in this process on the conftest's virtual
    devices, both at attention dropout 0 (JAX's masks are the same at
    every dp width and the port's are drawn per dp rank, so step
    equivalence, and a comparison of the two, holds only without them;
    at JAX's 0.1 the two losses lie 2.6e-5 apart): the same record keys,
    the dp and (2, 2) losses within 1e-5 relative, the same
    rows_per_device; the port's dp all-reduce is 4 x (trainable
    elements + 1) = 176,900 bytes (JAX's HLO reads 96,900: it reduces the
    catalog encode's (64, 32) cotangent in place of the tables'
    gradients), and every other byte count is the one the port's code
    gives, computed here from the shapes;
  * graft.entry's eval forward against __graft_entry__.entry's from the
    same bridged params;
  * dryrun_multichip(2): the pp Trainer's GAUC within 5e-3 of the serial
    run's, the sp loss within 1e-3 of one process's, every GAUC finite;
  * a rank that fails or outlasts its timeout fails the launch, with its
    log; the sweep's command line runs on the CPU.
"""
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from legommenders_tpu_torch import graft  # noqa: E402
from legommenders_tpu_torch import scaling as tscaling  # noqa: E402
from legommenders_tpu_torch.parallel import launch  # noqa: E402
from legommenders_tpu_torch.parallel import mesh as tmesh  # noqa: E402

RANK_TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def _ranks_import_this_file(monkeypatch):
    """The ranks find this file's functions by module name."""
    path = os.environ.get("PYTHONPATH")
    here = os.path.dirname(os.path.abspath(__file__))
    monkeypatch.setenv("PYTHONPATH",
                       here + (os.pathsep + path if path else ""))


# --------------------------------------------------------------------- #
# the counter                                                           #
# --------------------------------------------------------------------- #
def _counter_rank() -> dict:
    """One call of each wrapper with the counter off, then on; the
    results of the counted calls."""
    off = []
    plain = tmesh._count
    tmesh._count = lambda *a: off.append(a)
    mesh = tmesh.make_mesh(n_dp=2)
    axis, r = mesh.dp_axis, mesh.rank

    def calls():
        return {
            "sum": tmesh.all_reduce_(torch.full((3, 5), r + 1.0), axis),
            "sum_bf16": tmesh.all_reduce_(
                torch.full((4,), r + 1.0, dtype=torch.bfloat16), axis),
            "gather": tmesh.all_gather_rows(torch.full((2, 3), float(r)),
                                            mesh),
            "to_all": tmesh._all_to_all(
                torch.arange(24.0).reshape(4, 6) + 100 * r, axis, 0, 1),
            "shift": tmesh._shift(torch.full((5,), float(r)), axis, 1),
            "shift_bf16": tmesh._shift(
                torch.full((3,), float(r), dtype=torch.bfloat16), axis, 1),
            "alone": tmesh.all_reduce_(torch.ones(7), tmesh.Axis(1, 0)),
        }

    calls()
    tmesh.barrier(mesh)
    tmesh._count = plain
    with tmesh.count_collectives() as vol:
        out = calls()
        tmesh.barrier(mesh)
    return {"off": off, "vol": dict(vol), "out": out,
            "after": tmesh._COUNTS}


def test_counter_counts_each_wrapper_result():
    ranks = launch.launch(_counter_rank, 2, timeout=RANK_TIMEOUT_S)
    want = {"all-reduce": 3 * 5 * 4 + 4 * 2, "all-gather": 2 * 2 * 3 * 4,
            "all-to-all": 4 * 6 * 4, "collective-permute": 5 * 4 + 3 * 2}
    for r, res in enumerate(ranks):
        assert res["off"] == [] and res["after"] is None
        assert res["vol"] == want
        out = res["out"]
        assert torch.equal(out["sum"], torch.full((3, 5), 3.0))
        assert out["sum_bf16"].dtype == torch.bfloat16
        assert torch.equal(out["sum_bf16"].float(), torch.full((4,), 3.0))
        assert torch.equal(out["gather"][:, 0], torch.tensor([0., 0, 1, 1]))
        # chunk r of every member, concatenated along dim 1 in member order
        rows = torch.arange(24.0).reshape(4, 6)[2 * r:2 * r + 2]
        want_a2a = torch.cat([rows + 100 * j for j in range(2)], dim=1)
        assert torch.equal(out["to_all"], want_a2a)
        assert torch.equal(out["shift"], torch.full((5,), float(1 - r)))


# --------------------------------------------------------------------- #
# the sweep against JAX's                                               #
# --------------------------------------------------------------------- #
def _jax_build(batch):
    """__graft_entry__._build's NRMS, its attention dropout 0."""
    import jax.numpy as jnp
    from legommenders_tpu.data.processors.synthetic import SyntheticProcessor
    from legommenders_tpu.runtime.manager import Manager

    data = SyntheticProcessor(num_items=64, num_users=32, title_len=8,
                              history_len=8, inters_per_user=10
                              ).as_lego_data()
    m = Manager({}, graft.nrms_cfg(attention_dropout=0.0),
                exp_cfg={"policy": {"batch_size": batch, "lr": 1e-3}},
                data=data)
    batch0 = next(m.train_batcher(seed=0).epoch(shuffle=False))
    return m, {k: jnp.asarray(v) for k, v in batch0.items()}


def _bridged_init() -> dict:
    """JAX's init_params(seed=0) of the NRMS as the port's state_dict."""
    import jax
    from legommenders_tpu.runtime.steps import init_params
    from legommenders_tpu_torch.bridge import params_from_jax

    jm, jb = _jax_build(16)
    tree = jax.tree_util.tree_map(np.asarray, init_params(
        jm.model, jb, jm.contents.columns, seed=0))["params"]
    m, _ = graft._build(device="cpu", attention_dropout=0.0)
    return params_from_jax(tree, m.model)


def _expected_bytes(n: int) -> dict:
    """What the port's code moves in one step of each point, from the
    shapes: dp averages every gradient and the loss in one f32 buffer;
    (dp n/2, mp 2) also sums each row-sharded lookup of the catalog's
    content columns over mp, and averages the sharded tables' halves;
    sp gathers the B per-rank maxima and sums Z (B) and W (B, D); pp
    shifts a microbatch between stages at every tick but the last and
    sums the last stage's outputs; catalog_parallel gathers the padded
    catalog's reprs, sums their cotangent, then averages the gradients
    and the loss."""
    m, _ = graft._build(device="cpu")
    P = sum(p.numel() for p in m.model.parameters() if p.requires_grad)
    tables = dict(m.model.eh.tables.items())
    assert all(t.shape[0] % 2 == 0 and t.shape[0] >= 2
               for t in tables.values())  # every table shards at mp 2
    D = next(iter(tables.values())).shape[1]
    lookups = sum(a.numel() for a in m.contents.columns.values()) * D
    local = P - sum(t.numel() // 2 for t in tables.values())
    B, L = graft.sp_inputs(n)[1].shape
    Dx = graft.sp_inputs(n)[0].shape[2]
    rows, T, W = tscaling.PP_SHAPE
    M, stages = 4, 2
    mb = rows // M
    from legommenders_tpu_torch.runtime.manager import Manager
    naml = Manager(model_cfg=json.loads(json.dumps(tscaling.CATALOG_CFG)),
                   exp_cfg={"policy": {"batch_size": 16}},
                   data=graft.synthetic(100, 40, history_len=6),
                   device="cpu")
    Pn = sum(p.numel() for p in naml.model.parameters() if p.requires_grad)
    n_pad = -(-100 // n) * n
    D_naml = tscaling.CATALOG_CFG["config"]["hidden_size"]
    return {
        "dp": {"all-reduce": 4 * (P + 1)},
        "mp": {"all-reduce": 4 * lookups + 4 * (local + 1)},
        "sp": {"all-gather": 4 * n * B, "all-reduce": 4 * (B + B * Dx)},
        "pp": {"collective-permute": 4 * (M + stages - 2) * mb * T * W,
               "all-reduce": 4 * rows * T * W},
        "catalog": {"all-gather": 4 * n_pad * D_naml,
                    "all-reduce": 4 * n_pad * D_naml + 4 * (Pn + 1)},
        "trainable": P,
    }


def test_sweep_against_jax(monkeypatch, capsys):
    import scaling as jscaling

    init = _bridged_init()
    port = {}

    def run():
        try:
            port["records"] = tscaling.sweep(4, device="cpu", init=init,
                                             timeout=RANK_TIMEOUT_S)
        except BaseException as e:  # raised below, in the test's thread
            port["error"] = e

    th = threading.Thread(target=run)
    th.start()
    try:
        monkeypatch.setattr(jscaling, "_build", _jax_build)
        theirs = jscaling.sweep(n_devices=4)
    finally:
        th.join()
    if "error" in port:
        raise port["error"]
    ours = port["records"]
    want = _expected_bytes(4)
    with capsys.disabled():
        print(f"\nport dp all-reduce {ours[1]['collective_bytes']} vs JAX's "
              f"HLO {theirs[1]['collective_bytes']}")
    assert len(ours) == len(theirs) == 7
    for a, b in zip(ours, theirs):
        assert set(a) - {"collective_bytes_by_rank"} == set(b), (a, b)
        assert a["ok"] is True
    for a, b in zip(ours[:4], theirs[:4]):
        assert (a["dp"], a["mp"]) == (b["dp"], b["mp"])
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"]), (a, b)
    assert ours[-1]["rows_per_device"] == theirs[-1]["rows_per_device"] \
        == [25]
    for rec in ours[1:3]:
        assert rec["collective_bytes"] == want["dp"] == {
            "all-reduce": 176900}
    assert want["trainable"] == 44224
    assert ours[0]["collective_bytes"] == {}
    assert ours[3]["collective_bytes"] == want["mp"]
    assert ours[4]["collective_bytes"] == want["sp"]
    assert ours[5]["collective_bytes"] == want["pp"]
    assert ours[6]["collective_bytes"] == want["catalog"]


# --------------------------------------------------------------------- #
# the entry and the dry run                                             #
# --------------------------------------------------------------------- #
def test_entry_forward_against_jax(monkeypatch):
    """graft.entry's eval forward: finite (B, K) scores of its example
    batch, equal to __graft_entry__.entry's forward on the same batch
    from JAX's params bridged in (1e-5)."""
    import jax
    import __graft_entry__
    from legommenders_tpu_torch.bridge import params_from_jax

    built = []
    build = graft._build

    def keep(**kw):
        built.append(build(**kw))
        return built[-1]

    monkeypatch.setattr(graft, "_build", keep)
    fn, (batch,) = graft.entry(device="cpu")
    jfn, (params, jbatch) = __graft_entry__.entry()
    for k, v in batch.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jbatch[k]))
    model = built[0][0].model
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)["params"], model))
    got = fn(batch).numpy()
    assert got.shape == tuple(batch["candidates"].shape)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, np.asarray(jfn(params, jbatch)),
                               rtol=1e-5, atol=1e-5)


def test_dryrun_multichip_two(capsys):
    out = graft.dryrun_multichip(2, "cpu", timeout=RANK_TIMEOUT_S)
    printed = capsys.readouterr().out
    assert out["summary"] in printed
    assert printed.count("scaling: ") == len(out["records"]) == 5
    r0 = out["ranks"][0]
    for name in ("mesh", "catalog", "pp"):
        assert np.isfinite(r0[name]["test"]["GAUC"])
    assert np.isfinite(out["serial"]["test"]["GAUC"])
    assert abs(r0["pp"]["test"]["GAUC"]
               - out["serial"]["test"]["GAUC"]) < 5e-3
    sp = r0["sp"]
    assert abs(sp["loss"] - sp["local_loss"]) < 1e-3 * max(
        1.0, abs(sp["local_loss"]))
    assert [r["pp"]["steps"] for r in out["ranks"]] == [2, 2]


# --------------------------------------------------------------------- #
# failures and the command line                                         #
# --------------------------------------------------------------------- #
def _fail_on_rank_one():
    if tmesh.world()[0] == 1:
        raise ValueError("rank one fails here")
    import time
    time.sleep(60)  # held until the launcher stops it


@pytest.mark.parametrize("fn,args,timeout,said", [
    (_fail_on_rank_one, (), RANK_TIMEOUT_S, "rank one fails here"),
    ("time:sleep", (60,), 3, "timed out after 3 s")])
def test_a_failed_or_late_rank_fails_the_launch(fn, args, timeout, said):
    with pytest.raises(RuntimeError, match=said):
        launch.launch(fn, 2, args, timeout=timeout)


def test_sweep_command_line_on_cpu():
    env = {**os.environ, "PYTHONPATH": ROOT}
    res = subprocess.run(
        [sys.executable, "-m", "legommenders_tpu_torch.scaling", "--device",
         "cpu", "--n", "2"], env=env, capture_output=True, text=True,
        timeout=2 * RANK_TIMEOUT_S)
    assert res.returncode == 0, res.stderr[-3000:]
    recs = [json.loads(line) for line in res.stdout.splitlines()]
    assert [sorted(k for k in r if k in ("dp", "sp", "pp",
                                         "catalog_parallel"))
            for r in recs] == [["dp"], ["dp"], ["sp"], ["pp"],
                               ["catalog_parallel"]]
    assert all(r["ok"] for r in recs)
