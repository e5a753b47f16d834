"""The scaling sweep over rank processes: step equivalence and the bytes
each collective moves.

The port of the JAX package's root `scaling.py`. JAX runs each point on
the first devices of one process's (virtual) mesh and reads the bytes
of each collective from the compiled HLO; here each point runs on rank
processes of a gloo group (parallel/launch.py; on the card every rank
shares it) and counts the bytes at the port's transfer wrappers
(`parallel.mesh.count_collectives`: each call's result, in its dtype).
The points and their asserts are JAX's:

  * dp 1, 2, 4, 8 up to n, and (n/2, mp 2) where n >= 4: the entry
    NRMS (graft._build) through `parallel/train.make_mesh_train_step_folded`,
    Adam at 1e-3, `steps` steps on the first batch, its tables sharded
    from n_mp rows; the last step's loss within `rtol` of dp 1's and
    every parameter within 5e-3. At attention dropout 0: JAX draws one
    mask for the whole batch at every dp width, while the port's mesh
    step folds the dp index into each rank's generator, so with dropout
    the widths would train on different draws, not the same step;
  * sp n: ops/sp_additive's pool of x (4, 8n, 16) over the n ranks,
    forward and gradient, against the pool in one process (loss within
    1e-3, gradient within 1e-3 of its largest);
  * pp 2: a 2-layer, 2-head, width-16 BERT slice staged over two ranks
    (its attention through the port's kernel: f32, head width 8, T 6)
    against the serial slice, within 1e-4;
  * catalog_parallel n: the dropout-free NAML of JAX's point through
    `parallel/catalog.make_catalog_parallel_step`, against one process's
    step (loss within `rtol`, parameters within 5e-3), and the catalog
    rows each rank holds.

Each record has JAX's keys; `collective_bytes` is rank 0's {kind: bytes}
of one step (the last), and where the ranks differ
`collective_bytes_by_rank` lists each rank's. One launch a world size
(1, 2, ..., n): the points of one size run in turn in its ranks, each on
its own mesh, and the launches run at once.

    python -m legommenders_tpu_torch.scaling [--device cpu] [--n 8]

runs on the card by default (every rank on it, over gloo) and prints one
JSON line a record; a rank that fails or outlasts its timeout makes it
exit non-zero.
"""
import argparse
import copy
import json
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from legommenders_tpu_torch import graft
from legommenders_tpu_torch.parallel import launch
from legommenders_tpu_torch.parallel import mesh as pmesh

STEPS = 3
RTOL = 2e-4
PARAM_TOL = 5e-3
PP_TOL = 1e-4
# the NRMS points' attention dropout (JAX's model: the operators' 0.1)
ATTENTION_DROPOUT = 0.0
# JAX's catalog-parallel point: the dropout-free NAML (scaling.py:194-206)
CATALOG_CFG = {
    "meta": {"item": "CNN", "user": "Ada", "predictor": "Dot"},
    "config": {"use_item_content": True, "hidden_size": 16,
               "use_neg_sampling": True, "neg_count": 2,
               "full_catalog_encode": "on",
               "item_config": {"dropout": 0.0}},
}
PP_SHAPE = (8, 6, 16)  # rows, tokens, width of the pp point


def dps(n: int) -> List[int]:
    return [d for d in (1, 2, 4, 8) if d <= n]


def world_sizes(n: int) -> List[int]:
    """The group sizes the sweep launches: its dp widths, n, and 2 for
    the pp point."""
    return sorted(set(dps(n)) | {n} | ({2} if n >= 2 else set()))


def _params(model, mesh) -> Dict[str, np.ndarray]:
    """Every parameter whole (a row-sharded table gathered over mp), on
    the host."""
    plan = pmesh.model_plan(model)
    out = {}
    for name, p in model.named_parameters():
        t = p.detach()
        if plan is not None and name in plan.sharded:
            t = pmesh.all_gather_dim(t.contiguous(), mesh.mp_axis,
                                     plan.sharded[name])
        out[name] = t.float().cpu().numpy()
    return out


def run_point(n_dp: int, n_mp: int, batch_size: int, steps: int, device,
              init: Optional[dict] = None,
              build: Optional[Callable] = None) -> dict:
    """One (dp, mp) point on this group (of n_dp x n_mp ranks; at (1, 1)
    also in a process without one): the last step's loss and
    collectives, the parameters after (rank 0's, whole), this rank's
    launches. `build(batch_size, device)` gives (Manager, batch) in place
    of the entry NRMS."""
    from legommenders_tpu_torch.parallel.train import (
        make_mesh_train_step_folded,
    )
    from legommenders_tpu_torch.runtime.steps import adam

    mesh = pmesh.make_mesh(n_dp, n_mp, min_rows_to_shard=n_mp)
    if build is None:
        m, batch = graft._build(batch=batch_size, device=device,
                                attention_dropout=ATTENTION_DROPOUT)
    else:
        m, batch = build(batch_size, device)
    if init is not None:
        m.model.load_state_dict(init)
    trainable = sum(p.numel() for p in m.model.parameters()
                    if p.requires_grad)
    pmesh.place_model(m.model, mesh)
    step = make_mesh_train_step_folded(m.model, m.contents.columns,
                                       adam(m.model, 1e-3), mesh)
    rows = pmesh.shard_rows(batch, mesh)
    before = graft.launches()
    for i in range(steps - 1):
        step(rows, i)
    with pmesh.count_collectives() as vol:
        loss = float(step(rows, steps - 1))
    launches = graft.since(before)
    params = _params(m.model, mesh)
    return {"loss": loss, "vol": dict(vol), "launches": launches,
            "trainable": trainable,
            "params": params if mesh.rank == 0 else None}


def sp_point(n: int, device) -> dict:
    before = graft.launches()
    out = graft.sp_pool(n, device)
    out["launches"] = graft.since(before)
    return out


def pp_point(pp: int, device) -> dict:
    """The staged slice's output against the serial slice's, forward
    only (JAX's point), from the same weights (seed 0) and inputs."""
    from legommenders_tpu_torch.models.lm.layers import BertEncoderSlice

    mesh = pmesh.make_mesh(n_dp=1, n_pp=pp)
    B, L, D = PP_SHAPE
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.standard_normal((B, L, D)).astype(np.float32),
                     device=device)
    mask = torch.ones((B, L), dtype=torch.int32, device=device)
    kw = dict(num_layers=2, dim=D, num_heads=2, start=0, embed=False,
              dropout=0.0, fused_attention=True)
    serial = BertEncoderSlice(**kw)
    serial.reset_parameters(torch.Generator().manual_seed(0))
    piped = BertEncoderSlice(**kw, pipeline_stages=pp)
    piped.load_state_dict(serial.state_dict())
    serial.to(device)
    piped.to(device)
    before = graft.launches()
    with torch.no_grad():
        y0 = serial(x, mask)
        with pmesh.pipeline_parallel(mesh), \
                pmesh.count_collectives() as vol:
            y1 = piped(x, mask)
    return {"dev": float((y1 - y0).abs().max()), "vol": dict(vol),
            "launches": graft.since(before)}


def catalog_point(n: int, batch_size: int, device) -> dict:
    """One catalog-parallel step over the n ranks against one process's
    step from the same weights on the same batch."""
    from legommenders_tpu_torch.parallel.catalog import (
        make_catalog_parallel_step, place_catalog,
    )
    from legommenders_tpu_torch.runtime.manager import Manager
    from legommenders_tpu_torch.runtime.steps import (
        adam, make_train_step_folded,
    )

    m = Manager(model_cfg=copy.deepcopy(CATALOG_CFG),
                exp_cfg={"policy": {"batch_size": batch_size}},
                data=graft.synthetic(100, 40, history_len=6), device=device)
    batch = graft.first_batch(m)
    init = copy.deepcopy(m.model.state_dict())
    before = graft.launches()
    ref_loss = float(make_train_step_folded(
        m.model, m.contents.columns, adam(m.model, 1e-3))(batch, 0))
    ref = {k: p.detach().cpu().numpy() for k, p in m.model.named_parameters()}
    m.model.load_state_dict(init)
    mesh = pmesh.make_mesh(n_dp=n)
    local, num = place_catalog(dict(m.contents.columns), mesh)
    step = make_catalog_parallel_step(m.model, adam(m.model, 1e-3), mesh,
                                      local, num)
    with pmesh.count_collectives() as vol:
        loss = float(step(pmesh.shard_rows(batch, mesh), 0))
    dev = max(float(np.abs(p.detach().cpu().numpy() - ref[k]).max())
              for k, p in m.model.named_parameters())
    return {"loss": loss, "ref_loss": ref_loss, "dev": dev,
            "rows": int(next(iter(local.values())).shape[0]),
            "vol": dict(vol), "launches": graft.since(before)}


def _timed(fn, *args) -> dict:
    t0 = time.perf_counter()
    out = fn(*args)
    out["s"] = time.perf_counter() - t0
    return out


def sweep_rank(world: int, n: int, steps: int, batch_size: int, device,
               init: Optional[dict] = None) -> dict:
    """A rank of the launch of `world` ranks: its points, by label, at
    f32 (TF32 off)."""
    with graft.f32():
        return _sweep_points(world, n, steps, batch_size, device, init)


def _sweep_points(world, n, steps, batch_size, device, init) -> dict:
    out = {}
    if world in dps(n):
        out[f"dp {world}"] = _timed(run_point, world, 1, batch_size, steps,
                                    device, init)
    if world == n and n >= 4:
        out[f"dp {n // 2} mp 2"] = _timed(run_point, n // 2, 2, batch_size,
                                          steps, device, init)
    if world == n:
        out[f"sp {n}"] = _timed(sp_point, n, device)
    if world == 2:
        out["pp 2"] = _timed(pp_point, 2, device)
    if world == n:
        out[f"catalog {n}"] = _timed(catalog_point, n, batch_size, device)
    return out


def start_sweep(n: int, steps: int = STEPS, batch_size: int = 16,
                device="cuda", init: Optional[dict] = None,
                timeout: float = launch.RANK_TIMEOUT_S) -> dict:
    """Start one launch a world size, all at once: {world: Launch}.
    `init`: the entry NRMS's initial weights (a state_dict), else its
    own from seed 0."""
    handles = {}
    try:
        for w in world_sizes(n):
            handles[w] = launch.start(
                sweep_rank, w, (w, n, steps, batch_size, str(device), init),
                device, timeout)
    except BaseException:
        stop_sweep(handles)
        raise
    return handles


def stop_sweep(handles: dict):
    for h in handles.values():
        h.stop()


def wait_sweep(handles: dict) -> Dict[int, List[dict]]:
    """{world: each rank's points}; on a failure every launch is
    stopped."""
    try:
        return {w: h.wait() for w, h in handles.items()}
    finally:
        stop_sweep(handles)


def _bytes(rec: dict, ranks: List[dict], label: str) -> dict:
    vols = [r[label]["vol"] for r in ranks]
    rec["collective_bytes"] = vols[0]
    if any(v != vols[0] for v in vols):
        rec["collective_bytes_by_rank"] = vols
    return rec


def records(n: int, sweep_ranks: Dict[int, List[dict]],
            rtol: float = RTOL) -> List[dict]:
    """The sweep's records from its ranks' results (JAX's keys, order and
    asserts)."""
    out = []
    points = [(d, 1) for d in dps(n)] + ([(n // 2, 2)] if n >= 4 else [])
    ref = None
    for n_dp, n_mp in points:
        label = f"dp {n_dp}" + (" mp 2" if n_mp == 2 else "")
        ranks = sweep_ranks[n_dp * n_mp]
        r0 = ranks[0][label]
        loss, params = r0["loss"], r0["params"]
        if ref is None:
            ref, max_dev = r0, 0.0
        else:
            max_dev = max(float(np.abs(params[k] - ref["params"][k]).max())
                          for k in ref["params"])
            assert abs(loss - ref["loss"]) <= rtol * max(
                1.0, abs(ref["loss"])), \
                f"dp={n_dp} mp={n_mp}: loss {loss} != ref {ref['loss']}"
            assert max_dev < PARAM_TOL, \
                f"dp={n_dp} mp={n_mp}: params diverged by {max_dev}"
        out.append(_bytes({"dp": n_dp, "mp": n_mp, "loss": round(loss, 6),
                           "max_param_dev_vs_ref": max_dev}, ranks, label))
        out[-1]["ok"] = True
    ranks = sweep_ranks[n]
    sp = ranks[0][f"sp {n}"]
    ok = bool(np.isfinite(sp["loss"]))
    assert ok and abs(sp["loss"] - sp["local_loss"]) <= graft.SP_TOL * max(
        1.0, abs(sp["local_loss"])), sp
    assert all(r[f"sp {n}"]["grad_err"] < graft.SP_TOL for r in ranks), \
        [r[f"sp {n}"]["grad_err"] for r in ranks]
    out.append(_bytes({"sp": n, "loss": sp["loss"]}, ranks, f"sp {n}"))
    out[-1]["ok"] = ok
    if n >= 2:
        pp = sweep_ranks[2]
        dev = max(r["pp 2"]["dev"] for r in pp)
        assert dev < PP_TOL, f"pp=2 staged slice diverged by {dev}"
        out.append(_bytes({"pp": 2, "max_out_dev_vs_serial": dev}, pp,
                          "pp 2"))
        out[-1]["ok"] = True
    label = f"catalog {n}"
    cat = ranks[0][label]
    assert abs(cat["loss"] - cat["ref_loss"]) <= rtol * max(
        1.0, abs(cat["ref_loss"])), cat
    dev = max(r[label]["dev"] for r in ranks)
    assert dev < PARAM_TOL, f"catalog-parallel params diverged by {dev}"
    out.append(_bytes({"catalog_parallel": n,
                       "rows_per_device": sorted({r[label]["rows"]
                                                  for r in ranks}),
                       "loss": round(cat["loss"], 6),
                       "max_param_dev_vs_ref": dev}, ranks, label))
    out[-1]["ok"] = True
    return out


def sweep(n_devices: int = 8, steps: int = STEPS, batch_size: int = 16,
          rtol: float = RTOL, device="cuda", init: Optional[dict] = None,
          timeout: float = launch.RANK_TIMEOUT_S) -> List[dict]:
    """The dp sweep, the (dp, mp 2), sp, pp and catalog-parallel points
    over n_devices ranks; asserts step equivalence; the records."""
    handles = start_sweep(n_devices, steps, batch_size, device, init,
                          timeout)
    return records(n_devices, wait_sweep(handles), rtol)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=8, help="ranks (default 8)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; every rank on the card) or cpu")
    ap.add_argument("--timeout", type=float, default=launch.RANK_TIMEOUT_S,
                    help="seconds each rank may take")
    args = ap.parse_args(argv)
    for rec in sweep(args.n, device=args.device, timeout=args.timeout):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
