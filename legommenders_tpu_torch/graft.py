"""The entry model of the port and its multi-chip dry run.

The port of the JAX package's root `__graft_entry__.py` (which imports
JAX, so this module keeps its own copy of its NRMS configuration):

  * `_build` — NRMS (Attention item and user operators, 4 heads each,
    hidden 32, 4 negatives) on the synthetic catalog of 64 items and 32
    users (title 8, history 8), and the first batch of its train batcher
    on the device;
  * `entry()` — the eval forward and its example arguments;
  * `dryrun_multichip(n)` — over n rank processes (parallel/launch.py:
    gloo; on the card every rank shares it), the Trainer at (dp n/2,
    mp 2), the Trainer at catalog_parallel n, a 2-layer BERT's Trainer at
    (dp n/2, pp 2) against the same run in this process, the sp additive
    pool against the pool in one process; then the scaling sweep
    (scaling.py). It prints JAX's summary line and one `scaling: {...}`
    line a record.

The BERT runs its attention through the port's kernel (`fused_attention`;
JAX's dry run takes its einsum path, the same math).
"""
import contextlib
import json
from typing import Optional

import numpy as np
import torch

# __graft_entry__.py:12-23
NRMS_CFG = {
    "name": "NRMS",
    "meta": {"item": "Attention", "user": "Attention", "predictor": "Dot"},
    "config": {"use_item_content": True, "hidden_size": 32,
               "use_neg_sampling": True, "neg_count": 4,
               "item_config": {"num_attention_heads": 4},
               "user_config": {"num_attention_heads": 4}},
}
# __graft_entry__.py:104-113
BERT_CFG = {
    "meta": {"item": "Bert", "user": "Ada", "predictor": "Dot"},
    "config": {"use_item_content": True, "hidden_size": 16,
               "use_neg_sampling": True, "neg_count": 2,
               "cache_page_size": 16,
               "item_config": {"num_hidden_layers": 2,
                               "num_attention_heads": 2, "dropout": 0.0,
                               "lora_dropout": 0.0,
                               "fused_attention": True}},
}
TRAINER_STEPS = 2
SP_TOL = 1e-3
PP_GAUC_TOL = 5e-3


def nrms_cfg(hidden: int = 32,
             attention_dropout: Optional[float] = None) -> dict:
    """The entry NRMS at `hidden`; `attention_dropout` in both
    operators where given (else the operators' default, 0.1)."""
    cfg = json.loads(json.dumps(NRMS_CFG))
    cfg["config"]["hidden_size"] = hidden
    if attention_dropout is not None:
        for side in ("item_config", "user_config"):
            cfg["config"][side]["attention_dropout"] = attention_dropout
    return cfg


def synthetic(num_items: int, num_users: int, history_len: int = 8):
    from legommenders_tpu_torch.data.processors.synthetic import (
        SyntheticProcessor,
    )
    return SyntheticProcessor(num_items=num_items, num_users=num_users,
                              title_len=8, history_len=history_len,
                              inters_per_user=10).as_lego_data()


def first_batch(m) -> dict:
    """The first batch of the Manager's train batcher (seed 0, in order)
    on its device."""
    batch = next(m.train_batcher(seed=0).epoch(shuffle=False))
    return {k: torch.as_tensor(np.asarray(v)).to(m.device)
            for k, v in batch.items()}


def _build(num_items: int = 64, num_users: int = 32, hidden: int = 32,
           batch: int = 16, device="cuda",
           attention_dropout: Optional[float] = None):
    """(Manager, its first train batch): NRMS on the synthetic catalog."""
    from legommenders_tpu_torch.runtime.manager import Manager

    m = Manager(model_cfg=nrms_cfg(hidden, attention_dropout),
                exp_cfg={"policy": {"batch_size": batch, "lr": 1e-3}},
                data=synthetic(num_items, num_users), device=device)
    return m, first_batch(m)


def entry(device="cuda"):
    """(fn, example_args): the eval forward of the entry NRMS."""
    from legommenders_tpu_torch.runtime.steps import make_eval_step

    m, batch = _build(device=device)
    return make_eval_step(m.model, m.contents.columns), (batch,)


# --------------------------------------------------------------------- #
# the dry run                                                           #
# --------------------------------------------------------------------- #
@contextlib.contextmanager
def f32():
    """TF32 off inside the block (products and convolutions at f32 on the
    card, as the parity checks hold them), the settings restored after."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    prev = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = False
    try:
        yield
    finally:
        for f, v in zip(flags, prev):
            f.allow_tf32 = v


def launches() -> dict:
    """The kernel wrappers' launch counts in this process."""
    from legommenders_tpu_torch.ops.additive import additive_pool
    from legommenders_tpu_torch.ops.attention import (
        packed_attention, packed_attention_backward,
    )
    return {"additive_pool": additive_pool.launches,
            "packed_attention": packed_attention.launches,
            "packed_attention_backward": packed_attention_backward.launches}


def since(before: dict) -> dict:
    """The launches since `before` (a `launches()`)."""
    return {k: v - before[k] for k, v in launches().items()}


def _run(t, before: dict) -> dict:
    """What a Trainer run did: the test metrics, its steps, its
    evaluations (a dev pass an epoch, then the test) over the repr
    caches (items, users, page) and this process's launches."""
    cache = t.m.cache
    return {"test": t.test(), "steps": t.global_step,
            "evaluations": len(t.epochs) + 1,
            "cache": (cache.num_items, cache.num_users, cache.page_size),
            "launches": since(before)}


def nrms_trainer(mesh_policy, batch_size: int, device) -> dict:
    """JAX's run_policy: the entry NRMS through Manager and Trainer,
    one epoch of TRAINER_STEPS steps, then the test (`_run`)."""
    from legommenders_tpu_torch.runtime.manager import Manager
    from legommenders_tpu_torch.runtime.trainer import Trainer

    before = launches()
    policy = {"batch_size": int(batch_size), "lr": 1e-3, "epoch": 1,
              "epoch_batch": TRAINER_STEPS}
    if mesh_policy:
        policy["mesh"] = mesh_policy
    m = Manager(model_cfg=nrms_cfg(), exp_cfg={"policy": policy},
                data=synthetic(64, 32), device=device)
    t = Trainer(m, seed=0, lm_cache_root=None)
    t.train()
    return _run(t, before)


def bert_trainer(mesh_policy, device) -> dict:
    """JAX's run_bert: a 2-layer BERT item operator (width 16, 2 heads,
    dropout 0) through Manager and Trainer, batches of 16, one epoch of
    TRAINER_STEPS steps, then the test (`_run`); at pp 2 its layers are
    staged."""
    from legommenders_tpu_torch.parallel import mesh as pmesh
    from legommenders_tpu_torch.runtime.manager import Manager
    from legommenders_tpu_torch.runtime.trainer import Trainer

    before = launches()
    policy = {"batch_size": 16, "lr": 1e-3, "epoch": 1,
              "epoch_batch": TRAINER_STEPS}
    if mesh_policy:
        policy["mesh"] = mesh_policy
    pmesh.set_pp_mesh(None)
    try:
        m = Manager(model_cfg=json.loads(json.dumps(BERT_CFG)),
                    exp_cfg={"policy": policy},
                    data=synthetic(40, 24, history_len=4), device=device)
        t = Trainer(m, seed=0, lm_cache_root=None)
        t.train()
        return _run(t, before)
    finally:
        pmesh.set_pp_mesh(None)


def sp_inputs(n: int):
    """x (4, 8n, 16), scores (4, 8n), all-ones mask, from numpy's seed 1
    (JAX draws them with jax.random, __graft_entry__.py:138-142)."""
    rng = np.random.default_rng(1)
    B, L, D = 4, 8 * n, 16
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    s = rng.standard_normal((B, L)).astype(np.float32)
    return x, s, np.ones((B, L), np.float32)


def local_pool(x, s, mask):
    """The additive pool in one process: softmax(s) over the unmasked
    positions, sum_l w_l x_l."""
    neg = torch.finfo(s.dtype).min
    w = torch.softmax(s + (1.0 - mask) * neg, dim=-1)
    return torch.einsum("bl,bld->bd", w, x)


def sp_pool(n: int, device) -> dict:
    """The loss sum(pool ** 2) and its gradient of x through
    ops/sp_additive over an sp axis of the n ranks (each rank its L / n
    positions), beside the pool in one process on the same inputs; the
    collectives' bytes of the sharded forward and backward."""
    from legommenders_tpu_torch.ops.sp_additive import sp_additive_attention
    from legommenders_tpu_torch.parallel import mesh as pmesh

    mesh = pmesh.make_mesh(n_dp=1, n_sp=n)
    axis = mesh.sp_axis
    x, s, mask = (torch.tensor(a, device=device) for a in sp_inputs(n))
    k = x.shape[1] // n
    part = slice(axis.index * k, (axis.index + 1) * k)
    xl = x[:, part].clone().requires_grad_(True)
    with pmesh.count_collectives() as vol:
        loss = (sp_additive_attention(xl, s[:, part], mask[:, part],
                                      axis) ** 2).sum()
        loss.backward()
    xf = x.clone().requires_grad_(True)
    local = (local_pool(xf, s, mask) ** 2).sum()
    local.backward()
    grad_err = float((xl.grad - xf.grad[:, part]).abs().max()
                     / xf.grad.abs().max().clamp_min(1.0))
    return {"loss": float(loss), "local_loss": float(local),
            "grad_err": grad_err, "vol": dict(vol)}


def dryrun_meshes(n: int) -> dict:
    """The dry run's mesh policy of each Trainer pass over n ranks."""
    n_mp = 2 if n % 2 == 0 and n > 1 else 1
    return {"mesh": {"dp": n // n_mp, "mp": n_mp},
            "catalog": {"dp": n, "catalog_parallel": True},
            "pp": {"dp": n // n_mp, "pp": n_mp}}


def _dryrun_rank(n: int, device) -> dict:
    """A rank of the dry run: the Trainer passes and the sp pool; the
    NRMS passes at batches of 8 x the (dp, mp) pass's dp, as JAX's."""
    meshes = dryrun_meshes(n)
    with f32():
        out = {name: nrms_trainer(meshes[name], 8 * meshes["mesh"]["dp"],
                                  device) for name in ("mesh", "catalog")}
        out["pp"] = bert_trainer(meshes["pp"], device)
        before = launches()
        out["sp"] = sp_pool(n, device)
    out["sp"]["launches"] = since(before)
    return out


def dryrun_multichip(n_devices: int, device="cuda",
                     timeout: Optional[float] = None) -> dict:
    """The full training stack over n rank processes of a gloo group (see
    the module's docstring), the serial BERT run here, then the sweep;
    every launch of the sweep starts with the dry run's, and each rank
    runs under `timeout`. Prints the summary line and the sweep's lines;
    returns {"summary", "ranks" (each rank's passes), "serial" (the BERT
    in this process), "records" (the sweep's), "sweep_ranks" (each sweep
    launch's ranks by world size)}."""
    from legommenders_tpu_torch import scaling
    from legommenders_tpu_torch.parallel import launch

    n = int(n_devices)
    kw = {} if timeout is None else {"timeout": timeout}
    group = launch.start(_dryrun_rank, n, (n, str(device)), device, **kw)
    try:
        sweep = scaling.start_sweep(n, device=device, **kw)
    except BaseException:
        group.stop()
        raise
    try:
        with f32():
            serial = bert_trainer(None, device)
        ranks = group.wait()
        sweep_ranks = scaling.wait_sweep(sweep)
    finally:
        group.stop()
        scaling.stop_sweep(sweep)
    r0 = ranks[0]
    for name in ("mesh", "catalog", "pp"):
        assert np.isfinite(r0[name]["test"]["GAUC"]), (name, r0[name])
    assert (abs(r0["pp"]["test"]["GAUC"] - serial["test"]["GAUC"])
            < PP_GAUC_TOL), (serial["test"], r0["pp"]["test"])
    sp = r0["sp"]
    assert np.isfinite(sp["loss"])
    assert (abs(sp["loss"] - sp["local_loss"])
            < SP_TOL * max(1.0, abs(sp["local_loss"]))
            and sp["grad_err"] < SP_TOL), sp
    mesh, pp = dryrun_meshes(n)["mesh"], dryrun_meshes(n)["pp"]
    summary = (
        f"dryrun_multichip({n}): Trainer mesh(dp={mesh['dp']},mp="
        f"{mesh['mp']}) GAUC {r0['mesh']['test']['GAUC']:.4f}, "
        f"catalog-parallel({n}) GAUC {r0['catalog']['test']['GAUC']:.4f}, "
        f"pp Trainer(dp={pp['dp']},pp={pp['pp']}) GAUC "
        f"{r0['pp']['test']['GAUC']:.4f} (pp=1 "
        f"{serial['test']['GAUC']:.4f}), sp({n}) pool loss "
        f"{sp['loss']:.4f} (sp=1 {sp['local_loss']:.4f}) grad OK")
    print(summary, flush=True)
    records = scaling.records(n, sweep_ranks)
    for rec in records:
        print("scaling: " + json.dumps(rec), flush=True)
    return {"summary": summary, "ranks": ranks, "serial": serial,
            "records": records, "sweep_ranks": sweep_ranks}
