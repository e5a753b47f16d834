"""The mesh combinations the port's multi-rank tests hold against one
process and against JAX (tests/test_torch_mesh_combos*.py and
tests/test_torch_catalog_parallel.py): the configurations, the runs each
side makes, the rank processes and the checks.

Each case is one configuration on one [dp, mp, sp, pp] layout. Every side
starts from the same weights (JAX's Trainer init, bridged) and the same
batch (the first host batch of 16, seed 0), and reports the loss and every
gradient of one Adam step (lr 1e-3), the weights after it, the dev value
and the test phase's scores after it (a page is 16 rows: the first pages
are compared), and the port's sides the test metrics (JAX's are a
function of its scores). Dropout is 0 and everything is f32.

  * the port on gloo ranks: processes of the calling test file (`python
    tests/<file> <group> <init> <rank> <tmp>`), over `file://` in tmp, 120
    s a rank; each rank runs the Trainer's `init` (the layer-split cache,
    the placement, the ambient meshes) and then the step the Trainer would
    run, and writes its results; the test assembles the mp slices of each
    (dp, sp, pp) cell;
  * the port in one process (for the catalog-parallel flatten case the
    catalog-parallel step on a mesh of one, as JAX's catalog step and the
    plain forward differ for a flatten model);
  * JAX on a mesh of the same shape over the virtual CPU devices: its
    Trainer's placement, `value_and_grad` of its loss (or of its catalog
    step's loss) and its sharded (or catalog-parallel) step, its
    Evaluator's scores and dev value.
Tolerances: losses 1e-5 relative; each gradient within 1e-4 of its
tensor's largest |value|; the weights after the step rtol 2e-4, atol 2e-5
where the reference gradient lies outside its gate of zero (inside it
the sign of Adam's first update follows rounding residue); the attention
key biases' gradients and weights left out, as
tests/test_torch_mp.py leaves them: their exact gradient is 0, each side
holds rounding residue, and Adam amplifies it differently under each
partitioning. Scores within 1e-5 (relative and absolute: the Dot
scores here reach ~16, where f32's spacing is 2e-6), the dev value and
the test metrics within 1e-5.
"""
import copy
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from legommenders_tpu_torch.parallel import mesh as tmesh  # noqa: E402

RANK_TIMEOUT_S = 120
DATA_KW = dict(num_items=40, num_users=24, title_len=8, history_len=4,
               inters_per_user=10)
METRICS = ["GAUC", "MRR", "NDCG@1", "NDCG@5", "NDCG@10"]
POLICY = {"batch_size": 16, "eval_batch_size": 16, "epoch": 1, "lr": 1e-3}
STATE_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_REL = 1e-4
SCORE_TOL = 1e-5
LOSS_REL = 1e-5


def flatten_cfg(item: str = "Transformer", sp_impl: str = "") -> dict:
    """A flatten Transformer user operator over sp (the history's 4
    clicks x 9 tokens), with a Transformer or a 2-layer BERT item
    operator (JAX's test_mesh_policy_sp_flatten_transformer model)."""
    layer = {"num_hidden_layers": 1, "num_attention_heads": 4,
             "attention_dropout": 0.0}
    user = dict(layer, sequence_parallel=True)
    if sp_impl:
        user["sp_impl"] = sp_impl
    item_cfg = (dict(layer) if item == "Transformer" else
                {"num_hidden_layers": 2, "num_attention_heads": 2,
                 "dropout": 0.0, "lora_dropout": 0.0, "attention_pack": 0})
    return {"meta": {"item": item, "user": "FlattenTransformer",
                     "predictor": "Dot"},
            "config": {"use_item_content": True, "hidden_size": 16,
                       "use_neg_sampling": True, "neg_count": 2,
                       "use_fast_eval": False, "flatten_mode": True,
                       "item_config": item_cfg, "user_config": user}}


def bert_cfg(fast_eval: bool = True) -> dict:
    """bert-naml layer-split: a 3-layer BERT (2 heads, LoRA r 2) at
    tune_from 1 (pp 2 stages its two upper layers) or 2."""
    return {"meta": {"item": "Bert", "user": "Ada", "predictor": "Dot"},
            "config": {"use_item_content": True, "hidden_size": 16,
                       "use_neg_sampling": True, "neg_count": 2,
                       "cache_page_size": 16, "use_fast_eval": fast_eval,
                       "item_config": {
                           "num_hidden_layers": 3, "num_attention_heads": 2,
                           "tune_from": 1 if fast_eval else 2,
                           "use_lora": True, "lora_r": 2,
                           "dropout": 0.0, "lora_dropout": 0.0,
                           "attention_pack": 0},
                       "user_config": {"dropout": 0.0}}}


# name: (config, mesh policy, extra policy, the one-process mesh policy)
CASES = {
    "mpsp_ulysses": (flatten_cfg(), {"dp": 1, "mp": 2, "sp": 2,
                                     "min_rows_to_shard": 2}, {}, None),
    "mpsp_ring": (flatten_cfg(sp_impl="ring"),
                  {"dp": 1, "mp": 2, "sp": 2, "min_rows_to_shard": 2}, {},
                  None),
    "sppp": (flatten_cfg("Bert"), {"dp": 1, "sp": 2, "pp": 2}, {}, None),
    "mppp": (bert_cfg(), {"dp": 1, "mp": 2, "pp": 2}, {}, None),
    "dpmppp": (bert_cfg(), {"dp": 2, "mp": 2, "pp": 2}, {}, None),
    "spcat": (flatten_cfg(), {"dp": 2, "sp": 2, "catalog_parallel": True},
              {}, {"catalog_parallel": True}),
    "catdp": (bert_cfg(False), {"dp": 2, "catalog_parallel": True},
              {"simple_dev": True}, None),
    "catmp": (bert_cfg(False), {"dp": 1, "mp": 2, "catalog_parallel": True},
              {"simple_dev": True}, None),
}


def world(name: str) -> int:
    mesh = CASES[name][1]
    return int(np.prod([mesh.get(a, 1) for a in ("dp", "mp", "sp", "pp")]))


def data():
    from legommenders_tpu_torch.data.processors.synthetic import (
        SyntheticProcessor,
    )
    return SyntheticProcessor(**DATA_KW).as_lego_data()


def manager(name: str, mesh_cfg=None):
    from legommenders_tpu_torch.runtime.manager import Manager
    cfg, _, extra, _ = CASES[name]
    policy = {**POLICY, **extra}
    if mesh_cfg:
        policy["mesh"] = mesh_cfg
    return Manager(model_cfg=copy.deepcopy(cfg),
                   exp_cfg={"policy": policy, "metrics": METRICS},
                   data=data(), device="cpu")


class Recorder:
    """An optimizer that keeps the (reduced) gradients before stepping."""

    def __init__(self, opt):
        self.opt, self.grads = opt, {}

    @property
    def param_groups(self):
        return self.opt.param_groups

    def zero_grad(self, set_to_none=True):
        self.opt.zero_grad(set_to_none=set_to_none)

    def step(self):
        self.grads = {id(p): p.grad.detach().clone()
                      for g in self.opt.param_groups for p in g["params"]
                      if p.grad is not None}
        self.opt.step()


# --------------------------------------------------------------------- #
# the port                                                              #
# --------------------------------------------------------------------- #
def port_run(name: str, inputs: dict, on_mesh: bool = True) -> dict:
    """One Adam step of case `name` on this process (a rank of its mesh,
    or one process), then the dev value, the test scores and metrics."""
    from legommenders_tpu_torch.parallel.catalog import (
        make_catalog_parallel_step,
    )
    from legommenders_tpu_torch.parallel.train import (
        make_mesh_train_step_folded,
    )
    from legommenders_tpu_torch.runtime import steps
    from legommenders_tpu_torch.runtime.tester import Tester
    from legommenders_tpu_torch.runtime.trainer import Trainer

    m = manager(name, CASES[name][1] if on_mesh else CASES[name][3])
    m.model.load_state_dict(inputs["weights"][name])
    tr = Trainer(m, seed=5, lm_cache_root=None)
    try:
        tr.init()
        model, mesh = m.model, m.mesh
        opt = Recorder(steps.adam(model, 1e-3))
        batch = {k: torch.as_tensor(v) for k, v in inputs["batch"].items()}
        if mesh is not None:
            batch = tmesh.shard_rows(batch, mesh)
        if mesh is not None and mesh.catalog_parallel:
            n = len(next(iter(m.contents.columns.values())))
            loss = make_catalog_parallel_step(
                model, opt, mesh, m.catalog_contents(), n)(batch, 1)
        elif mesh is not None:
            loss = make_mesh_train_step_folded(
                model, m.contents.columns, opt, mesh)(batch, 1)
        else:
            loss = steps.make_train_step(model, m.contents.columns, opt)(
                batch, steps.step_generator(0, 1, "cpu"))
        names = {id(p): k for k, p in model.named_parameters()}
        ev = tr.evaluator
        with tmesh.no_pipeline():
            if ev.cache is not None:
                ev.cache.cache()
                scores = ev.score_phase_device("test")
            else:
                scores = ev.score_phase_device_full("test")
        plan = tmesh.model_plan(model)
        local = m._catalog_contents or {}
        return {"loss": float(loss),
                "local_rows": len(local.get("__lm_hidden__", ())),
                "grads": {names[i]: g for i, g in opt.grads.items()},
                "state": {k: v.detach().clone()
                          for k, v in model.state_dict().items()},
                "plan": dict(plan.sharded) if plan else {},
                "coords": mesh.coords if mesh is not None else (0,) * 4,
                "dev": float(tr.dev()), "scores": scores[:32].clone(),
                "test": Tester(m).test()}
    finally:
        tmesh.set_sp_mesh(None)
        tmesh.set_pp_mesh(None)


def rank_main(argv, groups):
    """One rank: <group> <init file> <rank> <tmp dir>; the group's cases
    run in turn and each writes <case>.<rank>.pt."""
    group, init, rank, tmp = argv
    torch.set_num_threads(1)
    tmesh.initialize_multihost(f"file://{init}", world(groups[group][0]),
                               int(rank), device="cpu")
    try:
        inputs = torch.load(os.path.join(tmp, "inputs.pt"),
                            weights_only=False)
        for name in groups[group]:
            torch.save(port_run(name, inputs),
                       os.path.join(tmp, f"{name}.{rank}.pt"))
    finally:
        tmesh.shutdown()


def spawn(script: str, group: str, cases, tmp: str):
    init = os.path.join(tmp, f"{group}.init")
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen(
        [sys.executable, script, group, init, str(r), tmp], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world(cases[0]))]


def wait(procs):
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-6000:]


def load(tmp: str, name: str) -> list:
    return [torch.load(os.path.join(tmp, f"{name}.{r}.pt"),
                       weights_only=False) for r in range(world(name))]


# --------------------------------------------------------------------- #
# JAX                                                                   #
# --------------------------------------------------------------------- #
def _ambient(mesh):
    """JAX's ambient sp and pp meshes: those of `mesh` (its Trainer's
    placement sets them), or none."""
    from legommenders_tpu.parallel.mesh import set_pp_mesh, set_sp_mesh
    shape = dict(mesh.shape) if mesh is not None else {}
    set_sp_mesh(mesh if shape.get("sp", 1) > 1 else None)
    set_pp_mesh(mesh if shape.get("pp", 1) > 1 else None)


def jax_weights(name: str):
    """JAX's Trainer for case `name` on its mesh of virtual devices,
    initialised (its weights placed, the layer-split cache built, the
    ambient meshes set), and its initial weights bridged to the port."""
    import jax

    from legommenders_tpu.data.processors.synthetic import (
        SyntheticProcessor as JSynthetic,
    )
    from legommenders_tpu.runtime.manager import Manager as JManager
    from legommenders_tpu.runtime.trainer import Trainer as JTrainer
    from legommenders_tpu_torch.bridge import params_from_jax

    cfg, mesh_cfg, extra, _ = CASES[name]
    jm = JManager({}, copy.deepcopy(cfg), data=JSynthetic(
        **DATA_KW).as_lego_data(), exp_cfg={
        "policy": {**POLICY, **extra, "mesh": dict(mesh_cfg)},
        "metrics": METRICS})
    jt = JTrainer(jm, seed=5)
    try:
        jt.init()
    finally:
        _ambient(None)
    weights = params_from_jax(
        jax.tree_util.tree_map(np.asarray, jax.device_get(jt.params)),
        manager(name).model)
    return jt, weights


def jax_run(name: str, jt, batch: dict) -> dict:
    """JAX's loss, gradients, step, dev value, scores and test metrics for
    case `name` on the mesh `jt` (jax_weights') was placed on."""
    import jax
    import jax.numpy as jnp
    import optax

    from legommenders_tpu.parallel.catalog import (
        make_catalog_parallel_step, place_catalog, sharded_catalog_encode,
    )
    from legommenders_tpu.parallel.mesh import no_pipeline, shard_batch
    from legommenders_tpu.parallel.train import make_sharded_train_step
    from legommenders_tpu.runtime.steps import (
        make_loss_fn, neg_sampling_loss,
    )
    from legommenders_tpu_torch.bridge import params_from_jax

    jm = jt.m
    mesh, model = jm.mesh, jm.model
    opt = optax.adam(1e-3)
    key = jax.random.PRNGKey(0)
    params = jt.params
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    _ambient(mesh)
    try:
        if jm.catalog_parallel:
            contents, _ = place_catalog(dict(jm.contents.columns), mesh)
            encode = sharded_catalog_encode(model, mesh)

            def loss_fn(p, b):
                # JAX make_catalog_parallel_step's loss, at dropout 0
                reprs = encode(p, contents, key, True)
                n = next(iter(contents.values())).shape[0]
                item = jnp.take(reprs, jnp.clip(b[model.candidate_col], 0,
                                                n - 1), axis=0)
                clicks = jnp.take(reprs, jnp.clip(b[model.history_col], 0,
                                                  n - 1), axis=0)
                user = model.apply(p, clicks, b[model.mask_col], True,
                                   method=model.encode_user,
                                   rngs={"dropout": key})
                return neg_sampling_loss(model.apply(
                    p, user, item, True, method=model.score,
                    rngs={"dropout": key}))
            step = make_catalog_parallel_step(model, opt, mesh,
                                              rng_impl="threefry2x32")
            with mesh:
                b = shard_batch(jbatch, mesh)
                loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params,
                                                                   b)
                p1, _, _ = step(jax.tree.map(jnp.copy, params),
                                opt.init(params), contents, b, 0)
        else:
            loss_fn = make_loss_fn(model, jm.contents.columns, True)
            step, place = make_sharded_train_step(
                model, jm.contents.columns, opt, mesh,
                min_rows_to_shard=jm.mesh_min_rows)
            with mesh:
                p, o, b = place(params, opt.init(params), jbatch)
                loss, grads = jax.jit(jax.value_and_grad(loss_fn))(p, b, key)
                p1, _, _ = step(p, o, b, key)
        jt.params = p1
        ev = jt.evaluator
        with mesh, no_pipeline():
            if ev.cache is not None:
                ev.cache.cache(p1)
                scores = ev.score_phase_device(p1, "test")
            else:
                scores = ev.score_phase_device_full(p1, "test")
        dev = jt.dev()
    finally:
        _ambient(None)
    target = manager(name).model

    def bridge(tree):
        return params_from_jax(jax.tree_util.tree_map(
            np.asarray, jax.device_get(tree)), target)
    return {"loss": float(loss), "grads": bridge(grads), "state": bridge(p1),
            "dev": float(dev),
            "scores": torch.as_tensor(np.array(scores)[:32])}


def first_batch() -> dict:
    from legommenders_tpu_torch.data.pipeline import TrainBatcher
    b = next(TrainBatcher(data(), 16, neg_count=2, seed=0).epoch(
        shuffle=False))
    return {k: np.asarray(v) for k, v in b.items()}


# --------------------------------------------------------------------- #
# the checks                                                            #
# --------------------------------------------------------------------- #
def cells(outs: list, key: str) -> list:
    """Each (dp, sp, pp) cell's `key` tensors, the mp slices of a sharded
    parameter concatenated along its dim, in mp order."""
    by_cell = {}
    for o in outs:
        dp, mp, sp, pp = o["coords"]
        by_cell.setdefault((dp, sp, pp), {})[mp] = o
    wholes = []
    for parts in by_cell.values():
        ranks = [parts[i] for i in sorted(parts)]
        plan = ranks[0]["plan"]
        whole = {}
        for k, v in ranks[0][key].items():
            dim = plan.get(k)
            whole[k] = (v if dim is None or len(ranks) == 1 else
                        torch.cat([r[key][k] for r in ranks], dim=dim))
        wholes.append(whole)
    return wholes


# an attention key bias adds one constant to every key's score of a query:
# the softmax cancels it, so its exact gradient and update are 0 and what
# each side holds is rounding residue
ZERO_GRAD = ("attention.key.bias", "attn.k.bias")


def grads_close(got: dict, want: dict, what: str):
    assert set(got) <= set(want), sorted(set(got) - set(want))
    assert len(got) >= 4
    for k, g in got.items():
        if k.endswith(ZERO_GRAD):
            continue
        w = want[k].double().numpy()
        gate = GRAD_REL * float(np.abs(w).max())
        np.testing.assert_allclose(g.double().numpy(), w, rtol=0,
                                   atol=gate, err_msg=f"{what}: {k}")


def states_close(got: dict, want: dict, grads: dict, what: str):
    """The weights after the step, but for the elements whose reference
    gradient lies within its gate of zero: there the gradient check lets
    the sign go either way, and Adam's first update, lr g / (|g| + eps),
    follows the residue (PR 14's rule for the card's update check)."""
    assert set(got) == set(want)
    for k, v in want.items():
        if k.endswith(ZERO_GRAD):
            continue
        keep = np.ones(v.shape, bool)
        if k in grads:
            g = np.abs(grads[k].double().numpy())
            keep = g > GRAD_REL * g.max()
        np.testing.assert_allclose(got[k].double().numpy()[keep],
                                   v.double().numpy()[keep],
                                   err_msg=f"{what}: {k}", **STATE_TOL)


def check_case(outs: list, one: dict, jx: dict, init: dict):
    """Every rank's loss, dev value, scores and test metrics, and every
    cell's gradients and weights, against one process's and JAX's."""
    grad_cells = cells(outs, "grads")
    state_cells = cells(outs, "state")
    moved = sum(not torch.equal(one["state"][k], v) for k, v in init.items())
    assert moved >= 4
    for ref, what in ((one, "one process"), (jx, "JAX")):
        for o in outs:
            assert abs(o["loss"] - ref["loss"]) <= LOSS_REL * abs(
                ref["loss"]), (what, o["loss"], ref["loss"])
            assert abs(o["dev"] - ref["dev"]) <= SCORE_TOL, (
                what, o["dev"], ref["dev"])
            np.testing.assert_allclose(o["scores"].double().numpy(),
                                       ref["scores"].double().numpy(),
                                       rtol=SCORE_TOL, atol=SCORE_TOL,
                                       err_msg=what)
            for k, v in ref.get("test", {}).items():
                assert abs(o["test"][k] - v) <= SCORE_TOL, (
                    what, k, o["test"], ref["test"])
        for g, s in zip(grad_cells, state_cells):
            grads_close(g, ref["grads"], what)
            states_close(s, ref["state"], ref["grads"], what)


def run_groups(script: str, groups: dict, tmp: str) -> dict:
    """JAX's initial weights of every case, then every group's ranks at
    once; meanwhile one process's runs and JAX's in this process."""
    import jax  # noqa: F401  (the virtual devices, before the ranks)

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    names = [c for cases in groups.values() for c in cases]
    batch = first_batch()
    trainers, weights = {}, {}
    for name in names:
        trainers[name], weights[name] = jax_weights(name)
    inputs = {"weights": weights, "batch": batch}
    torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    started = [spawn(script, g, cases, tmp) for g, cases in groups.items()]
    try:
        out = {"init": weights, "one": {}, "jax": {}}
        for name in names:
            out["one"][name] = port_run(name, inputs, on_mesh=False)
        for name in names:
            out["jax"][name] = jax_run(name, trainers[name], batch)
        for procs in started:
            wait(procs)
        out["ranks"] = {name: load(tmp, name) for name in names}
    finally:
        torch.set_num_threads(n)
        for procs in started:
            for p in procs:
                if p.poll() is None:
                    p.kill()
    return out
