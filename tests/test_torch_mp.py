"""The model-parallel axis of exp.policy.mesh in the port: shard_plan against
JAX's params_shardings, the row-sharded lookups, (dp 2, mp 2) steps of
NAML (row-sharded tables), DCNv2 (expert-sharded CrossNetMix) and a
2-layer BERT (Megatron TP) against one process and against JAX's sharded
step, Llama with grouped-query attention, GLM and OPT slices at mp 2, the
attention dropout at a head offset, and sharded checkpoints.

Small sizes: the synthetic catalog of JAX's tests/test_mesh_policy.py (80
items, 40 users, title 8, history 6), hidden 16, 2 negatives, dropout 0
unless stated. The multi-rank runs are processes of this file (`python
tests/test_torch_mp.py <group> ...`) over gloo through `file://` in
tmp_path, 120 s a rank: group "dpmp" is 4 ranks at (dp 2, mp 2),
group "mp2" 2 ranks at (dp 1, mp 2); both run at once. Each rank writes
its results; the test assembles the mp shards of dp row 0. Tolerances:
  * parameters after a step or a Trainer run against one process and
    against JAX's mesh step / Trainer at (dp 2, mp 2): rtol 2e-4, atol
    2e-5 (JAX's test_lm_tensor_parallel_matches_single_device), the BERT
    key bias left out as JAX's test leaves it (its exact gradient is 0 and
    Adam amplifies its residue differently under each partitioning);
    DCNv2's gradients rtol 3e-4, atol 1e-5 (JAX's
    test_expert_parallel_crossnetmix); test metrics within 5e-3;
  * the lookups against the plain take, and JAX's sharded_lookup: exact;
  * the slices at mp 2 against one process at f32: outputs and gradients
    rtol 1e-4, atol 1e-5; BERT at dropout 0.1 with the packed attention
    (its keep mask at each rank's head offset) likewise;
  * replicated parameters' gradients equal on both mp ranks (bit for bit);
  * checkpoints: written at mp 2, read at mp 2, at mp 1 (dp 4) and in one
    process, equal to the written weights bit for bit.
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
DCN_CFG = {
    "meta": {"item": "CNN", "user": "Ada", "predictor": "DCNv2"},
    "config": {"use_item_content": True, "hidden_size": 16,
               "use_neg_sampling": True, "neg_count": 2,
               "use_fast_eval": False,
               "item_config": {"dropout": 0.0},
               "user_config": {"dropout": 0.0},
               "predictor_config": {"use_low_rank_mixture": True,
                                    "low_rank": 8, "num_experts": 4,
                                    "parallel_dnn_hidden_units": [32]}},
}


def bert_cfg(lora: bool) -> dict:
    """A 2-layer BERT item encoder over the whole LM (tune_from unset),
    f32: with LoRA and fused q/k/v (the partial gradients) or without
    (every base weight trained, the sharded biases)."""
    item = {"tune_from": None, "num_hidden_layers": 2,
            "num_attention_heads": 2, "lm_dtype": "f32", "dropout": 0.0,
            "attn_dropout": 0.0, "additive_hidden_size": 16,
            "use_lora": lora}
    if lora:
        item.update(lora_r=4, lora_dropout=0.0, fused_qkv=True)
    return {"meta": {"item": "Bert", "user": "Ada", "predictor": "Dot"},
            "config": {"use_item_content": True, "hidden_size": 16,
                       "embedding_dim": 32, "use_neg_sampling": True,
                       "neg_count": 2, "use_fast_eval": False,
                       "item_config": item,
                       "user_config": {"dropout": 0.0}}}


POLICY = {"batch_size": 16, "epoch": 2, "epoch_batch": 4, "lr": 1e-3,
          "check_interval": 2}
STEP_CASES = {"dcn": DCN_CFG, "bert_lora": bert_cfg(True),
              "bert": bert_cfg(False)}
DPMP = {"dp": 2, "mp": 2, "min_rows_to_shard": 0}
METRICS = ["GAUC", "MRR", "NDCG@1", "NDCG@5", "NDCG@10"]
RANK_TIMEOUT_S = 120
SLICE_TOL = dict(rtol=1e-4, atol=1e-5)


def _data():
    from legommenders_tpu_torch.data.processors.synthetic import (
        SyntheticProcessor,
    )
    return SyntheticProcessor(**DATA_KW).as_lego_data()


def _manager(cfg, data, policy=None, mesh=None):
    from legommenders_tpu_torch.runtime.manager import Manager

    policy = dict(policy or POLICY)
    if mesh is not None:
        policy["mesh"] = mesh
    return Manager(model_cfg=copy.deepcopy(cfg),
                   exp_cfg={"policy": policy, "metrics": METRICS},
                   data=data, device="cpu")


def _batch(data):
    """The first host batch of 16 (seed 0), as tensors."""
    from legommenders_tpu_torch.data.pipeline import TrainBatcher

    b = next(TrainBatcher(data, 16, neg_count=2, seed=0).epoch())
    return {k: np.asarray(v) for k, v in b.items()}


class _Recorder:
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


def one_step(model, contents, batch, mesh=None):
    """One Adam step (lr 1e-3) on `batch` (whole, or this rank's dp rows
    under `mesh`); returns (loss, {name: grad}, state_dict)."""
    from legommenders_tpu_torch.parallel.train import (
        make_mesh_train_step_folded,
    )
    from legommenders_tpu_torch.runtime import steps

    opt = _Recorder(steps.adam(model, 1e-3))
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    if mesh is None:
        loss = steps.make_train_step(model, contents, opt)(
            tb, steps.step_generator(0, 1, "cpu"))
    else:
        loss = make_mesh_train_step_folded(model, contents, opt, mesh)(
            tmesh.shard_rows(tb, mesh), 1)
    names = {id(p): n for n, p in model.named_parameters()}
    return (float(loss), {names[i]: g for i, g in opt.grads.items()},
            {k: v.detach().clone() for k, v in model.state_dict().items()})


# --------------------------------------------------------------------- #
# rank groups                                                           #
# --------------------------------------------------------------------- #
def _save(tmp, case, rank, obj):
    torch.save(obj, os.path.join(tmp, f"{case}.{rank}.pt"))


def _plan_of(model):
    plan = tmesh.model_plan(model)
    return dict(plan.sharded) if plan else {}


def group_dpmp(tmp, rank):
    """(dp 2, mp 2): the NAML Trainer with its checkpoint, the steps, the
    lookups."""
    from legommenders_tpu_torch.parallel import embed_sharded
    from legommenders_tpu_torch.runtime.checkpoint import (
        load_auto, save_auto,
    )
    from legommenders_tpu_torch.runtime.trainer import Trainer

    data = _data()
    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    # NAML through the Trainer, the best epoch written as a sharded dir
    m = _manager(NAML_CFG, data, mesh=DPMP)
    m.model.load_state_dict(inputs["naml"])
    ckpt = os.path.join(tmp, "naml.ckpt")
    tr = Trainer(m, seed=7, ckpt_path=ckpt, lm_cache_root=None)
    ev = tr.evaluator
    tr.init()
    pre = {"cached": ev.evaluate("test"),
           "full": ev.evaluate("test", use_cache=False)}
    tr.train()
    state = {k: v.clone() for k, v in m.model.state_dict().items()}
    moments = {n: tuple(tr.optimizer.optimizer.state[p]["exp_avg"].shape)
               for n, p in m.model.named_parameters()
               if p in tr.optimizer.optimizer.state}
    out = {"state": state, "plan": _plan_of(m.model), "pre": pre,
           "test": tr.test(), "steps": tr.global_step, "moments": moments}
    # the last step's weights and Adam state, read back at mp 2 (a fresh
    # placed model and optimizer) ...
    last = os.path.join(tmp, "naml_last.ckpt")
    save_auto(last, m.model, tr.optimizer, meta={"epoch": -1}, mesh=m.mesh)
    m2 = _manager(NAML_CFG, data, mesh=DPMP)
    t2 = Trainer(m2, seed=7, lm_cache_root=None)
    t2.init()
    load_auto(last, m2.model, t2.optimizer)
    out["reload_mp2"] = {k: v.clone() for k, v in m2.model.state_dict().items()}
    out["reload_mp2_moments"] = {
        n: t2.optimizer.optimizer.state[p]["exp_avg"].clone()
        for n, p in m2.model.named_parameters()
        if p in t2.optimizer.optimizer.state}
    out["moments_mp2"] = {
        n: tr.optimizer.optimizer.state[p]["exp_avg"].clone()
        for n, p in m.model.named_parameters()
        if p in tr.optimizer.optimizer.state}
    # ... and at mp 1 (dp 4: the whole weights on every rank)
    m1 = _manager(NAML_CFG, data, mesh={"dp": 4})
    load_auto(last, m1.model, model_only=True)
    out["reload_mp1"] = m1.model.state_dict()
    _save(tmp, "naml", rank, out)

    # one step of each model
    for case, cfg in STEP_CASES.items():
        mm = _manager(cfg, data, mesh=DPMP)
        mm.model.load_state_dict(inputs[case])
        mesh = mm.mesh
        tmesh.place_model(mm.model, mesh)
        loss, grads, state = one_step(mm.model, mm.contents.columns,
                                      inputs["batch"], mesh)
        _save(tmp, case, rank, {"loss": loss, "grads": grads,
                                "state": state, "plan": _plan_of(mm.model),
                                "partial": tmesh.model_plan(mm.model)
                                .partial})

    # the lookups: this rank's table rows, its dp rows of the ids
    mesh = m.mesh
    table = inputs["table"]
    ids = inputs["ids"][tmesh.row_slice(len(inputs["ids"]), mesh)]
    local = tmesh.shard_slice(table, 0, mesh.mp_axis).requires_grad_(True)
    got = embed_sharded.sharded_lookup(local, ids, mesh.mp_axis)
    (got ** 2).sum().backward()
    gathered = embed_sharded.sharded_lookup_gather(
        tmesh.shard_slice(table, 0, mesh.mp_axis), ids, mesh.mp_axis)
    scores = embed_sharded.sharded_catalog_scores(
        inputs["user"], tmesh.shard_slice(table, 0, mesh.mp_axis))
    _save(tmp, "lookup", rank, {"psum": got.detach(), "gather": gathered,
                                "grad": local.grad, "scores": scores})


def _slices(kind: str, seed: int = 0):
    """A holder whose `lm` is a 2-layer f32 slice of `kind`, drawn from
    `seed`, and its (x, mask)."""
    from legommenders_tpu_torch.models.lm import layers

    g = torch.Generator().manual_seed(seed)
    if kind == "llama":
        lm = layers.LlamaDecoderSlice(
            2, 32, num_heads=4, num_kv_heads=2, intermediate_size=48,
            lora_r=2, attention_pack=-1, fused_attention=True,
            dtype=torch.float32)
    elif kind == "glm":
        lm = layers.LlamaDecoderSlice(
            2, 32, num_heads=4, num_kv_heads=2, intermediate_size=48,
            qkv_bias=True, rotary_fraction=0.5, rotary_interleaved=True,
            lora_r=2, lora_fold=True, fused_qkv=True, dtype=torch.float32)
    elif kind == "opt":
        lm = layers.OPTDecoderSlice(
            2, 32, num_heads=4, ffn_dim=64, lora_r=2, fused_qkv=True,
            attention_pack=-1, fused_attention=True, dtype=torch.float32)
    else:  # bert at dropout 0.1: the packed attention's masks by head
        lm = layers.BertEncoderSlice(
            2, 32, num_heads=4, lora_r=2, lora_dropout=0.1, dropout=0.1,
            attention_pack=-1, fused_attention=True, dropout_reuse=True,
            dtype=torch.float32)
    holder = torch.nn.Module()
    holder.lm = lm
    lm.reset_parameters(g)
    for name, p in holder.named_parameters():
        if "lora_B" in name:
            with torch.no_grad():  # LoRA B starts at 0: give it values
                p.normal_(0.0, 0.1, generator=g)
    x = torch.randn(6, 10, 32, generator=g)
    mask = torch.ones(6, 10, dtype=torch.int32)
    mask[1, 7:] = 0
    mask[4, 3:] = 0
    return holder, x, mask


def slice_run(kind: str, mesh=None) -> dict:
    """The slice's output and every parameter's gradient (whole, or this
    rank's after place_model), dropout drawn from one seeded generator."""
    holder, x, mask = _slices(kind)
    if mesh is not None:
        tmesh.place_model(holder, mesh)
    x.requires_grad_(True)
    y = holder.lm(x, mask, torch.Generator().manual_seed(11))
    loss = (y * torch.linspace(-1, 1, y.shape[-1])).square().sum()
    loss.backward()
    if mesh is not None:
        tmesh.reduce_gradients(list(holder.parameters()), loss.detach(),
                               mesh, tmesh.partial_params(holder))
    return {"y": y.detach(), "dx": x.grad,
            "grads": {n: p.grad for n, p in holder.named_parameters()
                      if p.grad is not None},
            "plan": _plan_of(holder),
            "partial": (tmesh.model_plan(holder).partial
                        if tmesh.model_plan(holder) else ())}


def group_mp2(tmp, rank):
    """(dp 1, mp 2): the decoder and BERT slices."""
    mesh = tmesh.mesh_from_policy({"mp": 2})
    for kind in ("llama", "glm", "opt", "bert_drop"):
        _save(tmp, kind, rank, slice_run(kind, mesh))


GROUPS = {"dpmp": (group_dpmp, 4), "mp2": (group_mp2, 2)}


def rank_main(argv):
    """One rank: <group> <init file> <rank> <tmp dir>."""
    group, init, rank, tmp = argv
    fn, world = GROUPS[group]
    torch.set_num_threads(1)
    tmesh.initialize_multihost(f"file://{init}", world, int(rank),
                               device="cpu")
    try:
        fn(tmp, int(rank))
    finally:
        tmesh.shutdown()


def spawn(group, tmp):
    init = os.path.join(tmp, f"{group}.init")
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), group, init, str(r),
         tmp], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(GROUPS[group][1])]


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


def _load(tmp, case, world):
    return [torch.load(os.path.join(tmp, f"{case}.{r}.pt"),
                       weights_only=False) for r in range(world)]


def whole(outs, key, n_mp=2):
    """The whole tensors of dp row 0's shards of `outs[r][key]`."""
    plan = outs[0]["plan"]
    return {k: (torch.cat([outs[r][key][k] for r in range(n_mp)],
                          dim=plan[k]) if k in plan else v)
            for k, v in outs[0][key].items()}


# --------------------------------------------------------------------- #
# the runs                                                              #
# --------------------------------------------------------------------- #
def _jax_params(tree_model_pairs):
    import jax

    from legommenders_tpu_torch.bridge import params_from_jax
    return {k: params_from_jax(jax.tree_util.tree_map(np.asarray, t), m)
            for k, (t, m) in tree_model_pairs.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both groups (their six ranks at once), and in this process one
    process's runs and JAX's at (dp 2, mp 2), from the same weights."""
    import jax
    import jax.numpy as jnp
    import optax

    from legommenders_tpu.data.processors.synthetic import (
        SyntheticProcessor as JSynthetic,
    )
    from legommenders_tpu.parallel.mesh import make_mesh
    from legommenders_tpu.parallel.train import make_sharded_train_step
    from legommenders_tpu.runtime.manager import Manager as JManager
    from legommenders_tpu.runtime.steps import init_params, make_loss_fn
    from legommenders_tpu.runtime.trainer import Trainer as JTrainer
    from legommenders_tpu_torch.runtime.trainer import Trainer

    tmp = str(tmp_path_factory.mktemp("mp"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    data = _data()
    jdata = JSynthetic(**DATA_KW).as_lego_data()
    batch = _batch(data)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = JManager({}, NAML_CFG, data=jdata, exp_cfg={
        "policy": {**POLICY, "mesh": DPMP}, "metrics": METRICS})
    jt = JTrainer(jm, seed=7)
    jt.init()
    pairs = {"naml": (jt.params, _manager(NAML_CFG, data).model)}
    jsteps = {}
    for case, cfg in STEP_CASES.items():
        jmc = JManager({}, copy.deepcopy(cfg), data=jdata,
                       exp_cfg={"policy": {"batch_size": 16}})
        params = init_params(jmc.model, jbatch, jmc.contents.columns, seed=0)
        jsteps[case] = (jmc, params)
        pairs[case] = (params, _manager(cfg, data).model)
    inputs = _jax_params(pairs)
    g = torch.Generator().manual_seed(3)
    inputs.update(batch=batch, table=torch.randn(40, 16, generator=g),
                  ids=torch.randint(0, 40, (8, 6), generator=g),
                  user=torch.randn(4, 16, generator=g))
    torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    started = {g: spawn(g, tmp) for g in GROUPS}
    try:
        out = {"inputs": inputs}
        # one process
        m = _manager(NAML_CFG, data)
        m.model.load_state_dict(inputs["naml"])
        tr = Trainer(m, seed=7, lm_cache_root=None)
        out["naml_pre"] = {"cached": tr.evaluator.evaluate("test"),
                           "full": tr.evaluator.evaluate("test",
                                                         use_cache=False)}
        tr.train()
        out["naml_one"] = {"state": m.model.state_dict(),
                           "test": tr.test(), "steps": tr.global_step}
        for case, cfg in STEP_CASES.items():
            mm = _manager(cfg, data)
            mm.model.load_state_dict(inputs[case])
            out[f"{case}_one"] = one_step(mm.model, mm.contents.columns,
                                          batch)
        for kind in ("llama", "glm", "opt", "bert_drop"):
            out[f"{kind}_one"] = slice_run(kind)
        # JAX at (dp 2, mp 2)
        jt.train()
        out["naml_jax"] = {"test": jt.test(), "state": _jax_params(
            {"s": (jt.params, _manager(NAML_CFG, data).model)})["s"]}
        mesh = make_mesh(n_dp=2, n_mp=2, devices=jax.devices()[:4])
        opt = optax.adam(1e-3)
        for case, (jmc, params) in jsteps.items():
            step, place = make_sharded_train_step(
                jmc.model, jmc.contents.columns, opt, mesh,
                min_rows_to_shard=2)
            loss_fn = make_loss_fn(jmc.model, jmc.contents.columns, True)
            with mesh:
                p, o, b = place(params, opt.init(params), jbatch)
                _, g8 = jax.jit(jax.value_and_grad(loss_fn))(
                    p, b, jax.random.PRNGKey(0))
                p8, _, loss8 = step(p, o, b, jax.random.PRNGKey(0))
            target = _manager(STEP_CASES[case], data).model
            out[f"{case}_jax"] = {"loss": float(loss8), **_jax_params(
                {"state": (jax.device_get(p8), target),
                 "grads": (jax.device_get(g8), target)})}
        for s, procs in started.items():
            wait(procs)
        for case in ["naml", "lookup", *STEP_CASES]:
            out[case] = _load(tmp, case, 4)
        for kind in ("llama", "glm", "opt", "bert_drop"):
            out[kind] = _load(tmp, kind, 2)
        out["tmp"] = tmp
    finally:
        torch.set_num_threads(n)
        for procs in started.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
    return out


def _close(got, want, skip=(), **tol):
    tol = tol or dict(rtol=2e-4, atol=2e-5)
    assert set(got) == set(want)
    for k in want:
        if any(s in k for s in skip):
            continue
        np.testing.assert_allclose(got[k].float().numpy(),
                                   want[k].float().numpy(), err_msg=k, **tol)


# --------------------------------------------------------------------- #
# the plan                                                              #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("case", ["naml", "dcn", "bert", "bert_split",
                                  "llama"])
def test_shard_plan_matches_jax_params_shardings(case):
    """The port's sharded set is JAX's params_shardings on the bridged
    tree at (dp 2, mp 2): the same names, each split on the dim JAX's
    kernel layout maps to."""
    import jax
    import jax.numpy as jnp

    from legommenders_tpu.data.processors.synthetic import (
        SyntheticProcessor as JSynthetic,
    )
    from legommenders_tpu.parallel.mesh import make_mesh, params_shardings
    from legommenders_tpu.runtime.manager import Manager as JManager
    from legommenders_tpu.runtime.steps import init_params
    from legommenders_tpu_torch.bridge import _place

    cfg = {"naml": NAML_CFG, "dcn": DCN_CFG, "bert": bert_cfg(True)}.get(case)
    if case == "bert_split":
        cfg = bert_cfg(True)
        cfg["config"]["item_config"]["tune_from"] = 1
    if case == "llama":
        cfg = {"meta": {"item": "Llama1", "user": "Ada", "predictor": "Dot"},
               "config": {"use_item_content": True, "hidden_size": 16,
                          "embedding_dim": 32, "neg_count": 2,
                          "item_config": {
                              "num_hidden_layers": 2, "tune_from": 1,
                              "num_attention_heads": 4, "lm_dtype": "f32",
                              "intermediate_size": 48, "lora_r": 2}}}
    data = _data()
    jm = JManager({}, copy.deepcopy(cfg),
                  data=JSynthetic(**DATA_KW).as_lego_data(),
                  exp_cfg={"policy": {"batch_size": 16}})
    jbatch = {k: jnp.asarray(v) for k, v in _batch(data).items()}
    params = init_params(jm.model, jbatch, jm.contents.columns, seed=0)
    mesh = make_mesh(n_dp=2, n_mp=2, devices=jax.devices()[:4])
    want = {}
    leaves = jax.tree_util.tree_leaves_with_path(params)
    specs = jax.tree_util.tree_leaves(
        params_shardings(params, mesh, min_rows_to_shard=2))
    for (path, leaf), s in zip(leaves, specs):
        spec = tuple(s.spec)
        if "mp" not in spec:
            continue
        keys = [str(p.key) for p in path]
        if keys[0] == "params":
            keys = keys[1:]
        jdim = spec.index("mp")
        port_key, _ = _place(keys, np.zeros(leaf.shape))
        want[port_key] = (1 - jdim if keys[-1] == "kernel" and leaf.ndim == 2
                          else jdim)
    m = _manager(cfg, data)
    plan = tmesh.shard_plan(m.model, tmesh.Mesh(2, 0, 2), 2)
    assert want, "JAX shards nothing here"
    assert plan.sharded == want


def test_plan_keeps_layers_whose_heads_do_not_divide():
    """Heads that do not divide by n_mp keep the attention whole; the FFN
    still shards where its width divides."""
    from legommenders_tpu_torch.models.lm import layers

    holder = torch.nn.Module()
    holder.lm = layers.BertEncoderSlice(1, 24, num_heads=3,
                                        dtype=torch.float32)
    plan = tmesh.shard_plan(holder, tmesh.Mesh(1, 0, 2))
    assert plan.tp == (("lm.layer_0", False, True),)
    assert set(plan.sharded) == {"lm.layer_0.intermediate.weight",
                                 "lm.layer_0.intermediate.bias",
                                 "lm.layer_0.ffn_output.weight"}
    assert tmesh.shard_plan(holder, tmesh.Mesh(1, 0, 1)).sharded == {}


def test_plain_keep_mask_at_head_offset_is_the_slice():
    """The plain keep mask of heads o.. o+h-1 is exactly that slice of the
    whole mask, for every offset of a 12-head and a 32-head tensor."""
    from legommenders_tpu_torch.ops.attention import dropout_keep_mask

    seed = torch.tensor([1234567], dtype=torch.int32)
    for heads, n in ((12, 2), (32, 2), (12, 4)):
        full = dropout_keep_mask(heads, 0.1, 3, 40, seed)
        k = heads // n
        for r in range(n):
            got = dropout_keep_mask(k, 0.1, 3, 40, seed, head_offset=r * k)
            assert torch.equal(got, full[:, r * k:(r + 1) * k])
        assert not torch.equal(dropout_keep_mask(k, 0.1, 3, 40, seed),
                               full[:, k:2 * k])


def test_packed_attention_at_head_offset_matches_the_whole():
    """The plain packed attention (and its backward) of each half of the
    heads at its offset equals that half of the whole call at dropout
    0.1."""
    from legommenders_tpu_torch.ops.attention import packed_attention

    g = torch.Generator().manual_seed(0)
    B, T, H, d = 2, 24, 4, 8
    q, k, v = (torch.randn(B, T, H * d, generator=g, requires_grad=True)
               for _ in range(3))
    bias = torch.zeros(B, T, T)
    seed = torch.tensor([77], dtype=torch.int32)
    whole_out = packed_attention(H, 0.1, q, k, v, bias, seed)
    whole_out.square().sum().backward()
    want = [t.grad.clone() for t in (q, k, v)]
    half = H // 2 * d
    for r in range(2):
        cols = slice(r * half, (r + 1) * half)
        parts = [t.detach()[..., cols].contiguous().requires_grad_(True)
                 for t in (q, k, v)]
        out = packed_attention(H // 2, 0.1, *parts, bias, seed,
                               head_offset=r * H // 2)
        torch.testing.assert_close(out, whole_out.detach()[..., cols])
        out.square().sum().backward()
        for p, w in zip(parts, want):
            torch.testing.assert_close(p.grad, w[..., cols])


# --------------------------------------------------------------------- #
# the (dp 2, mp 2) runs                                                 #
# --------------------------------------------------------------------- #
def test_naml_dpmp_trainer_matches_one_process_and_jax(runs):
    outs = runs["naml"]
    assert outs[0]["steps"] == runs["naml_one"]["steps"] == 8
    assert any(k.startswith("eh.tables.") for k in outs[0]["plan"])
    got = whole(outs, "state")
    _close(got, runs["naml_one"]["state"])
    _close(got, runs["naml_jax"]["state"])
    for ref in (runs["naml_one"]["test"], runs["naml_jax"]["test"]):
        for k, v in ref.items():
            assert abs(outs[0]["test"][k] - v) < 5e-3, (k, outs[0]["test"],
                                                        ref)
    init = runs["inputs"]["naml"]
    assert sum(not torch.equal(v, init[k]) for k, v in got.items()
               if v.is_floating_point()) >= 8


@pytest.mark.parametrize("path", ["cached", "full"])
def test_evaluation_under_dpmp_matches_one_process(runs, path):
    want = runs["naml_pre"][path]
    for out in runs["naml"]:
        for k, v in want.items():
            assert abs(out["pre"][path][k] - v) <= 1e-6, (k, out["pre"],
                                                          want)


def test_sharded_table_and_its_moments_hold_rows_over_mp(runs):
    """A sharded table's parameter and Adam moments hold rows / n_mp on
    every rank (JAX test_trainer_mesh_mp_shards_tables_and_opt_state)."""
    init = runs["inputs"]["naml"]
    for out in runs["naml"]:
        tables = [k for k in out["plan"] if k.startswith("eh.tables.")]
        assert tables
        for k in tables:
            rows = init[k].shape[0] // 2
            assert out["state"][k].shape[0] == rows
            if k in out["moments"]:
                assert out["moments"][k][0] == rows


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_dpmp_step_matches_one_process_and_jax(runs, case):
    """One (dp 2, mp 2) step against one process's and JAX's. DCNv2 is
    held by its gradients, as JAX's test_expert_parallel_crossnetmix holds
    it: a ReLU unit that no row of the batch opens has an exactly-zero
    bias gradient, whose residue Adam turns into +-lr by its sign; BERT by
    its updated weights, the key bias left out as JAX leaves it."""
    outs, one, jx = runs[case], runs[f"{case}_one"], runs[f"{case}_jax"]
    assert outs[0]["plan"], "nothing was sharded"
    assert abs(outs[0]["loss"] - one[0]) <= 1e-4 * abs(one[0])
    assert abs(outs[0]["loss"] - jx["loss"]) <= 1e-4 * abs(jx["loss"])
    if case == "dcn":
        grads = whole(outs, "grads")
        _close(grads, one[1], rtol=3e-4, atol=1e-5)
        _close(grads, {k: jx["grads"][k] for k in grads}, rtol=3e-4,
               atol=1e-5)
        return
    got = whole(outs, "state")
    skip = ("attention.key.bias",)
    _close(got, one[2], skip)
    _close(got, jx["state"], skip)


@pytest.mark.parametrize("case", ["dcn", "bert_lora"])
def test_replicated_gradients_equal_across_mp_ranks(runs, case):
    """Every replicated parameter, those inside sharded products included
    (CrossNetMix's gates and bias; the LoRA factors of q and v), ends the
    reduction with the same gradient on every rank, so its copies cannot
    drift; a sharded one with the same gradient on its dp partner."""
    outs = runs[case]
    plan, partial = outs[0]["plan"], outs[0]["partial"]
    assert partial and all(k in outs[0]["grads"] for k in partial)
    for r in (1, 2, 3):
        for k, g in outs[0]["grads"].items():
            if k not in plan:
                assert torch.equal(g, outs[r]["grads"][k]), (k, r)
    for k in plan:
        if k in outs[0]["grads"]:
            assert torch.equal(outs[0]["grads"][k], outs[2]["grads"][k]), k
            assert not torch.equal(outs[0]["grads"][k],
                                   outs[1]["grads"][k]), k


def test_sharded_lookups_match_the_take_and_jax(runs):
    """sharded_lookup (forward and gradient), sharded_lookup_gather and
    sharded_catalog_scores at (dp 2, mp 2) against the plain take and
    JAX's sharded_lookup on make_mesh(2, 2), exactly."""
    import jax
    import jax.numpy as jnp

    from legommenders_tpu.parallel.embed_sharded import (
        sharded_lookup as jlookup,
    )
    from legommenders_tpu.parallel.mesh import make_mesh

    inp, outs = runs["inputs"], runs["lookup"]
    table, ids = inp["table"], inp["ids"]
    want = table[ids]
    got = torch.cat([outs[0]["psum"], outs[2]["psum"]])
    assert torch.equal(got, want)
    assert torch.equal(torch.cat([outs[0]["gather"], outs[2]["gather"]]),
                       want)
    mesh = make_mesh(n_dp=2, n_mp=2, devices=jax.devices()[:4])
    with mesh:
        jgot = np.asarray(jlookup(jnp.asarray(table.numpy()),
                                  jnp.asarray(ids.numpy()), mesh))
    np.testing.assert_array_equal(got.numpy(), jgot)
    t = table.clone().requires_grad_(True)
    (t[ids] ** 2).sum().backward()
    # each dp row's owners hold its rows' gradient; dp averages them
    shard_grads = [outs[r]["grad"] for r in range(4)]
    grad = (torch.cat(shard_grads[:2]) + torch.cat(shard_grads[2:]))
    torch.testing.assert_close(grad, t.grad)
    scores = torch.cat([outs[0]["scores"], outs[1]["scores"]], dim=1)
    torch.testing.assert_close(scores, inp["user"] @ table.t())


@pytest.mark.parametrize("kind", ["llama", "glm", "opt", "bert_drop"])
def test_slice_at_mp2_matches_one_process(runs, kind):
    """Llama with 2 kv heads of 4, GLM (qkv biases, partial interleaved
    rotary, folded LoRA, fused q/k/v), OPT (fused q/k/v) and BERT at
    dropout 0.1 with the packed attention: outputs, input gradients and
    gradients at mp 2 against one process."""
    outs, one = runs[kind], runs[f"{kind}_one"]
    assert outs[0]["plan"]
    for out in outs:
        torch.testing.assert_close(out["y"], one["y"], **SLICE_TOL)
        torch.testing.assert_close(out["dx"], one["dx"], **SLICE_TOL)
    grads = whole(outs, "grads")
    _close(grads, one["grads"], **SLICE_TOL)
    for k in outs[0]["partial"]:
        if k in outs[0]["grads"]:
            assert torch.equal(outs[0]["grads"][k], outs[1]["grads"][k]), k


def test_sharded_checkpoint_reads_at_mp2_mp1_and_one_process(runs):
    """The best epoch's sharded directory, written at (dp 2, mp 2): read
    back at mp 2 (weights and Adam moments), at dp 4 and in one process,
    the gathered weights bit for bit."""
    from legommenders_tpu_torch.runtime.checkpoint import (
        load_auto, params_are_sharded,
    )

    outs = runs["naml"]
    ckpt = os.path.join(runs["tmp"], "naml.ckpt")
    assert os.path.isdir(ckpt + ".orbax")
    assert not os.path.exists(ckpt)
    for out in outs:
        for k, v in out["state"].items():
            assert torch.equal(out["reload_mp2"][k], v), k
        for k, v in out["moments_mp2"].items():
            assert torch.equal(out["reload_mp2_moments"][k], v), k
    got = whole(outs, "state")
    for out in outs:
        for k, v in got.items():
            assert torch.equal(out["reload_mp1"][k], v), k
    m = _manager(NAML_CFG, _data())
    assert not params_are_sharded(m.model)
    meta = load_auto(ckpt, m.model, model_only=True)
    assert meta["epoch"] in (0, 1)
    for k, v in m.model.state_dict().items():
        assert torch.equal(v, got[k]), k


if __name__ == "__main__":
    rank_main(sys.argv[1:])
