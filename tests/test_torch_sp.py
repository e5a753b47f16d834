"""The sequence-parallel axis of exp.policy.mesh in the port: the two-psum
pool, Ulysses and ring attention at sp 2 and 4 against the port's
unsharded versions and JAX's shard_map ops, the flatten Transformer
(both sp_impl) and Fastformer operators against their local path and
JAX's sequence-parallel operators, the sp dropout draws, JAX's refusals,
and a (dp 2, sp 2) Trainer run against one process and JAX.

Shapes are JAX's tests/test_parallel.py ones (the pool B 6, L 40, D 16;
Ulysses B 2, L 32, 4 heads of 8; ring B 4, L 32, D 32, 4 heads, a row
masked past 20 and a row wholly masked; the operators B 2, L 16, D 32, 2
layers, 8 heads under Ulysses and 2 under ring). The multi-rank runs are
processes of this file (`python tests/test_torch_sp.py <group> ...`) over
gloo through `file://` in tmp_path, 120 s a rank: group "sp4" is 4 ranks
at (dp 1, sp 4), group "dpsp" 4 ranks at (dp 2, sp 2); both run at once.
Each rank writes its shard's results; the test concatenates the sp
shards. Tolerances:
  * the ops' outputs and gradients against the unsharded versions and
    JAX's ops: rtol 1e-5 (atol 1e-6), f32;
  * the operators against the local path and JAX's sequence-parallel
    operator: outputs rtol 2e-4, atol 2e-5; gradients rtol 5e-4, atol
    5e-5 (JAX's test_flatten_transformer_*_parity);
  * the Trainer's weights against one process: rtol 2e-4, atol 2e-5, the
    attention key biases left out as tests/test_torch_mp.py leaves BERT's
    (their exact gradient is 0 and Adam amplifies the residue differently
    under each partitioning);
    its test metrics within 5e-3 of one process's and of JAX's
    (tests/test_mesh_policy.py::test_mesh_policy_sp_flatten_transformer).
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

RANK_TIMEOUT_S = 120
OP_TOL = dict(rtol=1e-5, atol=1e-6)
OUT_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
DATA_KW = dict(num_items=40, num_users=24, title_len=8, history_len=4,
               inters_per_user=10)


def flatten_cfg(sp: bool) -> dict:
    """JAX's test_mesh_policy_sp_flatten_transformer model (L 36 = 4
    clicks x 9 tokens)."""
    layer = {"num_hidden_layers": 1, "num_attention_heads": 4,
             "dropout": 0.0, "attention_dropout": 0.0}
    return {"meta": {"item": "Transformer", "user": "FlattenTransformer",
                     "predictor": "Dot"},
            "config": {"use_item_content": True, "hidden_size": 16,
                       "use_neg_sampling": True, "neg_count": 2,
                       "use_fast_eval": False, "flatten_mode": True,
                       "item_config": dict(layer),
                       "user_config": dict(layer, sequence_parallel=sp)}}


POLICY = {"batch_size": 8, "epoch": 1, "epoch_batch": 2, "lr": 1e-3,
          "simple_dev": True}
METRICS = ["GAUC", "MRR", "NDCG@1", "NDCG@5", "NDCG@10"]
OPERATORS = {  # name: (JAX / port class, its kwargs)
    "ulysses": ("FlattenTransformerOperator",
                dict(num_hidden_layers=2, num_attention_heads=8,
                     attention_dropout=0.0)),
    "ring": ("FlattenTransformerOperator",
             dict(num_hidden_layers=2, num_attention_heads=2,
                  attention_dropout=0.0, sp_impl="ring")),
    "fastformer": ("FlattenFastformerOperator",
                   dict(num_hidden_layers=2, num_attention_heads=4,
                        hidden_dropout_prob=0.0)),
}


def _inputs() -> dict:
    rng = np.random.default_rng(5)
    f = np.float32
    out = {"pool": (rng.normal(size=(6, 40, 16)).astype(f),
                    rng.normal(size=(6, 40)).astype(f),
                    (rng.random((6, 40)) < 0.7).astype(f)),
           "ulysses": tuple(rng.normal(size=(2, 32, 32)).astype(f)
                            for _ in range(3))
           + ((rng.random((2, 32)) < 0.8).astype(f),),
           "ring": tuple(rng.standard_normal((4, 32, 32)).astype(f)
                         for _ in range(3))}
    mask = np.ones((4, 32), f)
    mask[1, 20:] = 0
    mask[2, :] = 0
    out["ring"] += (mask,)
    x = rng.normal(size=(2, 16, 32)).astype(f)
    m = (rng.random((2, 16)) > 0.2).astype(np.int32)
    m[:, 0] = 1
    out["op_x"], out["op_mask"] = x, m
    return out


# --------------------------------------------------------------------- #
# the functions each side runs                                          #
# --------------------------------------------------------------------- #
def _ops():
    from legommenders_tpu_torch.ops.ring_attention import ring_attention
    from legommenders_tpu_torch.ops.sp_additive import sp_additive_attention
    from legommenders_tpu_torch.ops.sp_attention import ulysses_attention
    return {"pool": lambda x, s, m, axis: sp_additive_attention(
                x, s, m, axis),
            "ulysses": lambda q, k, v, m, axis: ulysses_attention(
                q, k, v, m, axis, num_heads=4),
            "ring": lambda q, k, v, m, axis: ring_attention(
                q, k, v, m, axis, num_heads=4)}


def _dense_attention(q, k, v, m, H=4):
    """The unsharded masked attention (JAX's test reference)."""
    from legommenders_tpu_torch.ops.core import masked_softmax
    B, L, D = q.shape
    d = D // H
    qh, kh, vh = (t.reshape(B, L, H, d) for t in (q, k, v))
    scores = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / np.sqrt(d)
    attn = masked_softmax(scores, m[:, None, None, :])
    return torch.einsum("bhqk,bkhd->bqhd", attn, vh).reshape(B, L, D)


def unsharded(name, args):
    """The port's unsharded version: output and the gradients of
    sum(out ** 2) with respect to the float inputs (all but the mask)."""
    from legommenders_tpu_torch.ops.core import masked_softmax
    ts = [torch.tensor(a, requires_grad=i < len(args) - 1)
          for i, a in enumerate(args)]
    if name == "pool":  # JAX ops/core.additive_attention_pool
        x, s, m = ts
        out = torch.einsum("bl,bld->bd", masked_softmax(s, m), x)
    else:
        out = _dense_attention(*ts)
    (out ** 2).sum().backward()
    return out.detach(), [t.grad for t in ts[:-1]]


def sharded(name, args, axis):
    """This rank's shard through the sp op: (output, local gradients)."""
    ts = []
    for i, a in enumerate(args):
        t = torch.tensor(a).chunk(axis.size, dim=1)[axis.index].clone()
        ts.append(t.requires_grad_(i < len(args) - 1))
    out = _ops()[name](*ts, axis)
    (out ** 2).sum().backward()
    return out.detach(), [t.grad for t in ts[:-1]]


def _operator(name, sp: bool, dropout: float = 0.0):
    from legommenders_tpu_torch.utils.registry import OPERATORS as REG
    import legommenders_tpu_torch.models.operators  # noqa: F401
    cls, kw = OPERATORS[name]
    kw = dict(kw)
    if dropout:
        kw["attention_dropout"] = dropout
    return REG[cls[:-len("Operator")]](hidden_size=32, input_dim=32,
                                       sequence_parallel=sp, **kw)


def operator_run(name, state, x, mask, mesh=None, dropout=0.0):
    """The operator's output, its input's gradient and every parameter's
    gradient (summed over sp under `mesh`) of sum(out ** 2)."""
    op = _operator(name, True, dropout)
    op.load_state_dict(state)
    xt = torch.tensor(x, requires_grad=True)
    rng = torch.Generator().manual_seed(7) if dropout else None
    out = op(xt, torch.tensor(mask), rng)
    loss = (out ** 2).sum()
    loss.backward()
    if mesh is not None:
        tmesh.reduce_gradients(list(op.parameters()), loss.detach(), mesh,
                               tmesh.partial_params(op))
    return {"out": out.detach(), "dx": xt.grad,
            "grads": {n: p.grad for n, p in op.named_parameters()}}


def _data():
    from legommenders_tpu_torch.data.processors.synthetic import (
        SyntheticProcessor,
    )
    return SyntheticProcessor(**DATA_KW).as_lego_data()


def trainer_run(state, mesh_cfg=None) -> dict:
    from legommenders_tpu_torch.runtime.manager import Manager
    from legommenders_tpu_torch.runtime.trainer import Trainer

    policy = dict(POLICY)
    if mesh_cfg:
        policy["mesh"] = mesh_cfg
    m = Manager(model_cfg=flatten_cfg(bool(mesh_cfg)),
                exp_cfg={"policy": policy, "metrics": METRICS},
                data=_data(), device="cpu")
    m.model.load_state_dict(state)
    t = Trainer(m, seed=5, lm_cache_root=None)
    try:
        t.train()
        return {"state": {k: v.clone()
                          for k, v in m.model.state_dict().items()},
                "test": t.test(), "losses": list(t.losses)}
    finally:
        tmesh.set_sp_mesh(None)


# --------------------------------------------------------------------- #
# rank groups                                                           #
# --------------------------------------------------------------------- #
def _save(tmp, case, rank, obj):
    torch.save(obj, os.path.join(tmp, f"{case}.{rank}.pt"))


def _sp_cases(tmp, rank, mesh, inputs, tag):
    axis = mesh.sp_axis
    for name in ("pool", "ulysses", "ring"):
        _save(tmp, f"op_{name}{tag}", rank,
              sharded(name, inputs[name], axis))
    with tmesh.sequence_parallel(mesh):
        for name in OPERATORS:
            _save(tmp, f"{name}{tag}", rank, operator_run(
                name, inputs[name + "_state"], inputs["op_x"],
                inputs["op_mask"], mesh))


def group_sp4(tmp, rank):
    """(dp 1, sp 4): the ops, the operators and JAX's refusals."""
    mesh = tmesh.mesh_from_policy({"sp": 4})
    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    _sp_cases(tmp, rank, mesh, inputs, "4")
    from legommenders_tpu_torch.ops.sp_attention import ulysses_attention
    refusals = {}
    q = torch.zeros(2, 8, 24)
    for case, call in (
            ("heads", lambda: ulysses_attention(
                q, q, q, torch.ones(2, 8), mesh.sp_axis, num_heads=6)),
            ("length", lambda: _operator("ulysses", True)(
                torch.zeros(2, 30, 32), torch.ones(2, 30)))):
        with tmesh.sequence_parallel(mesh):
            try:
                call()
            except ValueError as e:
                refusals[case] = str(e)
    _save(tmp, "refusals", rank, refusals)


def group_dpsp(tmp, rank):
    """(dp 2, sp 2): the ops and operators within each dp row, the sp
    dropout draws, and the Trainer."""
    mesh = tmesh.mesh_from_policy({"dp": 2, "sp": 2})
    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    _sp_cases(tmp, rank, mesh, inputs, "2")
    with tmesh.sequence_parallel(mesh):
        _save(tmp, "dropout", rank, operator_run(
            "ulysses", inputs["ulysses_state"], inputs["op_x"],
            inputs["op_mask"], mesh, dropout=0.1))
    _save(tmp, "trainer", rank, trainer_run(inputs["trainer_state"],
                                            {"dp": 2, "sp": 2}))


GROUPS = {"sp4": (group_sp4, 4), "dpsp": (group_dpsp, 4)}


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


def _load(tmp, case, ranks):
    return [torch.load(os.path.join(tmp, f"{case}.{r}.pt"),
                       weights_only=False) for r in ranks]


# --------------------------------------------------------------------- #
# the runs                                                              #
# --------------------------------------------------------------------- #
def _jax_ops(inputs):
    """JAX's sp ops at sp 2 and 4 on the virtual devices: output and the
    gradients of sum(out ** 2)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from legommenders_tpu.ops.ring_attention import ring_attention
    from legommenders_tpu.ops.sp_additive import sp_additive_attention
    from legommenders_tpu.ops.sp_attention import ulysses_attention

    out = {}
    for n in (2, 4):
        mesh = Mesh(np.asarray(jax.devices()[:n]), ("sp",))
        fns = {"pool": lambda x, s, m: sp_additive_attention(x, s, m, mesh),
               "ulysses": lambda q, k, v, m: ulysses_attention(
                   q, k, v, m, mesh, num_heads=4),
               "ring": lambda q, k, v, m: ring_attention(
                   q, k, v, m, mesh, num_heads=4)}
        for name, f in fns.items():
            args = [jnp.asarray(a) for a in inputs[name]]
            nf = len(args) - 1

            def loss(*fl, f=f, m=args[-1]):
                return jnp.sum(f(*fl, m) ** 2)
            with mesh:
                y = jax.jit(f)(*args)
                g = jax.jit(jax.grad(loss, argnums=tuple(range(nf))))(
                    *args[:-1])
            out[f"op_{name}{n}"] = (np.asarray(y),
                                    [np.asarray(a) for a in g])
    return out


def _jax_operators(inputs):
    """Each operator's JAX params (bridged to the port) and JAX's
    sequence-parallel operator's output and gradients at sp 4 (JAX's
    test width; the port's sp 2 and 4 are held against it)."""
    import jax
    import jax.numpy as jnp

    from legommenders_tpu.models.operators.flatten_ops import (
        FlattenFastformerOperator as JFast,
    )
    from legommenders_tpu.models.operators.transformer import (
        FlattenTransformerOperator as JTrans,
    )
    from legommenders_tpu.parallel.mesh import make_mesh, sequence_parallel
    from legommenders_tpu_torch.bridge import params_from_jax

    x, mask = jnp.asarray(inputs["op_x"]), jnp.asarray(inputs["op_mask"])
    states, out = {}, {}
    for name, (cls, kw) in OPERATORS.items():
        jcls = JTrans if cls == "FlattenTransformerOperator" else JFast
        local = jcls(hidden_size=32, input_dim=32, **kw)
        params = local.init(jax.random.PRNGKey(0), x, mask)
        states[name] = params_from_jax(
            jax.tree_util.tree_map(np.asarray, params),
            _operator(name, True))
        sp_op = jcls(hidden_size=32, input_dim=32, sequence_parallel=True,
                     **kw)
        mesh = make_mesh(n_dp=1, n_mp=2, n_sp=4)
        with sequence_parallel(mesh), mesh:
            y = jax.jit(sp_op.apply)(params, x, mask)
            g = jax.jit(jax.grad(lambda p: jnp.sum(
                sp_op.apply(p, x, mask) ** 2)))(params)
        out[name] = {"out": np.asarray(y), "grads": params_from_jax(
            jax.tree_util.tree_map(np.asarray, g), _operator(name, True))}
    return states, out


def _jax_trainer():
    """JAX's one-process run of the Trainer config: its initial weights
    (bridged) and its test metrics."""
    from legommenders_tpu.data.processors.synthetic import (
        SyntheticProcessor as JSynthetic,
    )
    from legommenders_tpu.runtime.manager import Manager as JManager
    from legommenders_tpu.runtime.trainer import Trainer as JTrainer
    from legommenders_tpu_torch.bridge import params_from_jax
    from legommenders_tpu_torch.runtime.manager import Manager
    import jax

    jm = JManager({}, flatten_cfg(False),
                  exp_cfg={"policy": dict(POLICY), "metrics": METRICS},
                  data=JSynthetic(**DATA_KW).as_lego_data())
    jt = JTrainer(jm, seed=5)
    jt.init()
    target = Manager(model_cfg=flatten_cfg(False), data=_data(),
                     device="cpu").model
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, jt.params),
                            target)
    jt.train()
    return state, jt.test()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both groups (their eight ranks at once), and in this process the
    unsharded versions, one process's operators and Trainer, and JAX's."""
    tmp = str(tmp_path_factory.mktemp("sp"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    inputs = _inputs()
    states, jax_ops = _jax_operators(inputs)
    trainer_state, jax_test = _jax_trainer()
    saved = dict(inputs, trainer_state=trainer_state,
                 **{f"{k}_state": v for k, v in states.items()})
    torch.save(saved, os.path.join(tmp, "inputs.pt"))
    started = {g: spawn(g, tmp) for g in GROUPS}
    try:
        out = {"inputs": saved, "jax_test": jax_test,
               "jax": {**_jax_ops(inputs), **jax_ops}}
        out["one_ops"] = {name: unsharded(name, inputs[name])
                          for name in ("pool", "ulysses", "ring")}
        out["one"] = {}
        for name in OPERATORS:
            op = _operator(name, False)
            op.load_state_dict(states[name])
            xt = torch.tensor(inputs["op_x"], requires_grad=True)
            y = op(xt, torch.tensor(inputs["op_mask"]))
            (y ** 2).sum().backward()
            out["one"][name] = {"out": y.detach(), "dx": xt.grad, "grads": {
                k: p.grad for k, p in op.named_parameters()}}
        out["one"]["dropout"] = operator_run(
            "ulysses", states["ulysses"], inputs["op_x"], inputs["op_mask"],
            dropout=0.1)
        out["one"]["trainer"] = trainer_run(trainer_state)
        for procs in started.values():
            wait(procs)
        out["tmp"] = tmp
    finally:
        torch.set_num_threads(n)
        for procs in started.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
    return out


def _cat(outs, key, dim=1):
    return torch.cat([o[key] for o in outs], dim=dim)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64), **tol)


# --------------------------------------------------------------------- #
# the ops                                                               #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("name", ["pool", "ulysses", "ring"])
def test_sp_op_matches_unsharded_and_jax(runs, name, sp):
    outs = _load(runs["tmp"], f"op_{name}{sp}", range(sp))
    want_y, want_g = runs["one_ops"][name]
    jax_y, jax_g = runs["jax"][f"op_{name}{sp}"]
    if name == "pool":  # (B, D) on every rank
        for o in outs:
            _close(o[0], want_y, **OP_TOL)
        got_y = outs[0][0]
    else:
        got_y = torch.cat([o[0] for o in outs], dim=1)
    _close(got_y, want_y, **OP_TOL)
    _close(got_y, jax_y, **OP_TOL)
    for i, (w, j) in enumerate(zip(want_g, jax_g)):
        got = torch.cat([o[1][i] for o in outs], dim=1)
        _close(got, w, **OP_TOL)
        _close(got, j, **OP_TOL)


def test_ring_attention_gives_zeros_on_a_wholly_masked_row(runs):
    outs = _load(runs["tmp"], "op_ring4", range(4))
    got = torch.cat([o[0] for o in outs], dim=1)
    assert torch.count_nonzero(got[2]) == 0
    assert torch.count_nonzero(got[1]) > 0


# --------------------------------------------------------------------- #
# the operators                                                         #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("name", list(OPERATORS))
def test_sp_operator_matches_local_and_jax(runs, name, sp):
    outs = _load(runs["tmp"], f"{name}{sp}", range(sp))
    one, jx = runs["one"][name], runs["jax"][name]
    for o in outs:  # the pooled output and the input's gradient, replicated
        _close(o["out"], one["out"], **OUT_TOL)
        _close(o["dx"], one["dx"], **GRAD_TOL)
        assert torch.equal(o["out"], outs[0]["out"])
    _close(outs[0]["out"], jx["out"], **OUT_TOL)
    for k, want in one["grads"].items():
        for o in outs:
            _close(o["grads"][k], want, err_msg=k, **GRAD_TOL)
        _close(outs[0]["grads"][k], jx["grads"][k], err_msg=k, **GRAD_TOL)


def test_sp_dropout_draws_what_one_process_draws(runs):
    """At attention_dropout 0.1 under sequence_parallel the attention
    probabilities take none (JAX transformer.py:34) and the hidden
    dropout keeps each rank's positions of the whole sequence's draw: sp 2
    is one process."""
    outs = _load(runs["tmp"], "dropout", range(2))
    one = runs["one"]["dropout"]
    local = runs["one"]["ulysses"]
    assert not torch.allclose(one["out"], local["out"])
    for o in outs:
        _close(o["out"], one["out"], **OUT_TOL)
        for k, want in one["grads"].items():
            _close(o["grads"][k], want, err_msg=k, **GRAD_TOL)


def test_transformer_layer_takes_no_attention_dropout_under_the_flag():
    """sequence_parallel alone (no sp mesh) sets the layers' attention
    dropout to 0 (JAX transformer.py:34): the local path then equals a
    layer whose attention dropout is 0, from the same generator."""
    from legommenders_tpu_torch.models.operators.transformer import (
        TransformerLayer,
    )
    torch.manual_seed(0)
    a = TransformerLayer(16, 4, 32, dropout=0.1, sequence_parallel=True)
    b = TransformerLayer(16, 4, 32, dropout=0.1)
    b.load_state_dict(a.state_dict())
    assert a.attn.dropout == 0.0 and b.attn.dropout == 0.1
    x, mask = torch.randn(2, 6, 16), torch.ones(2, 6)
    ya = a(x, mask, torch.Generator().manual_seed(3))
    b.attn.dropout = 0.0
    yb = b(x, mask, torch.Generator().manual_seed(3))
    torch.testing.assert_close(ya, yb, rtol=0, atol=0)


def test_sp_refusals_are_jaxs(runs):
    for r in _load(runs["tmp"], "refusals", range(4)):
        assert "has to be divisible by the size of the named axis sp (4)" \
            in r["heads"]
        assert "not evenly divisible by the corresponding mesh axis " \
            "sizes" in r["length"]


@pytest.mark.parametrize("cfg", [{"mp": 2, "sp": 2}, {"mp": 2, "pp": 2},
                                 {"sp": 2, "pp": 2},
                                 {"sp": 2, "catalog_parallel": True}])
def test_mesh_from_policy_lays_every_combination_as_jax(cfg, monkeypatch):
    """rank = ((dp_index * mp + mp_index) * sp + sp_index) * pp + pp_index:
    two of mp, sp and pp, and sp with catalog_parallel, over a group of 4,
    in JAX's shape and rank order (the catalog axis the (dp, mp) ranks at
    one sp index); pp with catalog_parallel stops at the Manager with
    JAX's message."""
    from test_torch_dp import assert_laid_as_jax

    m = tmesh.Mesh(2, 5, 1, False, 0, 2, 2)
    assert m.coords == (1, 0, 0, 1)
    assert m.shape == {"dp": 2, "sp": 2, "pp": 2}
    assert tmesh.Mesh(1, 3, 1, False, 0, 4).sp_index == 3
    assert_laid_as_jax(cfg, 4, monkeypatch)
    if cfg.get("catalog_parallel"):
        mesh = tmesh.mesh_from_policy(cfg)
        assert mesh.catalog_axis.size == 2
        assert mesh.catalog_axis.index == mesh.dp_index
        with pytest.raises(SystemExit, match="pp > 1 cannot combine with "
                           "catalog_parallel"):
            from legommenders_tpu_torch.runtime.manager import Manager
            Manager(model_cfg={"meta": {"item": "Bert"}}, data=_data(),
                    exp_cfg={"policy": {"mesh": {"pp": 4,
                                                 "catalog_parallel": True}}},
                    device="cpu")
    monkeypatch.setattr(tmesh, "world", lambda: (0, 1))
    with pytest.raises(ValueError, match="2x1x2x1=4 devices, only 1"):
        tmesh.mesh_from_policy({"dp": 2, "sp": 2})


# --------------------------------------------------------------------- #
# the Trainer                                                           #
# --------------------------------------------------------------------- #
def test_dpsp_trainer_matches_one_process_and_jax(runs):
    outs = _load(runs["tmp"], "trainer", range(4))
    one = runs["one"]["trainer"]
    init = runs["inputs"]["trainer_state"]
    moved = 0
    for k, want in one["state"].items():
        moved += not torch.equal(want, init[k])
        if k.endswith("attn.k.bias"):
            continue  # its exact gradient is 0; Adam amplifies the residue
        for o in outs:
            _close(o["state"][k], want, err_msg=k, **OUT_TOL)
    assert moved >= 8
    for o in outs:
        np.testing.assert_allclose(o["losses"], one["losses"], rtol=1e-5)
        for ref in (one["test"], runs["jax_test"]):
            for k, v in ref.items():
                assert abs(o["test"][k] - v) < 5e-3, (k, o["test"], ref)


if __name__ == "__main__":
    rank_main(sys.argv[1:])
