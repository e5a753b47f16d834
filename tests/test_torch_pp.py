"""The pipeline-parallel axis of exp.policy.mesh in the port: `gpipe`
against a serial run and JAX's gpipe, the BERT slice at pp 2 and the
Llama slice at pp 4 against the serial slice and JAX's staged slices,
the row padding, the dropout contract under stages, the Manager's
`_apply_pp_policy` refusals, (dp 2, pp 2) Trainer runs (two under the
`ffn` and `dots` page remats) against one process and JAX, and the bridge
of a staged slice's and a sequence-parallel operator's JAX weights.

Shapes are JAX's tests/test_parallel.py ones (gpipe: 16 rows of 8, a tanh
layer a stage, 4 microbatches; the BERT slice B 8, L 6, D 16, 2 layers of
2 heads, LoRA r 2 over a frozen base, a row masked past 4, 4
microbatches; the Llama slice B 8, L 5, D 16, 4 layers of 2 heads, FFN
32, the final RMSNorm) and tests/test_mesh_policy.py's Trainer config (40
items, 24 users, a 2-layer BERT of 2 heads, dropout 0). The multi-rank
runs are processes of this file (`python tests/test_torch_pp.py <group>
...`) over gloo through `file://` in tmp_path, 120 s a rank: group "pp2"
is 2 ranks at (dp 1, pp 2), "pp4" 4 ranks at (dp 1, pp 4), "dppp" 4 ranks
at (dp 2, pp 2); all run at once. Tolerances (f32):
  * gpipe against the serial run and JAX's: outputs rtol 1e-5, atol 1e-6;
    gradients rtol 1e-4, atol 1e-5 (JAX's test_gpipe_matches_sequential);
  * the slices against the serial slice and JAX's staged slice: outputs
    2e-5, gradients 5e-5 (JAX's test_pipeline_stages_*_parity);
  * the Trainer's weights against one process: rtol 2e-4, atol 2e-5; its
    test metrics within 5e-3 of one process's and of JAX's
    (tests/test_mesh_policy.py::test_mesh_policy_pp_bert_parity).
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
GPIPE_OUT = dict(rtol=1e-5, atol=1e-6)
GPIPE_GRAD = dict(rtol=1e-4, atol=1e-5)
SLICE_OUT = dict(rtol=2e-5, atol=2e-5)
SLICE_GRAD = dict(rtol=5e-5, atol=5e-5)
STATE_TOL = dict(rtol=2e-4, atol=2e-5)
DATA_KW = dict(num_items=40, num_users=24, title_len=8, history_len=4,
               inters_per_user=10)
METRICS = ["GAUC", "MRR", "NDCG@1", "NDCG@5", "NDCG@10"]
POLICY = {"batch_size": 16, "epoch": 1, "epoch_batch": 3, "lr": 1e-3}
# the Trainer runs: the whole catalog at once, and in pages of 16 under
# the `ffn` and `dots` page remat (the recompute makes the pp transfers
# again)
TRAINER_CASES = {"trainer": "", "trainer_ffn": "ffn", "trainer_dots": "dots"}


def bert_cfg(remat: str = "") -> dict:
    """JAX's test_mesh_policy_pp_bert_parity model; with `remat`, pages of
    16 items under that page remat policy."""
    cfg = {"meta": {"item": "Bert", "user": "Ada", "predictor": "Dot"},
           "config": {"use_item_content": True, "hidden_size": 16,
                      "use_neg_sampling": True, "neg_count": 2,
                      "cache_page_size": 16,
                      "item_config": {"num_hidden_layers": 2,
                                      "num_attention_heads": 2,
                                      "dropout": 0.0, "lora_dropout": 0.0,
                                      "attention_pack": 0},
                      "user_config": {"dropout": 0.0}}}
    if remat:
        cfg["config"].update(item_page_size=16, item_page_remat=remat)
    return cfg


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    f = np.float32
    bmask = np.ones((8, 6), np.int32)
    bmask[3, 4:] = 0
    return {"gpipe_W": (rng.normal(size=(4, 8, 8)) * 0.3).astype(f),
            "gpipe_b": (rng.normal(size=(4, 8)) * 0.1).astype(f),
            "gpipe_x": rng.normal(size=(16, 8)).astype(f),
            "bert_x": rng.standard_normal((8, 6, 16)).astype(f),
            "bert_mask": bmask,
            "llama_x": rng.standard_normal((8, 5, 16)).astype(f),
            "llama_mask": np.ones((8, 5), np.int32)}


# --------------------------------------------------------------------- #
# the functions each side runs                                          #
# --------------------------------------------------------------------- #
def gpipe_run(inputs, P, axis=None):
    """P tanh stages over 16 rows in 4 microbatches (serial without
    `axis`); output and the weights' gradient of sum(out ** 2) (summed
    over pp)."""
    from legommenders_tpu_torch.parallel.pipeline import gpipe
    W = torch.tensor(inputs["gpipe_W"][:P], requires_grad=True)
    b = torch.tensor(inputs["gpipe_b"][:P])
    x = torch.tensor(inputs["gpipe_x"])
    if axis is None:
        y = x
        for i in range(P):
            y = torch.tanh(y @ W[i] + b[i])
    else:
        s = axis.index
        y = gpipe(lambda m, h: torch.tanh(h @ W[s] + b[s]), x, axis, 4)
    (y ** 2).sum().backward()
    if axis is not None:
        tmesh.all_reduce_(W.grad, axis)
    return {"y": y.detach(), "dW": W.grad}


def bert_slice(stages=0, dropout=0.0, microbatches=4):
    from legommenders_tpu_torch.models.lm.layers import BertEncoderSlice
    return BertEncoderSlice(
        2, 16, num_heads=2, start=0, embed=False, lora_r=2,
        lora_dropout=0.0, freeze_base=True, dropout=dropout,
        fused_attention=True, pipeline_stages=stages,
        pipeline_microbatches=microbatches if stages else 0)


def llama_slice(stages=0):
    from legommenders_tpu_torch.models.lm.layers import LlamaDecoderSlice
    return LlamaDecoderSlice(4, 16, num_heads=2, intermediate_size=32,
                             start=0, final_norm=True, fused_attention=True,
                             pipeline_stages=stages, dtype=torch.float32)


def slice_run(sl, state, x, mask, mesh=None, rows=None, rng=None):
    """The slice's output and every trainable parameter's gradient of
    sum(out ** 2) (the staged layers' summed over pp under `mesh`)."""
    sl.load_state_dict(state)
    x, mask = torch.tensor(x), torch.tensor(mask)
    if rows is not None:
        x, mask = x[:rows], mask[:rows]
    xt = x.clone().requires_grad_(True)
    y = sl(xt, mask, rng)
    loss = (y ** 2).sum()
    loss.backward()
    if mesh is not None:
        tmesh.reduce_gradients([], loss.detach(), mesh,
                               tmesh.partial_params(sl))
    return {"y": y.detach(), "dx": xt.grad,
            "grads": {n: p.grad for n, p in sl.named_parameters()
                      if p.grad is not None}}


def _data():
    from legommenders_tpu_torch.data.processors.synthetic import (
        SyntheticProcessor,
    )
    return SyntheticProcessor(**DATA_KW).as_lego_data()


def _manager(cfg, mesh_cfg=None, data=None):
    from legommenders_tpu_torch.runtime.manager import Manager
    policy = dict(POLICY)
    if mesh_cfg:
        policy["mesh"] = mesh_cfg
    return Manager(model_cfg=copy.deepcopy(cfg),
                   exp_cfg={"policy": policy, "metrics": METRICS},
                   data=data if data is not None else _data(), device="cpu")


def trainer_run(state, cfg, mesh_cfg=None) -> dict:
    from legommenders_tpu_torch.runtime.trainer import Trainer
    m = _manager(cfg, mesh_cfg)
    m.model.load_state_dict(state)
    t = Trainer(m, seed=9, lm_cache_root=None)
    try:
        t.train()
        return {"state": {k: v.clone()
                          for k, v in m.model.state_dict().items()},
                "test": t.test(), "losses": list(t.losses),
                "stages": m.model.item_op.lm.pipeline_stages}
    finally:
        tmesh.set_pp_mesh(None)


# --------------------------------------------------------------------- #
# rank groups                                                           #
# --------------------------------------------------------------------- #
def _save(tmp, case, rank, obj):
    torch.save(obj, os.path.join(tmp, f"{case}.{rank}.pt"))


def _load_inputs(tmp):
    return torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)


def group_pp2(tmp, rank):
    """(dp 1, pp 2): gpipe, the BERT slice, its padding, its dropout."""
    from legommenders_tpu_torch.models.lm import layers
    mesh = tmesh.mesh_from_policy({"pp": 2})
    inputs = _load_inputs(tmp)
    _save(tmp, "gpipe2", rank, gpipe_run(inputs, 2, mesh.pp_axis))
    st = inputs["bert_state"]
    with tmesh.pipeline_parallel(mesh):
        _save(tmp, "bert", rank, slice_run(
            bert_slice(2), st, inputs["bert_x"], inputs["bert_mask"], mesh))
        _save(tmp, "bert_pad", rank, slice_run(
            bert_slice(2), st, inputs["bert_x"], inputs["bert_mask"], mesh,
            rows=7))
        kept, plain = [], layers.dropout

        def spy(x, p, rng):
            y = plain(x, p, rng)
            if rng is not None and p > 0:
                kept.append(float((y != 0).float().mean()))
            return y
        layers.dropout = spy
        try:
            out = slice_run(bert_slice(2, dropout=0.1), st, inputs["bert_x"],
                            inputs["bert_mask"], mesh,
                            rng=torch.Generator().manual_seed(3))
        finally:
            layers.dropout = plain
        _save(tmp, "bert_drop", rank, dict(out, kept=kept))


def group_pp4(tmp, rank):
    """(dp 1, pp 4): gpipe and the Llama slice."""
    mesh = tmesh.mesh_from_policy({"pp": 4})
    inputs = _load_inputs(tmp)
    _save(tmp, "gpipe4", rank, gpipe_run(inputs, 4, mesh.pp_axis))
    with tmesh.pipeline_parallel(mesh):
        _save(tmp, "llama", rank, slice_run(
            llama_slice(4), inputs["llama_state"], inputs["llama_x"],
            inputs["llama_mask"], mesh))


def group_dppp(tmp, rank):
    """(dp 2, pp 2): the refusals, the padded slice over dp, the two
    Trainer runs."""
    from legommenders_tpu_torch.runtime.manager import Manager
    inputs = _load_inputs(tmp)
    refusals = {}
    data = _data()
    cnn = {"meta": {"item": "CNN", "user": "Ada", "predictor": "Dot"},
           "config": {"use_item_content": True, "hidden_size": 16}}
    bert = bert_cfg()
    explicit = copy.deepcopy(bert)
    explicit["config"]["item_config"]["pipeline_stages"] = 4
    for case, cfg, mesh_cfg in (
            ("knob", cnn, {"dp": 2, "pp": 2}),
            ("catalog", bert, {"dp": 2, "pp": 2, "catalog_parallel": True}),
            ("explicit", explicit, {"dp": 2, "pp": 2})):
        try:
            Manager(model_cfg=cfg, exp_cfg={"policy": {
                "batch_size": 8, "mesh": mesh_cfg}}, data=data,
                device="cpu")
        except SystemExit as e:
            refusals[case] = str(e)
    _save(tmp, "refusals", rank, refusals)
    mesh = tmesh.mesh_from_policy({"dp": 2, "pp": 2})
    with tmesh.pipeline_parallel(mesh):
        _save(tmp, "bert_pad_dp", rank, slice_run(
            bert_slice(2), inputs["bert_state"], inputs["bert_x"],
            inputs["bert_mask"], mesh, rows=7))
    for case, remat in TRAINER_CASES.items():
        _save(tmp, case, rank, trainer_run(inputs["trainer_state"],
                                           bert_cfg(remat),
                                           {"dp": 2, "pp": 2}))


GROUPS = {"pp2": (group_pp2, 2), "pp4": (group_pp4, 4),
          "dppp": (group_dppp, 4)}


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
# JAX's side                                                            #
# --------------------------------------------------------------------- #
def _lora_b_drawn(params, seed=1):
    """JAX params with every LoRA B drawn (it starts at 0: its A's
    gradient would be 0)."""
    import jax
    rng = np.random.default_rng(seed)

    def draw(path, a):
        a = np.asarray(a)
        if str(getattr(path[-1], "key", "")) == "lora_B":
            return (rng.normal(size=a.shape) * 0.1).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(draw, params)


def _jax_side(inputs):
    """JAX's gpipe at 2 and 4 stages; its BERT slice at pp 2 (output and
    gradients) and Llama slice at pp 4 (output), their params bridged;
    the Trainer config's one-process run (bridged initial weights and
    test metrics)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from legommenders_tpu.data.processors.synthetic import (
        SyntheticProcessor as JSynthetic,
    )
    from legommenders_tpu.models.lm.layers import (
        BertEncoderSlice as JBert, LlamaDecoderSlice as JLlama,
    )
    from legommenders_tpu.parallel.mesh import pipeline_parallel
    from legommenders_tpu.parallel.pipeline import gpipe
    from legommenders_tpu.runtime.manager import Manager as JManager
    from legommenders_tpu.runtime.trainer import Trainer as JTrainer
    from legommenders_tpu_torch.bridge import params_from_jax

    out = {}
    for P in (2, 4):
        mesh = Mesh(np.asarray(jax.devices()[:P]), ("pp",))
        Ws = jnp.asarray(inputs["gpipe_W"][:P])
        bs = jnp.asarray(inputs["gpipe_b"][:P])
        x = jnp.asarray(inputs["gpipe_x"])

        def piped(W, mesh=mesh, bs=bs, x=x):
            return gpipe(lambda p, xm: jnp.tanh(xm @ p[0][0] + p[1][0]),
                         (W[:, None], bs[:, None]), x, mesh,
                         num_microbatches=4)
        y = jax.jit(piped)(Ws)
        g = jax.jit(jax.grad(lambda W: jnp.sum(piped(W) ** 2)))(Ws)
        out[f"gpipe{P}"] = {"y": np.asarray(y), "dW": np.asarray(g)}

    def to_np(t):
        return jax.tree_util.tree_map(np.asarray, t)

    # the BERT slice at pp 2
    x, mask = jnp.asarray(inputs["bert_x"]), jnp.asarray(inputs["bert_mask"])
    kw = dict(num_layers=2, num_heads=2, start=0, embed=False, dropout=0.0,
              lora_r=2, lora_dropout=0.0, freeze_base=True)
    params = _lora_b_drawn(JBert(**kw).init(jax.random.PRNGKey(0), x, mask,
                                            False))
    piped = JBert(**kw, pipeline_stages=2, pipeline_microbatches=4)
    with pipeline_parallel(Mesh(np.asarray(jax.devices()[:2]), ("pp",))):
        y = jax.jit(lambda p: piped.apply(p, x, mask, False))(params)
        g = jax.jit(jax.grad(lambda p: jnp.sum(
            piped.apply(p, x, mask, False) ** 2)))(params)
    out["bert_state"] = params_from_jax(to_np(params), bert_slice())
    out["bert"] = {"y": np.asarray(y),
                   "grads": params_from_jax(to_np(g), bert_slice())}
    # the Llama slice at pp 4
    x = jnp.asarray(inputs["llama_x"])
    mask = jnp.asarray(inputs["llama_mask"])
    kw = dict(num_layers=4, num_heads=2, intermediate_size=32, start=0,
              final_norm=True, dtype=jnp.float32)
    params = JLlama(**kw).init(jax.random.PRNGKey(0), x, mask, False)
    piped = JLlama(**kw, pipeline_stages=4)
    with pipeline_parallel(Mesh(np.asarray(jax.devices()[:4]), ("pp",))):
        y = jax.jit(lambda p: piped.apply(p, x, mask, False))(params)
    out["llama_state"] = params_from_jax(to_np(params), llama_slice())
    out["llama"] = {"y": np.asarray(y)}
    # the Trainer config, one process
    jm = JManager({}, bert_cfg(), exp_cfg={"policy": dict(POLICY),
                                           "metrics": METRICS},
                  data=JSynthetic(**DATA_KW).as_lego_data())
    jt = JTrainer(jm, seed=9)
    jt.init()
    out["trainer_state"] = params_from_jax(to_np(jt.params),
                                           _manager(bert_cfg()).model)
    jt.train()
    out["trainer_test"] = jt.test()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three groups (their ten ranks at once), and in this process the
    serial runs and JAX's."""
    tmp = str(tmp_path_factory.mktemp("pp"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    inputs = _inputs()
    jx = _jax_side(inputs)
    saved = dict(inputs, bert_state=jx["bert_state"],
                 llama_state=jx["llama_state"],
                 trainer_state=jx["trainer_state"])
    torch.save(saved, os.path.join(tmp, "inputs.pt"))
    started = {g: spawn(g, tmp) for g in GROUPS}
    try:
        out = {"inputs": saved, "jax": jx, "one": {}}
        one = out["one"]
        for P in (2, 4):
            one[f"gpipe{P}"] = gpipe_run(inputs, P)
        st = jx["bert_state"]
        one["bert"] = slice_run(bert_slice(), st, inputs["bert_x"],
                                inputs["bert_mask"])
        one["bert_pad"] = slice_run(bert_slice(), st, inputs["bert_x"],
                                    inputs["bert_mask"], rows=7)
        one["bert_drop"] = slice_run(bert_slice(dropout=0.1), st,
                                     inputs["bert_x"], inputs["bert_mask"],
                                     rng=torch.Generator().manual_seed(3))
        one["llama"] = slice_run(llama_slice(), jx["llama_state"],
                                 inputs["llama_x"], inputs["llama_mask"])
        for case, remat in TRAINER_CASES.items():
            one[case] = trainer_run(jx["trainer_state"], bert_cfg(remat))
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


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64), **tol)


def _grads_close(got, want, **tol):
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], err_msg=k, **tol)


# --------------------------------------------------------------------- #
# gpipe and the slices                                                  #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("P", [2, 4])
def test_gpipe_matches_serial_and_jax(runs, P):
    for o in _load(runs["tmp"], f"gpipe{P}", range(P)):
        for want in (runs["one"][f"gpipe{P}"], runs["jax"][f"gpipe{P}"]):
            _close(o["y"], want["y"], **GPIPE_OUT)
            _close(o["dW"], want["dW"], **GPIPE_GRAD)


def test_bert_slice_at_pp2_matches_serial_and_jax(runs):
    one, jx = runs["one"]["bert"], runs["jax"]["bert"]
    lora = sum(float(g.abs().sum()) for k, g in one["grads"].items()
               if "lora_" in k)
    assert lora > 0
    for o in _load(runs["tmp"], "bert", range(2)):
        _close(o["y"], one["y"], **SLICE_OUT)
        _close(o["y"], jx["y"], **SLICE_OUT)
        _grads_close(o["grads"], one["grads"], **SLICE_GRAD)
        _grads_close(o["grads"], {k: jx["grads"][k] for k in one["grads"]},
                     **SLICE_GRAD)


def test_llama_slice_at_pp4_matches_serial_and_jax(runs):
    one = runs["one"]["llama"]
    for o in _load(runs["tmp"], "llama", range(4)):
        _close(o["y"], one["y"], **SLICE_OUT)
        _close(o["y"], runs["jax"]["llama"]["y"], **SLICE_OUT)
        _grads_close(o["grads"], one["grads"], **SLICE_GRAD)


@pytest.mark.parametrize("case", ["bert_pad", "bert_pad_dp"])
def test_rows_not_dividing_m_times_dp_are_padded(runs, case):
    """7 rows at M 4 (and dp 2): padded to 8, cut after; the dp ranks of
    the (dp 2, pp 2) group each run their rows of every microbatch."""
    one = runs["one"]["bert_pad"]
    outs = _load(runs["tmp"], case, range(4 if case.endswith("dp") else 2))
    for o in outs:
        assert o["y"].shape[0] == 7
        _close(o["y"], one["y"], **SLICE_OUT)
    # a dp rank holds its rows' gradient of every rank's loss: their mean
    # over dp (the step's) is one process's
    _close(sum(o["dx"] for o in outs) / len(outs), one["dx"], **SLICE_GRAD)


def test_dropout_under_stages_keeps_its_contract(runs):
    """JAX keys the draws per microbatch and layer, so at dropout 0.1 a
    staged stack draws other masks than the serial one: the contract is
    the keep rate, finite outputs and gradients, and the same result on
    every pp rank."""
    outs = _load(runs["tmp"], "bert_drop", range(2))
    one = runs["one"]["bert_drop"]
    for o in outs:
        assert 0.85 < np.mean(o["kept"]) < 0.95, o["kept"]
        assert torch.isfinite(o["y"]).all()
        assert all(torch.isfinite(g).all() for g in o["grads"].values())
        assert set(o["grads"]) == set(one["grads"])
        torch.testing.assert_close(o["y"], outs[0]["y"], rtol=0, atol=0)
    assert not torch.allclose(outs[0]["y"], runs["one"]["bert"]["y"])


def test_pp_policy_refusals_are_jaxs(runs):
    """JAX manager.py:82-113: an operator without the knob, pp with
    catalog_parallel, an explicit pipeline_stages that is not pp."""
    for r in _load(runs["tmp"], "refusals", range(4)):
        assert "requires an LM item operator with a pipeline_stages knob" \
            in r["knob"]
        assert "cannot combine with catalog_parallel" in r["catalog"]
        assert "item_config.pipeline_stages=4 != mesh pp=2" in r["explicit"]


def test_bridge_needs_no_new_names_for_sp_and_pp():
    """JAX's sp and pp paths read the local path's parameters: a
    pipeline_stages BERT slice and a sequence-parallel flatten operator
    take the JAX trees the local ones take, the same state dict."""
    import jax

    from legommenders_tpu.models.lm.layers import BertEncoderSlice as JBert
    from legommenders_tpu.models.operators.transformer import (
        FlattenTransformerOperator as JTrans,
    )
    from legommenders_tpu_torch.bridge import params_from_jax
    from legommenders_tpu_torch.models.operators.flatten_ops import (
        FlattenTransformerOperator,
    )

    inputs = _inputs()
    x, mask = inputs["bert_x"], inputs["bert_mask"]
    tree = JBert(num_layers=2, num_heads=2, start=0, embed=False, lora_r=2,
                 freeze_base=True).init(jax.random.PRNGKey(0), x, mask, False)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    staged = params_from_jax(tree, bert_slice(2))
    serial = params_from_jax(tree, bert_slice())
    assert staged.keys() == serial.keys()
    assert all(torch.equal(staged[k], serial[k]) for k in serial)
    tree = JTrans(hidden_size=16, input_dim=16, num_hidden_layers=1,
                  num_attention_heads=2).init(jax.random.PRNGKey(1),
                                              x[:, :, :16], mask)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    kw = dict(hidden_size=16, input_dim=16, num_hidden_layers=1,
              num_attention_heads=2)
    sp = params_from_jax(tree, FlattenTransformerOperator(
        sequence_parallel=True, sp_impl="ring", **kw))
    local = params_from_jax(tree, FlattenTransformerOperator(**kw))
    assert sp.keys() == local.keys()
    assert all(torch.equal(sp[k], local[k]) for k in local)


# --------------------------------------------------------------------- #
# the Trainer                                                           #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("case", list(TRAINER_CASES))
def test_dppp_trainer_matches_one_process_and_jax(runs, case):
    outs = _load(runs["tmp"], case, range(4))
    one = runs["one"][case]
    init = runs["inputs"]["trainer_state"]
    assert one["stages"] == 0
    moved = 0
    for k, want in one["state"].items():
        moved += not torch.equal(want, init[k])
        for o in outs:
            _close(o["state"][k], want, err_msg=k, **STATE_TOL)
    assert moved >= 8
    for o in outs:
        assert o["stages"] == 2
        np.testing.assert_allclose(o["losses"], one["losses"], rtol=1e-5)
        for ref in (one["test"], runs["jax"]["trainer_test"]):
            for k, v in ref.items():
                assert abs(o["test"][k] - v) < 5e-3, (k, o["test"], ref)


if __name__ == "__main__":
    rank_main(sys.argv[1:])
