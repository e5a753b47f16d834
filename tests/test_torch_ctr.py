"""The CTR heads and their building blocks in the port vs the JAX package,
on the CPU, module by module on bridged weights.

Each head of tests/test_zoo.py's CTR_HEADS (DNN, DeepFM, PNN, DCN, DCNv2
parallel and stacked_parallel with the low-rank mixture, GDCN, AutoInt,
MaskNet parallel and sequential, FinalMLP), GDCN's sequential mode, DIN
with and without its softmax, MLPLayer with batch norm, Dice alone and
LRLayer are
built in both packages at a small geometry (D 8, MLPs of 16), JAX's
parameters are initialised from a seed and bridged, and the same numpy
inputs (users (N, D), items (N, K, D); DIN's clicks (N, S, D) with a mask
that is not a prefix and one row with no valid click) go through both in
eval mode:
  * scores within 1e-5 at f32 (absolute, or relative to the largest);
  * the gradient of sum(scores * cotangent) in every parameter and input
    within 1e-4 of each tensor's largest value; a dense bias ahead of a
    batch norm, whose gradient is zero to first order (the norm takes the
    mean out), against its weight's gradient;
  * scores within 2e-2 of the largest at bf16 (both packages at
    dtype=bf16 on the same f32 weights).
Besides: the pooling and null operators and the single-column identity
against JAX, the single-column inputer's lookup and mask, the bridge's refusals of an unknown leaf and of a port
parameter left unset, and the ill-formed options.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legommenders_tpu.models import common as jcommon
from legommenders_tpu.models.operators import pooling as jpooling
from legommenders_tpu.models.predictors import (
    attention_heads as jheads, cross as jcross, ctr as jctr,
    finalmlp as jfinalmlp, masknet as jmasknet,
)
from legommenders_tpu_torch.bridge import params_from_jax
from legommenders_tpu_torch.models import common
from legommenders_tpu_torch.models.embedding import EmbeddingHub
from legommenders_tpu_torch.models.inputers.single_column import (
    SingleColumnInputer,
)
from legommenders_tpu_torch.models.operators import pooling
from legommenders_tpu_torch.models.predictors import (
    attention_heads, cross, ctr, finalmlp, masknet,
)

N, K, S, D = 6, 3, 7, 8
FWD_TOL, GRAD_TOL, BF16_TOL = 1e-5, 1e-4, 2e-2
SMALL = {"dnn_hidden_units": (16, 16)}

# tests/test_zoo.py's CTR_HEADS, and GDCN's sequential mode
CTR_HEADS = [
    ("DNN", {}),
    ("DeepFM", {}),
    ("PNN", {}),
    ("DCN", {"cross_num": 2}),
    ("DCNv2", {"model_structure": "parallel", "cross_num": 2}),
    ("DCNv2", {"model_structure": "stacked_parallel",
               "use_low_rank_mixture": True, "low_rank": 4,
               "num_experts": 2, "cross_num": 2}),
    ("GDCN", {"cross_num": 2}),
    ("AutoInt", {"num_attention_layers": 1, "attention_dim": 16,
                 "num_attention_heads": 2}),
    ("MaskNet", {"hidden_units": [16], "num_blocks": 2, "block_dim": 8}),
    ("MaskNet", {"hidden_units": [16, 8], "sequential_mode": True}),
    ("FinalMLP", {"mlp1_hidden_units": [16], "mlp2_hidden_units": [16]}),
    ("GDCN", {"cross_num": 2, "sequential_mode": True}),
]
HEAD_CLASSES = {
    "DNN": (jctr.DNNPredictor, ctr.DNNPredictor),
    "DeepFM": (jctr.DeepFMPredictor, ctr.DeepFMPredictor),
    "PNN": (jctr.PNNPredictor, ctr.PNNPredictor),
    "DCN": (jcross.DCNPredictor, cross.DCNPredictor),
    "DCNv2": (jcross.DCNv2Predictor, cross.DCNv2Predictor),
    "GDCN": (jcross.GDCNPredictor, cross.GDCNPredictor),
    "AutoInt": (jheads.AutoIntPredictor, attention_heads.AutoIntPredictor),
    "MaskNet": (jmasknet.MaskNetPredictor, masknet.MaskNetPredictor),
    "FinalMLP": (jfinalmlp.FinalMLPPredictor,
                 finalmlp.FinalMLPPredictor),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(cfg: dict) -> dict:
    """The config as each package takes it: the JAX dataclasses want
    tuples for their sequence fields."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()}


def _head_case(pred: str, pcfg: dict):
    def make(dtype):
        jcls, tcls = HEAD_CLASSES[pred]
        cfg = _fields({**SMALL, **pcfg})
        if pred == "DCNv2":
            cfg = {k: v for k, v in cfg.items() if k != "dnn_hidden_units"}
            cfg["stacked_dnn_hidden_units"] = (16, 16)
            cfg["parallel_dnn_hidden_units"] = (16, 12)
        if pred in ("MaskNet", "FinalMLP"):
            cfg.pop("dnn_hidden_units")
        jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
        return (jcls(hidden_size=D, dtype=jdt, **cfg),
                tcls(hidden_size=D, input_dim=D, dtype=dtype, **cfg))

    def inputs(seed):
        rng = np.random.default_rng(seed)
        user = rng.normal(size=(N, D)).astype(np.float32)
        items = rng.normal(size=(N, K, D)).astype(np.float32)
        return (user, items)
    return make, inputs, ()


def _din_case(softmax: bool):
    def make(dtype):
        jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
        cfg = dict(dnn_hidden_units=(16, 8), attention_hidden_units=(12,),
                   din_use_softmax=softmax)
        return (jheads.DINPredictor(hidden_size=D, dtype=jdt, **cfg),
                attention_heads.DINPredictor(hidden_size=D, input_dim=D,
                                             dtype=dtype, **cfg))

    def inputs(seed):
        rng = np.random.default_rng(seed)
        clicks = rng.normal(size=(N, S, D)).astype(np.float32)
        mask = (rng.random((N, S)) < 0.6).astype(np.int32)
        mask[0] = 0                  # no valid click
        mask[1] = [0, 1, 0, 1, 1, 0, 0]
        mask[2] = 1
        items = rng.normal(size=(N, K, D)).astype(np.float32)
        return ({"embedding": clicks, "mask": mask}, items)
    return make, inputs, ()


def _block_case(jmake, tmake, shape, bn_biases=()):
    def make(dtype):
        jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
        return jmake(jdt), tmake(dtype)

    def inputs(seed):
        rng = np.random.default_rng(seed)
        return (rng.normal(size=shape).astype(np.float32),)
    return make, inputs, bn_biases


CASES = {f"{p}-{i}": (lambda p=p, c=c: _head_case(p, c))
         for i, (p, c) in enumerate(CTR_HEADS)}
CASES.update({
    "DIN": lambda: _din_case(False),
    "DIN-softmax": lambda: _din_case(True),
    "MLPLayer-batch_norm": lambda: _block_case(
        lambda dt: jcommon.MLPLayer(hidden_units=(16, 12), output_dim=3,
                                    batch_norm=True, activation="gelu",
                                    dtype=dt),
        lambda dt: common.MLPLayer(D, (16, 12), 3, "gelu", batch_norm=True,
                                   dtype=dt),
        (N, K, D), bn_biases=("dense_0.bias", "dense_1.bias")),
    "Dice": lambda: _block_case(
        lambda dt: jcommon.Dice(dtype=dt),
        lambda dt: common.Dice(D, dt), (N, K, D)),
    "LRLayer": lambda: _block_case(
        lambda dt: jcommon.LRLayer(dtype=dt),
        lambda dt: common.LRLayer(D, dt), (N, K, D)),
})


def _jnp(a):
    if isinstance(a, dict):
        return {k: jnp.asarray(v) for k, v in a.items()}
    return jnp.asarray(a)


def _torch(a, grad=False):
    if isinstance(a, dict):
        return {k: _torch(v, grad) for k, v in a.items()}
    t = torch.tensor(a)
    if grad and t.is_floating_point():
        t.requires_grad_(True)
    return t


def _pair(name, dtype=torch.float32, seed=0):
    make, inputs, bn_biases = CASES[name]()
    jmod, tmod = make(dtype)
    args = inputs(seed)
    jargs = tuple(_jnp(a) for a in args)
    params = jmod.init(jax.random.PRNGKey(seed), *jargs)
    if name == "Dice":
        # alpha starts at 0: draw it, or the (1 - p) alpha x term is idle
        params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.random.default_rng(3).normal(
                size=a.shape), a.dtype), params)
    tree = jax.tree_util.tree_map(np.asarray, params)
    tmod.load_state_dict(params_from_jax(tree, tmod))
    return jmod, tmod, params, args, jargs, bn_biases


def _close(got, want, tol, what, scale=None):
    scale = max(float(np.abs(want).max()) if scale is None else scale, 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale or err <= tol, (what, err, scale)


def _leaves(args, grads):
    """(name, torch input, JAX gradient) of each float input."""
    out = []
    for i, (a, g) in enumerate(zip(args, grads)):
        if isinstance(a, dict):
            out += [(f"{i}.{k}", a[k], g[k]) for k in a
                    if a[k].is_floating_point()]
        else:
            out.append((str(i), a, g))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_forward_and_gradients_match_jax(name):
    jmod, tmod, params, args, jargs, bn_biases = _pair(name)
    want = np.asarray(jax.jit(jmod.apply)(params, *jargs))
    targs = tuple(_torch(a, grad=True) for a in args)
    out = tmod(*targs)
    assert out.shape == want.shape and out.dtype == torch.float32
    _close(out.detach().numpy(), want, FWD_TOL, "forward")

    cot = np.random.default_rng(9).normal(size=want.shape).astype(np.float32)
    (out * torch.tensor(cot)).sum().backward()

    def f(p, *a):
        return jnp.vdot(jmod.apply(p, *a), jnp.asarray(cot))

    gp, *gx = jax.jit(jax.grad(f, argnums=tuple(range(len(jargs) + 1)),
                       allow_int=True))(params, *jargs)
    want_p = params_from_jax(jax.tree_util.tree_map(np.asarray, gp), tmod)
    named = dict(tmod.named_parameters())
    assert set(named) == set(want_p)
    for pname, p in named.items():
        scale = None
        if pname in bn_biases:
            scale = float(want_p[pname[:-len("bias")] + "weight"].abs().max())
        _close(p.grad.numpy(), want_p[pname].numpy(), GRAD_TOL, pname, scale)
    for what, t, g in _leaves(targs, gx):
        _close(t.grad.numpy(), np.asarray(g, np.float32), GRAD_TOL,
               f"d{what}")


@pytest.mark.parametrize("name", list(CASES))
def test_bf16_scores_match_jax(name):
    jmod, tmod, params, args, jargs, _ = _pair(name, torch.bfloat16)
    want = np.asarray(jmod.apply(params, *jargs), np.float32)
    with torch.no_grad():
        got = tmod(*(_torch(a) for a in args)).float().numpy()
    assert got.shape == want.shape
    _close(got, want, BF16_TOL, "bf16 forward",
           scale=float(np.abs(want).max()))


def _seq(seed, cols=("title", "category"), lens=(S, 2)):
    rng = np.random.default_rng(seed)
    embs = {c: rng.normal(size=(N, n, D)).astype(np.float32)
            for c, n in zip(cols, lens)}
    masks = {c: (rng.random((N, n)) < 0.6).astype(np.int32)
             for c, n in zip(cols, lens)}
    masks[cols[0]][0] = 0
    return embs, masks


@pytest.mark.parametrize("flatten,max_pooling", [
    (False, False), (False, True), (True, False), (True, True)])
def test_pooling_matches_jax(flatten, max_pooling):
    embs, masks = _seq(1)
    jop = jpooling.PoolingOperator(hidden_size=D, input_dim=D,
                                   flatten=flatten, max_pooling=max_pooling)
    top = pooling.PoolingOperator(hidden_size=D, input_dim=D,
                                  flatten=flatten, max_pooling=max_pooling)
    want = np.asarray(jop.apply({}, _jnp(embs), _jnp(masks)))
    got = top(_torch(embs), _torch(masks)).numpy()
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)
    # one tensor instead of a dict of columns
    want = np.asarray(jop.apply({}, jnp.asarray(embs["title"]),
                                jnp.asarray(masks["title"])))
    got = top(torch.tensor(embs["title"]), torch.tensor(masks["title"]))
    np.testing.assert_allclose(got.numpy(), want, rtol=FWD_TOL, atol=FWD_TOL)
    assert top.output_dim == D and not list(top.parameters())


def test_null_and_single_column_operators_match_jax():
    embs, masks = _seq(2)
    x, m = embs["title"], masks["title"]
    out = pooling.NullConcatOperator(input_dim=D)(torch.tensor(x),
                                                  torch.tensor(m))
    assert set(out) == {"embedding", "mask"}
    assert torch.equal(out["embedding"], torch.tensor(x))
    assert not pooling.NullSimpleOperator.allow_caching
    assert not pooling.NullConcatOperator.allow_caching
    assert pooling.PoolingOperator.allow_caching
    sc = pooling.SCSimpleOperator(input_dim=D)
    jsc = jpooling.SCSimpleOperator(hidden_size=D, input_dim=D)
    for a in (embs["category"][:, :1], embs["title"]):
        want = np.asarray(jsc.apply({}, jnp.asarray(a)))
        assert np.array_equal(sc(torch.tensor(a)).numpy(), want)


def test_single_column_inputer_looks_up_one_column():
    hub = EmbeddingHub(embedding_dim=D)
    hub.register_vocab("category", 5)
    eh = hub.build()
    ids = torch.tensor([[3, -1], [0, 4]])
    inputer = SingleColumnInputer(cols=(("category", "category", 2),))
    emb, mask = inputer.get_embeddings(eh, {"category": ids})
    assert mask.tolist() == [[1, 0], [1, 1]]
    table = eh.tables["vocab__category"].detach()
    want = table[ids.clamp(min=0)] * mask[..., None]
    assert torch.equal(emb.detach(), want)
    two = SingleColumnInputer(cols=(("category", "category", 2),
                                    ("title", "category", 2)))
    with pytest.raises(ValueError, match="exactly one column"):
        two.get_embeddings(eh, {"category": ids, "title": ids})


def test_bridge_fails_loudly_on_unplaced_ctr_leaves():
    _, tmod, params, *_ = _pair("DCNv2-5")
    tree = jax.tree_util.tree_map(np.asarray, params)["params"]
    mix = tree["CrossNetMix_0"]
    extra = {**tree, "CrossNetMix_0": {**mix, "W_0": mix["U_0"]}}
    with pytest.raises(KeyError, match="no rule"):
        params_from_jax(extra, tmod)
    short = {**tree, "CrossNetMix_0": {k: v for k, v in mix.items()
                                       if k != "C_1"}}
    with pytest.raises(KeyError, match="left unset"):
        params_from_jax(short, tmod)
    assert tuple(tmod.CrossNetMix_0.U_0.shape) == (2, 2 * D, 4)


def test_ill_formed_options_raise():
    with pytest.raises(ValueError, match="model_structure"):
        cross.DCNv2Predictor(model_structure="serial")
    with pytest.raises(ValueError, match="heads"):
        finalmlp.InteractionAggregation(6, 8, num_heads=4)
    with pytest.raises(KeyError):
        common.get_activation("swish")
