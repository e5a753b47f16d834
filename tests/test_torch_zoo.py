"""The news zoo's operators and heads in the port vs the JAX package, on
the CPU, module by module on bridged weights.

Each new module (MultiHeadSelfAttention in its NRMS and AutoInt forms,
AttentionOperator, CNNCatOperator, GRUOperator at 1 and 2 layers,
FastformerOperator, TransformerOperator, PolyAttentionOperator and
MINERPredictor with each score type) is built in both packages at a small
geometry (D 16, 2 heads, 2 layers), JAX's parameters are initialised from
a seed and bridged, and the same numpy inputs (a mask that is not a
prefix, one row with no valid position) go through both, at f32 and
dropout 0:
  * forward within 1e-5 (absolute and relative);
  * the gradient of sum(out * cotangent) in every parameter and the input
    within 1e-4 of each tensor's largest value.
Besides: the GRU's carry is taken after mask.sum() steps wherever the
ones are, an empty history gives the carry after one step; the bridge
fails loudly on a GRU leaf it cannot place and on one it leaves unset;
the multi-device and ill-formed options raise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legommenders_tpu.models import common as jcommon
from legommenders_tpu.models.operators import attention as jattention
from legommenders_tpu.models.operators import cnn as jcnn
from legommenders_tpu.models.operators import fastformer as jfastformer
from legommenders_tpu.models.operators import gru as jgru
from legommenders_tpu.models.operators import poly as jpoly
from legommenders_tpu.models.operators import transformer as jtransformer
from legommenders_tpu.models.predictors import attention_heads as jheads
from legommenders_tpu_torch.bridge import params_from_jax
from legommenders_tpu_torch.models import common
from legommenders_tpu_torch.models.operators import (
    attention, cnn, fastformer, gru, poly, transformer,
)
from legommenders_tpu_torch.models.predictors import attention_heads

N, L, D = 6, 7, 16
FWD_TOL, GRAD_TOL = 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, n=N, length=L, dim=D):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, length, dim)).astype(np.float32)
    mask = (rng.random((n, length)) < 0.6).astype(np.int32)
    mask[0] = 0                      # no valid position
    mask[1] = [0, 1, 0, 1, 1, 0, 0][:length] + [0] * max(0, length - 7)
    mask[2] = 1
    return x, mask


# name -> (JAX module, port module, a function making the inputs)
def _seq_case(jmod, tmod):
    def inputs(seed):
        x, mask = _inputs(seed)
        return (x, mask), (x, mask)
    return jmod, tmod, inputs


def _cnncat_case():
    cols = (("title", "word", L), ("category", "category", 1))
    jmod = jcnn.CNNCatOperator(hidden_size=12, input_dim=D, dropout=0.0,
                               additive_hidden_size=32, num_cols=2)
    tmod = cnn.CNNCatOperator(hidden_size=12, input_dim=D, dropout=0.0,
                              additive_hidden_size=32, num_cols=2, cols=cols)

    def inputs(seed):
        x, mask = _inputs(seed)
        c, cm = _inputs(seed + 1, length=1)
        cm[:] = 1
        embs = {"title": x, "category": c}
        masks = {"title": mask, "category": cm}
        return (embs, masks), (embs, masks)
    return jmod, tmod, inputs


def _miner_case(score_type):
    jmod = jheads.MINERPredictor(hidden_size=D, score_type=score_type)
    tmod = attention_heads.MINERPredictor(hidden_size=D, input_dim=D,
                                          score_type=score_type)

    def inputs(seed):
        rng = np.random.default_rng(seed)
        user = rng.normal(size=(N, 4, D)).astype(np.float32)
        items = rng.normal(size=(N, 5, D)).astype(np.float32)
        return (user, items), (user, items)
    return jmod, tmod, inputs


CASES = {
    "mhsa": lambda: _seq_case(
        jcommon.MultiHeadSelfAttention(num_heads=2),
        common.MultiHeadSelfAttention(D, num_heads=2)),
    "mhsa_autoint": lambda: _seq_case(
        jcommon.MultiHeadSelfAttention(
            num_heads=2, attention_dim=24, use_residual=True,
            use_scale=False, layer_norm=True, relu_out=True, out_proj=False),
        common.MultiHeadSelfAttention(
            D, num_heads=2, attention_dim=24, use_residual=True,
            use_scale=False, layer_norm=True, relu_out=True, out_proj=False)),
    "attention": lambda: _seq_case(
        jattention.AttentionOperator(hidden_size=12, input_dim=D,
                                     num_attention_heads=2,
                                     attention_dropout=0.0,
                                     additive_hidden_size=32),
        attention.AttentionOperator(hidden_size=12, input_dim=D,
                                    num_attention_heads=2,
                                    attention_dropout=0.0,
                                    additive_hidden_size=32)),
    "cnncat": _cnncat_case,
    "gru_1": lambda: _seq_case(
        jgru.GRUOperator(hidden_size=12, input_dim=D, num_layers=1),
        gru.GRUOperator(hidden_size=12, input_dim=D, num_layers=1)),
    "gru_2": lambda: _seq_case(
        jgru.GRUOperator(hidden_size=12, input_dim=D, num_layers=2),
        gru.GRUOperator(hidden_size=12, input_dim=D, num_layers=2)),
    "fastformer": lambda: _seq_case(
        jfastformer.FastformerOperator(hidden_size=12, input_dim=D,
                                       num_hidden_layers=2,
                                       num_attention_heads=2,
                                       hidden_dropout_prob=0.0),
        fastformer.FastformerOperator(hidden_size=12, input_dim=D,
                                      num_hidden_layers=2,
                                      num_attention_heads=2,
                                      hidden_dropout_prob=0.0)),
    "transformer": lambda: _seq_case(
        jtransformer.TransformerOperator(hidden_size=12, input_dim=D,
                                         num_attention_heads=2,
                                         attention_dropout=0.0,
                                         num_hidden_layers=2),
        transformer.TransformerOperator(hidden_size=12, input_dim=D,
                                        num_attention_heads=2,
                                        attention_dropout=0.0,
                                        num_hidden_layers=2)),
    "poly": lambda: _seq_case(
        jpoly.PolyAttentionOperator(hidden_size=D, input_dim=D,
                                    num_context_codes=4, context_code_dim=8),
        poly.PolyAttentionOperator(hidden_size=D, input_dim=D,
                                   num_context_codes=4, context_code_dim=8)),
    "miner_weighted": lambda: _miner_case("weighted"),
    "miner_max": lambda: _miner_case("max"),
    "miner_mean": lambda: _miner_case("mean"),
}


def _to_torch(a, grad=False):
    if isinstance(a, dict):
        return {k: _to_torch(v, grad) for k, v in a.items()}
    t = torch.tensor(a)
    if grad and t.is_floating_point():
        t.requires_grad_(True)
    return t


def _ordered(args, like):
    """args with each dict in the key order of its twin in `like`: jit and
    grad hand dicts back key-sorted, and CNNCat concatenates its columns
    in the order it is given them."""
    return tuple({k: a[k] for k in b} if isinstance(b, dict) else a
                 for a, b in zip(args, like))


def _pair(name, seed=0):
    jmod, tmod, inputs = CASES[name]()
    jargs, targs = inputs(seed)
    # (a dict keeps its order: tree_map would sort CNNCat's columns)
    jargs = tuple({k: jnp.asarray(v) for k, v in a.items()}
                  if isinstance(a, dict) else jnp.asarray(a) for a in jargs)
    params = jax.jit(lambda k, *a: jmod.init(k, *_ordered(a, jargs)))(
        jax.random.PRNGKey(seed), *jargs)
    tree = jax.tree_util.tree_map(np.asarray, params)
    tmod.load_state_dict(params_from_jax(tree, tmod))
    return jmod, tmod, params, jargs, targs


def _close(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale or err <= tol, (what, err, scale)


@pytest.mark.parametrize("name", list(CASES))
def test_forward_and_gradients_match_jax(name):
    jmod, tmod, params, jargs, targs = _pair(name)
    want = np.asarray(jax.jit(lambda p, *a: jmod.apply(
        p, *_ordered(a, jargs)))(params, *jargs))
    targs = tuple(_to_torch(a, grad=i == 0) for i, a in enumerate(targs))
    out = tmod(*targs)
    assert out.shape == want.shape and out.dtype == torch.float32
    _close(out.detach().numpy(), want, FWD_TOL, "forward")

    cot = np.random.default_rng(9).normal(size=want.shape).astype(np.float32)
    (out * torch.tensor(cot)).sum().backward()

    def f(p, first):
        args = _ordered((first,) + tuple(jargs[1:]), jargs)
        return jnp.vdot(jmod.apply(p, *args), jnp.asarray(cot))

    gp, gx = jax.jit(jax.grad(f, argnums=(0, 1)))(params, jargs[0])
    want_p = params_from_jax(jax.tree_util.tree_map(np.asarray, gp), tmod)
    for pname, p in tmod.named_parameters():
        _close(p.grad.numpy(), want_p[pname].numpy(), GRAD_TOL, pname)
    gx = gx if isinstance(gx, dict) else {"x": gx}
    tx = targs[0] if isinstance(targs[0], dict) else {"x": targs[0]}
    for k, t in tx.items():
        _close(t.grad.numpy(), np.asarray(gx[k]), GRAD_TOL, f"d{k}")


def test_gru_carry_counts_the_mask_and_an_empty_history():
    """The carry after mask.sum() steps, wherever the ones are; an empty
    history gives the carry after one step (flax clamps lengths to 1)."""
    _, tmod, _, _, (x, mask) = _pair("gru_2")
    xt, mt = torch.tensor(x), torch.tensor(mask)
    with torch.no_grad():
        out = tmod(xt, mt)
        lengths = [int(max(m.sum(), 1)) for m in mask]
        for i, n in enumerate(lengths):
            prefix = torch.ones(1, n, dtype=torch.int32)
            want = tmod(xt[i:i + 1, :n], prefix)
            assert torch.allclose(out[i], want[0], atol=1e-6), (i, n)
        assert lengths[0] == 1 and lengths[1] == 3


def test_gru_bridge_fails_loudly_on_unplaced_leaves():
    _, tmod, params, _, _ = _pair("gru_1")
    tree = jax.tree_util.tree_map(np.asarray, params)["params"]
    extra = {**tree, "GRUCell_0": {**tree["GRUCell_0"], "hr": {
        **tree["GRUCell_0"]["hr"], "bias": np.zeros(12, np.float32)}}}
    with pytest.raises(KeyError, match="does not have"):
        params_from_jax(extra, tmod)
    short = {**tree, "GRUCell_0": {k: v for k, v in tree["GRUCell_0"].items()
                                   if k != "hn"}}
    with pytest.raises(KeyError, match="left unset"):
        params_from_jax(short, tmod)
    assert "GRUCell_0.in.weight" in dict(tmod.named_parameters())
    assert "GRUCell_0.hr.bias" not in dict(tmod.named_parameters())


@pytest.mark.parametrize("make", [
    lambda: (common.MultiHeadSelfAttention(6, 3, sequence_parallel=True),
             torch.zeros(2, 4, 6), "named axis sp"),
    lambda: (transformer.TransformerOperator(sequence_parallel=True),
             torch.zeros(2, 5, 64), "not evenly divisible"),
    lambda: (fastformer.FastformerOperator(sequence_parallel=True),
             torch.zeros(2, 5, 64), "not evenly divisible"),
], ids=["mhsa", "transformer", "fastformer"])
def test_sequence_parallel_raises(make):
    """sequence_parallel is ported (tests/test_torch_sp.py): the modules
    build, and under an sp mesh of 2 JAX's refusals raise: Ulysses' heads
    that do not divide over sp, a sequence that does not."""
    from legommenders_tpu_torch.parallel import mesh as tmesh

    module, x, message = make()
    with tmesh.sequence_parallel(tmesh.Mesh(1, 0, sp=2)):
        with pytest.raises(ValueError, match=message):
            module(x, torch.ones(x.shape[:2]))


def test_ill_formed_options_raise():
    with pytest.raises(ValueError, match="heads"):
        common.MultiHeadSelfAttention(D, num_heads=3)
    with pytest.raises(ValueError, match="score_type"):
        attention_heads.MINERPredictor(score_type="sum")
    with pytest.raises(ValueError, match="cols"):
        cnn.CNNCatOperator(num_cols=2)
