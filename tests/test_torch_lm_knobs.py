"""The LM knobs in the port vs the JAX package: the `ffn` and `dots` page
remat policies, `fused_qkv`, and what still raises (`pipeline_stages`).

Remat: bert-naml in layer-split mode (tests/test_torch_lm_train.py's
small configuration: 2 layers, D 32, tune_from 1, LoRA r 4 folded with a
non-zero lora_B) paged in pages of 24 over a 60-item catalog (3 pages, the
last re-encoding its tail), at f32:
  * `full`, `ffn`, `dots` and `none` give one loss (1e-6) and one gradient
    for every trainable tensor (1e-5 of its largest value), at dropout 0
    and at dropout 0.1 from one step seed (the recompute draws the masks
    of its forward);
  * the port's loss and gradients under each policy against JAX's under
    `ffn` and `dots` (JAX's test_ffn_remat_policy_grad_parity and
    test_remat_policies_grad_equivalent setups), 1e-5 relative loss and
    1e-4 of each tensor's largest gradient;
  * what each policy saves: the matrix products the backward runs (a
    TorchDispatchMode over `legommender.DOT_OPS`): `full` recomputes every
    product of a page, `ffn` one fewer per trainable layer and page (the
    FFN output, `ffn_dense`), `dots` none (as many as `none`);
  * `ffn`'s FFNStash against a selective checkpoint keeping `ffn_dense`:
    the same loss, gradients and backward products;
fused_qkv: JAX's five test_fused_qkv_parity families (bert, bert-lora,
llama, glm with GQA and qkv biases, opt) on bridged weights with a
non-zero lora_B: the fused port against the unfused port (1e-5) and
against JAX's fused slice (1e-5), the bert-lora gradients against
jax.grad (1e-4 of the largest), the lora_fold form, and a mixed use_bias
raising as JAX asserts.
"""
import copy
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import (
    CheckpointPolicy, create_selective_checkpoint_contexts,
)

from legommenders_tpu.models.lm import layers as jlayers
from legommenders_tpu.runtime import steps as jsteps
from legommenders_tpu_torch.bridge import params_from_jax
from legommenders_tpu_torch.data.processors.synthetic import SyntheticProcessor
from legommenders_tpu_torch.models import legommender
from legommenders_tpu_torch.models.legommender import DOT_OPS
from legommenders_tpu_torch.models.lm import layers
from legommenders_tpu_torch.models.lm.remat import FFN_DENSE_OP
from legommenders_tpu_torch.runtime import steps
from legommenders_tpu_torch.runtime.manager import Manager

from test_torch_lm_train import (  # noqa: E402
    DATA_KW, _batches, _build, _loss_and_grads, bert_cfg,
)

POLICIES = ("full", "ffn", "dots", "none")
PAGE = 24


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def paged(tmp_path_factory):
    return _build(bert_cfg(item_page_size=PAGE, item_page_remat="ffn"),
                  tmp_path_factory.mktemp("cache"), lm=True)


class GemmCount(TorchDispatchMode):
    """Counts the matrix products dispatched while it is on."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in DOT_OPS
        return func(*args, **(kwargs or {}))


def _policy_run(model, contents, batch, seed):
    """(loss, gradients, matrix products run by the backward)."""
    model.zero_grad(set_to_none=True)
    loss = steps.make_loss_fn(model, contents, True)(
        batch, torch.Generator().manual_seed(seed))
    count = GemmCount()
    with count:
        loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads, count.n


def _assert_same(got, want):
    assert abs(got[0] - want[0]) <= 1e-6
    assert got[1].keys() == want[1].keys()
    for n, w in want[1].items():
        scale = max(w.abs().max().item(), 1e-6)
        assert (got[1][n] - w).abs().max().item() <= 1e-5 * scale, n


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_remat_policies_agree_and_save_what_they_say(dropout):
    tm = Manager(model_cfg=bert_cfg(dropout=dropout, item_page_size=PAGE),
                 data=SyntheticProcessor(**DATA_KW).as_lego_data(),
                 device="cpu", seed=3)
    assert tm.prepare_lm_cache(root=None)
    with torch.no_grad():
        for m in tm.model.modules():
            if hasattr(m, "lora_B"):
                m.lora_B.normal_(0.0, 0.05)
    (bt, _), = _batches(tm, 1)
    runs = {}
    for policy in POLICIES:
        tm.model.item_page_remat = policy
        runs[policy] = _policy_run(tm.model, tm.contents.columns, bt, 5)
    for policy in POLICIES[:-1]:
        _assert_same(runs[policy], runs["none"])
    pages = -(-DATA_KW["num_items"] // PAGE)
    upper = 1
    gemms = {p: r[2] for p, r in runs.items()}
    assert gemms["full"] > gemms["ffn"] > gemms["dots"]
    assert gemms["full"] - gemms["ffn"] == upper * pages, gemms
    assert gemms["dots"] == gemms["none"], gemms
    if dropout:
        other = _policy_run(tm.model, tm.contents.columns, bt, 6)
        assert other[0] != runs["none"][0]


def test_ffn_stash_saves_what_a_selective_checkpoint_would():
    """`ffn` keeps its outputs in a per-page FFNStash; a selective
    checkpoint whose policy keeps `ffn_dense`'s outputs (what
    tools/ffn_remat_ab.py times against it) gives the same loss, the same
    gradients and the same products in the backward, at dropout 0.1."""
    tm = Manager(model_cfg=bert_cfg(dropout=0.1, item_page_size=PAGE),
                 data=SyntheticProcessor(**DATA_KW).as_lego_data(),
                 device="cpu", seed=3)
    assert tm.prepare_lm_cache(root=None)
    with torch.no_grad():
        for m in tm.model.modules():
            if hasattr(m, "lora_B"):
                m.lora_B.normal_(0.0, 0.05)
    (bt, _), = _batches(tm, 1)
    tm.model.item_page_remat = "ffn"
    stash = _policy_run(tm.model, tm.contents.columns, bt, 5)

    def keep_ffn(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op == FFN_DENSE_OP
                else CheckpointPolicy.PREFER_RECOMPUTE)
    with mock.patch.dict(legommender.PAGE_CONTEXTS, {"ffn": functools.partial(
            create_selective_checkpoint_contexts, keep_ffn)}):
        selective = _policy_run(tm.model, tm.contents.columns, bt, 5)
    _assert_same(stash, selective)
    assert stash[2] == selective[2]


@pytest.mark.parametrize("jpolicy", ["ffn", "dots"])
def test_remat_policies_match_jax(paged, jpolicy):
    jm, tm, params = paged["jm"], paged["tm"], paged["params"]
    jmodel = jm.model.clone(item_page_remat=jpolicy)
    (bt, bj), = _batches(tm, 1)
    loss_fn = jsteps.make_loss_fn(jmodel, jm.contents.columns, True)
    want_loss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(
        params, bj, jax.random.PRNGKey(0))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads),
                           tm.model)
    model = copy.deepcopy(tm.model)
    for policy in POLICIES:
        model.item_page_remat = policy
        loss, grads = _loss_and_grads(model, tm.contents.columns, bt, 0)
        assert abs(loss - float(want_loss)) <= 1e-5 * abs(float(want_loss))
        for name, g in grads.items():
            w = want[name].numpy()
            scale = max(float(np.abs(w).max()), 1e-6)
            err = float(np.abs(g.numpy() - w).max())
            assert err <= 1e-4 * scale, (policy, name, err, scale)
        assert len(grads) == 4 + 2 + 3 + 3


def test_unknown_policy_raises():
    cfg = bert_cfg(item_page_size=PAGE, item_page_remat="some")
    with pytest.raises(ValueError, match="item_page_remat"):
        Manager(model_cfg=cfg, data=SyntheticProcessor(**DATA_KW)
                .as_lego_data(), device="cpu")


# --------------------------------------------------------------------- #
# fused_qkv                                                             #
# --------------------------------------------------------------------- #
B, L, D = 5, 9, 32
FAMILIES = {
    "bert": ("bert", dict(num_layers=2, num_heads=2, embed=True,
                          dropout=0.0)),
    "bert-lora": ("bert", dict(num_layers=2, num_heads=2, embed=False,
                               dropout=0.0, lora_r=2, freeze_base=True)),
    "llama": ("llama", dict(num_layers=2, num_heads=2)),
    "glm": ("llama", dict(num_layers=2, num_heads=4, num_kv_heads=2,
                          qkv_bias=True, rotary_fraction=0.5,
                          rotary_interleaved=True)),
    "opt": ("opt", dict(num_layers=2, num_heads=2, embed_positions=False)),
}


def _inputs():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    lens = rng.integers(1, L + 1, B)
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int32)
    return x, mask


def _nonzero_lora(tree, rng):
    return {k: (_nonzero_lora(v, rng) if isinstance(v, dict) else
                (rng.normal(0, 0.05, np.shape(v)).astype(np.float32)
                 if k == "lora_B" else np.asarray(v)))
            for k, v in tree.items()}


def _slices(family, **extra):
    kind, kw = FAMILIES[family]
    kw = dict(kw, **extra)
    if kind == "bert":
        return (jlayers.BertEncoderSlice(max_position=64, **kw),
                lambda **k: layers.BertEncoderSlice(dim=D, max_position=64,
                                                    **kw, **k))
    if kind == "llama":
        return (jlayers.LlamaDecoderSlice(intermediate_size=48,
                                          dtype=jnp.float32, **kw),
                lambda **k: layers.LlamaDecoderSlice(
                    dim=D, intermediate_size=48, dtype=torch.float32, **kw,
                    **k))
    return (jlayers.OPTDecoderSlice(max_position=64, dtype=jnp.float32, **kw),
            lambda **k: layers.OPTDecoderSlice(dim=D, max_position=64,
                                               dtype=torch.float32, **kw,
                                               **k))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_fused_qkv_parity(family):
    x, mask = _inputs()
    jbase, make = _slices(family)
    jfused = jbase.clone(fused_qkv=True)
    jx, jm = jnp.asarray(x), jnp.asarray(mask)
    tree = _nonzero_lora(jax.tree_util.tree_map(
        np.asarray, jbase.init(jax.random.PRNGKey(0), jx, jm, False)),
        np.random.default_rng(1))
    # JAX's fused slice declares the same tree
    assert (jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, jfused.init(
            jax.random.PRNGKey(0), jx, jm, False))))
    want = np.asarray(jfused.apply(tree, jx, jm, False))
    unfused, fused = make(), make(fused_qkv=True)
    sd = params_from_jax(tree, unfused)
    unfused.load_state_dict(sd)
    fused.load_state_dict(sd)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    with torch.no_grad():
        got_u = unfused(xt, mt).numpy()
        got_f = fused(xt, mt).numpy()
    valid = mask.astype(bool)
    np.testing.assert_allclose(got_f[valid], got_u[valid], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_f[valid], want[valid], rtol=1e-5,
                               atol=1e-5)
    if family != "bert-lora":
        return
    # gradients of a random projection of the valid outputs (a sum of
    # squares after a LayerNorm is constant): the frozen base gets none,
    # LoRA A and B get JAX's
    r = np.random.default_rng(4).standard_normal(x.shape).astype(
        np.float32) * mask[..., None]

    def jloss(p):
        return jnp.sum(jfused.apply(p, jx, jm, False) * r)
    jgrads = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax.grad(jloss)(tree)), fused)
    loss = (fused(xt, mt) * torch.from_numpy(r)).sum()
    loss.backward()
    n = 0
    for name, p in fused.named_parameters():
        w = jgrads[name].numpy()
        if not p.requires_grad:
            assert p.grad is None and not np.any(w), name
            continue
        n += 1
        scale = max(float(np.abs(w).max()), 1e-6)
        assert float(np.abs(p.grad.numpy() - w).max()) <= 1e-4 * scale, name
    assert n == 2 * 4      # lora_A and lora_B of query and value, 2 layers


@pytest.mark.parametrize("family", ["bert-lora", "glm"])
def test_fused_qkv_lora_fold(family):
    """With lora_fold each delta is folded into its block before the
    concatenation: the fused slice equals the unfused folded one."""
    x, mask = _inputs()
    extra = {"lora_r": 2, "freeze_base": True} if family == "glm" else {}
    jbase, make = _slices(family, **extra)
    jx, jm = jnp.asarray(x), jnp.asarray(mask)
    tree = _nonzero_lora(jax.tree_util.tree_map(
        np.asarray, jbase.init(jax.random.PRNGKey(0), jx, jm, False)),
        np.random.default_rng(2))
    want = np.asarray(jbase.clone(fused_qkv=True, lora_fold=True).apply(
        tree, jx, jm, False))
    unfused, fused = make(lora_fold=True), make(lora_fold=True,
                                                fused_qkv=True)
    sd = params_from_jax(tree, unfused)
    unfused.load_state_dict(sd)
    fused.load_state_dict(sd)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    with torch.no_grad():
        got_u, got_f = unfused(xt, mt).numpy(), fused(xt, mt).numpy()
    valid = mask.astype(bool)
    np.testing.assert_allclose(got_f[valid], got_u[valid], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_f[valid], want[valid], rtol=1e-5,
                               atol=1e-5)
    # the LoRA factors stay trainable through the fold
    loss = (fused(xt, mt) ** 2).sum()
    loss.backward()
    assert all(p.grad is not None for n, p in fused.named_parameters()
               if "lora_B" in n)


def test_fused_qkv_mixed_bias_raises():
    layer = layers.LlamaDecoderLayer(D, 2, fused_qkv=True, qkv_bias=True)
    layer.k_proj.bias = None
    with pytest.raises(ValueError, match="use_bias"):
        layer(torch.zeros(1, 3, D), torch.zeros(1, 1, 3, 3))


def test_fused_qkv_keeps_its_frozen_concatenation():
    """Without a gradient the concatenated weights are made once per state
    of the parameters and kept; with trainable LoRA factors folded in they
    are made on every call."""
    attn = layers.BertSelfAttention(D, 2, lora_r=2, freeze_base=True,
                                    fused_qkv=True)
    x = torch.randn(2, 4, D)
    bias = torch.zeros(2, 1, 1, 4)
    with torch.no_grad():
        attn(x, bias)
        kept = attn._cast_cache[1][0]
        attn(x, bias)
        assert attn._cast_cache[1][0] is kept
    assert kept.shape == (3 * D, D)


@pytest.mark.parametrize("cls", [layers.BertEncoderSlice,
                                 layers.LlamaDecoderSlice,
                                 layers.OPTDecoderSlice])
def test_pipeline_stages_raises(cls):
    """pipeline_stages is ported (tests/test_torch_pp.py) and builds with
    the knobs; JAX's refusals raise: a stack that does not divide into
    the stages, and collect_pooled staged under a pp mesh."""
    from legommenders_tpu_torch.parallel import mesh as tmesh

    x, mask = torch.zeros(2, 3, 8), torch.ones(2, 3)
    for knob in (dict(pipeline_stages=2),
                 dict(pipeline_stages=2, fused_qkv=True)):
        assert cls(num_layers=2, dim=8, num_heads=2,
                   **knob).pipeline_stages == 2
        odd = cls(num_layers=3, dim=8, num_heads=2, dtype=torch.float32,
                  **knob)
        with tmesh.pipeline_parallel(tmesh.Mesh(1, 0, pp=2)):
            with pytest.raises(ValueError, match="num_layers 3 % pipeline"):
                odd(x, mask)
    pooled = cls(num_layers=2, dim=8, num_heads=2, pipeline_stages=2,
                 collect_pooled=True, dtype=torch.float32)
    with tmesh.pipeline_parallel(tmesh.Mesh(1, 0, pp=2)):
        with pytest.raises(ValueError, match="IISAN pooled collection"):
            pooled(x, mask)
