"""The port's packed attention and BERT encoder slice vs the JAX package.

`reference_attention` and the CPU path of the `packed_attention` wrapper
(legommenders_tpu_torch/ops/attention.py) are held against the JAX
`packed_attention` run in interpret mode at dropout 0 and against the JAX
`reference_attention`, with plain key-validity biases and the
block-diagonal biases of packed items, at odd B and T. The packing helpers
must agree exactly, and the LoRA dense layer, the LayerNorm and a
two-layer BertEncoderSlice (D = 32, two heads) on bridged weights within
1e-5 at f32 (sums in another order), at the valid positions. LoRA runs
with a non-zero `lora_B`, so that the fold is seen.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legommenders_tpu.models.lm import layers as jlayers
from legommenders_tpu.ops.pallas_attention import (
    packed_attention as jpacked, reference_attention as jreference,
)
from legommenders_tpu_torch.bridge import params_from_jax
from legommenders_tpu_torch.models.lm import layers
from legommenders_tpu_torch.ops.attention import (
    dropout_keep_mask, packed_attention, reference_attention,
)

TOL = 1e-5
H = 2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Single-threaded torch while this module runs (the suite runs in
    parallel workers); restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(B, T, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, D)).astype(np.float32)
            for _ in range(3)]


def _plain_bias(B, T, seed):
    """Key-validity bias, broadcast over the query rows; every row keeps
    key 0."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, T + 1, B)
    valid = np.arange(T)[None] < lens[:, None]
    bias = np.where(valid, 0.0, np.finfo(np.float32).min).astype(np.float32)
    return np.ascontiguousarray(np.broadcast_to(bias[:, None], (B, T, T)))


def _packed_bias(n_items, L, seed):
    """packed_mask_bias of the JAX package over items of random lengths."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, L + 1, n_items)
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int32)
    G = jlayers.pack_group_size(L, -1)
    x = jnp.zeros((n_items, L, 4), jnp.float32)
    _, mask_p, _ = jlayers.pack_items(x, jnp.asarray(mask), G)
    bias = jlayers.packed_mask_bias(mask_p, L, jnp.float32)
    return np.array(bias[:, 0])


CASES = {
    "plain_B5_T9": lambda: (_qkv(5, 9, 32, 0), _plain_bias(5, 9, 1)),
    "plain_B3_T1": lambda: (_qkv(3, 1, 8, 2), _plain_bias(3, 1, 3)),
    # 11 items of L = 13: G = 9, so 2 packed rows of T = 117 (7 pad items)
    "packed_L13": lambda: (_qkv(2, 117, 32, 4), _packed_bias(11, 13, 5)),
    # 7 items of L = 34: G = 3, 3 packed rows of T = 102 (the main path's T)
    "packed_L34": lambda: (_qkv(3, 102, 16, 6), _packed_bias(7, 34, 7)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_and_wrapper_match_jax(case):
    (q, k, v), bias = CASES[case]()
    seed = jnp.zeros((1,), jnp.int32)
    want_kernel = np.asarray(jpacked(H, 0.0, *map(jnp.asarray, (q, k, v, bias)),
                                     seed))
    want_ref = np.asarray(jreference(H, 0.0, *map(jnp.asarray,
                                                  (q, k, v, bias))))
    tq, tk, tv, tb = map(torch.from_numpy, (q, k, v, bias))
    got_ref = reference_attention(H, 0.0, tq, tk, tv, tb).numpy()
    before = packed_attention.launches
    got = packed_attention(H, 0.0, tq, tk, tv, tb, None).numpy()
    assert packed_attention.launches == before     # no kernel on the CPU
    np.testing.assert_array_equal(got, got_ref)
    np.testing.assert_allclose(got_ref, want_kernel, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_ref, want_ref, rtol=TOL, atol=TOL)


def test_reference_bf16_rounds_like_jax():
    """bf16 q/k/v: the probabilities are rounded to bf16 before the product
    with v, and the output once; within two bf16 ulps of the JAX
    reference."""
    (q, k, v), bias = _qkv(3, 102, 16, 8), _packed_bias(7, 34, 9)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jreference(H, 0.0, jq, jk, jv,
                                 jnp.asarray(bias, jnp.bfloat16)),
                      np.float32)
    tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
                  for a in (jq, jk, jv))
    got = reference_attention(H, 0.0, tq, tk, tv,
                              torch.from_numpy(bias).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=2 ** -7)


def test_wrapper_refuses_dropout_and_other_devices():
    """Dropout needs a seed and a rate in [0, 1) (with both it runs: the
    CPU path applies the keep mask the seed draws); a tensor on neither
    the CPU nor the card is refused."""
    (q, k, v), bias = _qkv(2, 5, 8, 10), _plain_bias(2, 5, 11)
    tq, tk, tv, tb = map(torch.from_numpy, (q, k, v, bias))
    with pytest.raises(ValueError, match="needs a seed"):
        packed_attention(H, 0.1, tq, tk, tv, tb)
    with pytest.raises(ValueError, match="not in"):
        packed_attention(H, 1.0, tq, tk, tv, tb,
                         torch.zeros(1, dtype=torch.int32))
    seed = torch.tensor([5], dtype=torch.int32)
    keep = dropout_keep_mask(H, 0.1, 2, 5, seed)
    np.testing.assert_array_equal(
        packed_attention(H, 0.1, tq, tk, tv, tb, seed).numpy(),
        reference_attention(H, 0.1, tq, tk, tv, tb, keep).numpy())
    with pytest.raises(ValueError, match="unsupported device"):
        packed_attention(H, 0.0, tq.to("meta"), tk.to("meta"),
                         tv.to("meta"), tb.to("meta"))


@pytest.mark.parametrize("n_items,L,requested", [(7, 12, -1), (9, 34, -1),
                                                 (5, 8, 2), (4, 40, 0)])
def test_packing_matches_jax(n_items, L, requested):
    rng = np.random.default_rng(n_items + L)
    x = rng.standard_normal((n_items, L, 4)).astype(np.float32)
    lens = rng.integers(1, L + 1, n_items)
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int32)
    G = layers.pack_group_size(L, requested)
    assert G == jlayers.pack_group_size(L, requested)
    jx, jm, jpad = jlayers.pack_items(jnp.asarray(x), jnp.asarray(mask), G)
    tx, tm, tpad = layers.pack_items(torch.from_numpy(x),
                                     torch.from_numpy(mask), G)
    assert tpad == jpad
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    for dtype, tdtype in ((jnp.float32, torch.float32),
                          (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jlayers.packed_mask_bias(jm, L, dtype), np.float32)
        got = layers.packed_mask_bias(tm, L, tdtype)
        assert got.dtype == tdtype
        np.testing.assert_array_equal(got.float().numpy(), want)


def _nonzero_lora(tree, seed):
    """The tree with every lora_B drawn from N(0, 0.05) instead of the
    init's zeros."""
    rng = np.random.default_rng(seed)

    def walk(t):
        return {k: (walk(v) if isinstance(v, dict) else
                    (rng.normal(0, 0.05, np.shape(v)).astype(np.float32)
                     if k == "lora_B" else np.asarray(v)))
                for k, v in t.items()}
    return walk(tree)


@pytest.mark.parametrize("fold", [False, True])
def test_lora_dense_matches_jax(fold):
    rng = np.random.default_rng(12)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    jmod = jlayers.LoRADense(24, lora_r=4, lora_fold=fold)
    tree = _nonzero_lora(jax.tree_util.tree_map(
        np.asarray, jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))), 1)
    want = np.asarray(jmod.apply(tree, jnp.asarray(x)))
    tmod = layers.LoRADense(16, 24, lora_r=4, lora_fold=fold)
    tmod.load_state_dict(params_from_jax(tree, tmod))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bf16_apply", [False, True])
def test_layer_norm_matches_jax(bf16_apply):
    rng = np.random.default_rng(13)
    x = (rng.standard_normal((4, 6, 32)) * 3 + 1).astype(np.float32)
    dtype, tdtype = ((jnp.bfloat16, torch.bfloat16) if bf16_apply
                     else (jnp.float32, torch.float32))
    jmod = jlayers.FrozenableLayerNorm(bf16_apply=bf16_apply, dtype=dtype)
    tree = {"params": {"scale": rng.normal(1, 0.1, 32).astype(np.float32),
                       "bias": rng.normal(0, 0.1, 32).astype(np.float32)}}
    want = np.asarray(jmod.apply(tree, jnp.asarray(x)), np.float32)
    tmod = layers.FrozenableLayerNorm(32, bf16_apply=bf16_apply,
                                      dtype=tdtype)
    tmod.load_state_dict(params_from_jax(tree, tmod))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert got.dtype == tdtype
    tol = TOL if not bf16_apply else 2 ** -6
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


# (fused_attention, attention_pack, gelu_approximate, lora_fold): every value
# of each knob, the four fused/pack pairs
SLICE_CASES = [(True, -1, True, True), (True, 0, False, False),
               (False, -1, False, True), (False, 0, True, False)]


@pytest.mark.parametrize("fused,pack,gelu_approx,fold", SLICE_CASES)
def test_bert_slice_matches_jax(fused, pack, gelu_approx, fold):
    """7 items of L = 12 (G = 10 when packed: 3 pad items), D = 32, two
    heads, two layers, LoRA r = 4 on query/value with a non-zero lora_B."""
    rng = np.random.default_rng(14)
    B, L, D = 7, 12, 32
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    lens = rng.integers(1, L + 1, B)
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int32)
    kw = dict(num_layers=2, num_heads=H, lora_r=4, lora_dropout=0.0,
              gelu_approximate=gelu_approx, attention_pack=pack,
              fused_attention=fused, lora_fold=fold)
    jmod = jlayers.BertEncoderSlice(max_position=64, **kw)
    jx, jm = jnp.asarray(x), jnp.asarray(mask)
    tree = _nonzero_lora(jax.tree_util.tree_map(
        np.asarray, jmod.init(jax.random.PRNGKey(2), jx, jm, False)), 3)
    want = np.asarray(jax.jit(lambda p, a, m: jmod.apply(p, a, m, False))(
        tree, jx, jm))
    tmod = layers.BertEncoderSlice(dim=D, max_position=64, **kw)
    tmod.load_state_dict(params_from_jax(tree, tmod))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (B, L, D)
    valid = mask.astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], rtol=TOL, atol=TOL)


def test_unported_knobs_raise():
    # fused_qkv (tests/test_torch_lm_knobs.py) and pipeline_stages
    # (tests/test_torch_pp.py) are ported: they build; what JAX refuses
    # raises: a stack that does not divide into the stages, and IISAN's
    # collect_pooled (tests/test_torch_iisan.py) staged under a pp mesh
    from legommenders_tpu_torch.parallel import mesh as tmesh

    assert layers.BertEncoderSlice(num_layers=1, dim=8, num_heads=2,
                                   fused_qkv=True).layer_0.attention.fused_qkv
    x, mask = torch.zeros(2, 3, 8), torch.ones(2, 3)
    odd = layers.BertEncoderSlice(num_layers=1, dim=8, num_heads=2,
                                  embed=False, fused_qkv=True,
                                  pipeline_stages=2)
    assert odd.pipeline_stages == 2
    assert odd(x, mask).shape == x.shape  # no pp mesh: the serial stack
    pooled = layers.BertEncoderSlice(num_layers=2, dim=8, num_heads=2,
                                     embed=False, pipeline_stages=2,
                                     collect_pooled=True)
    # the decoder slices are ported (tests/test_torch_decoder.py); their
    # stages divide their stack as BERT's do
    llama = layers.LlamaDecoderSlice(num_layers=1, dim=8, num_heads=2,
                                     pipeline_stages=2, dtype=torch.float32)
    opt = layers.OPTDecoderSlice(num_layers=1, dim=8, num_heads=2,
                                 fused_qkv=True, collect_pooled=True,
                                 pipeline_stages=2, dtype=torch.float32)
    with tmesh.pipeline_parallel(tmesh.Mesh(1, 0, pp=2)):
        for sl in (odd, llama):
            with pytest.raises(ValueError, match="num_layers 1 % pipeline"):
                sl(x, mask)
        for sl in (pooled, opt):
            with pytest.raises(ValueError, match="IISAN pooled collection"):
                sl(x, mask)
