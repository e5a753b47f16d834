"""The decoder slices in the port vs the JAX package: Llama, Llama with
grouped-query attention, Llama3's rope theta, the GLM geometry and OPT.

Each slice is the JAX package's models/lm/layers.py module (LlamaDecoderSlice
/ OPTDecoderSlice) and the port's, at a small size (2 layers, D 32, a
SwiGLU of 48), over 7 items of 9 tokens with random valid lengths (valid
tokens first), on bridged weights with a non-zero LoRA B:
  * full mode (layers 0-1 from start 0, no LoRA) and a layer-split upper
    slice (layer 1, LoRA r 4 on q and v, frozen base, final norm), with
    packing off and auto (7 items of 9 -> 14 per call, causal
    block-diagonal bias, rotary positions restarting per item) and the
    fused attention on and off: f32 outputs within 1e-5 at the valid
    positions;
  * gradients of a loss over the valid positions with respect to every
    trainable tensor and the input, against jax.grad, within 1e-4 of each
    tensor's largest value;
  * bf16 (the card's dtype) within 2e-2 of the largest output;
  * the pieces: RMSNorm's rounding (f32 out without bf16_apply, `dtype`
    with it), both rotary forms and their tiling, the causal packed bias
    (exactly JAX's), OPT's learned positions; the knobs that are not
    ported raise.
JAX's fused attention runs as its own tests run it off the TPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legommenders_tpu.models.lm import layers as jlayers
from legommenders_tpu_torch.bridge import params_from_jax
from legommenders_tpu_torch.models.lm import layers

B, L, D = 7, 9, 32
FAMILIES = {
    "llama": dict(num_heads=2),
    "llama_gqa": dict(num_heads=4, num_kv_heads=2),
    "llama3": dict(num_heads=2, rope_theta=500000.0),
    "glm": dict(num_heads=4, num_kv_heads=2, qkv_bias=True,
                rotary_fraction=0.5, rotary_interleaved=True),
    "opt": dict(num_heads=2),
}
MODES = {"full": dict(start=0, num_layers=2),
         "upper": dict(start=1, num_layers=1, lora_r=4, freeze_base=True)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    lens = rng.integers(1, L + 1, B)
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int32)
    return x, mask


def _nonzero_lora(tree, rng):
    return {k: (_nonzero_lora(v, rng) if isinstance(v, dict) else
                (rng.normal(0, 0.05, np.shape(v)).astype(np.float32)
                 if k == "lora_B" else np.asarray(v)))
            for k, v in tree.items()}


def _pair(family, mode, pack, fused, jdtype=jnp.float32,
          tdtype=torch.float32):
    """(JAX module, JAX params, port module with the same weights)."""
    kw = dict(FAMILIES[family], **MODES[mode], attention_pack=pack,
              fused_attention=fused)
    if family == "opt":
        jmod = jlayers.OPTDecoderSlice(max_position=64, dtype=jdtype, **kw)
        tmod = layers.OPTDecoderSlice(dim=D, max_position=64, dtype=tdtype,
                                      **kw)
    else:
        jmod = jlayers.LlamaDecoderSlice(intermediate_size=48, dtype=jdtype,
                                         **kw)
        tmod = layers.LlamaDecoderSlice(dim=D, intermediate_size=48,
                                        dtype=tdtype, **kw)
    x, mask = _inputs()
    tree = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(mask),
                     False)
    tree = _nonzero_lora(jax.tree_util.tree_map(np.asarray, tree),
                         np.random.default_rng(2))
    tmod.load_state_dict(params_from_jax(tree, tmod))
    return jmod, tree, tmod


CASES = [(f, m, p, fu) for f in FAMILIES for m in MODES for p in (0, -1)
         for fu in (False, True)]


@pytest.mark.parametrize("family,mode,pack,fused", CASES)
def test_slice_matches_jax(family, mode, pack, fused):
    jmod, tree, tmod = _pair(family, mode, pack, fused)
    x, mask = _inputs()
    want = np.asarray(jax.jit(lambda p, a, m: jmod.apply(p, a, m, False))(
        tree, jnp.asarray(x), jnp.asarray(mask)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (B, L, D)
    valid = mask.astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("mode", list(MODES))
def test_slice_gradients_match_jax(family, mode):
    """Packed and fused (the YAMLs' setting): the gradient of
    sum(valid outputs * w) for a fixed random w."""
    jmod, tree, tmod = _pair(family, mode, -1, True)
    x, mask = _inputs(3)
    w = np.random.default_rng(4).standard_normal((B, L, D)).astype(
        np.float32) * mask[:, :, None]

    def jloss(p, a):
        return jnp.sum(jmod.apply(p, a, jnp.asarray(mask), False) * w)

    jg_p, jg_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(tree,
                                                          jnp.asarray(x))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jg_p), tmod)
    xt = torch.from_numpy(x).requires_grad_(True)
    (tmod(xt, torch.from_numpy(mask)) * torch.from_numpy(w)).sum().backward()
    checked = 0
    for name, p in tmod.named_parameters():
        ref = want[name].numpy()
        if not p.requires_grad:
            assert p.grad is None
            continue
        # a bias against the larger of its own and its weight's largest
        # value: a key's bias gets a gradient zero to first order (softmax
        # does not see a shift common to every key), its rounding residue
        weight = want.get(name[:-len("bias")] + "weight", want[name])
        scale = max(float(np.abs(ref).max()), float(weight.abs().max()),
                    1e-6)
        assert float(np.abs(p.grad.numpy() - ref).max()) <= 1e-4 * scale, \
            name
        checked += 1
    # LoRA A and B of q and v in the upper slice; every tensor otherwise
    assert checked == (4 if mode == "upper" else
                       len(list(tmod.parameters())))
    ref = np.asarray(jg_x)
    assert np.abs(xt.grad.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("fused", [False, True])
def test_slice_bf16_matches_jax(family, fused):
    jmod, tree, tmod = _pair(family, "full", -1, fused, jnp.bfloat16,
                             torch.bfloat16)
    x, mask = _inputs(5)
    want = np.asarray(jmod.apply(tree, jnp.asarray(x), jnp.asarray(mask),
                                 False), np.float32)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), torch.from_numpy(mask)).float()
    valid = mask.astype(bool)
    err = np.abs(got.numpy()[valid] - want[valid]).max()
    assert np.isfinite(got.numpy()).all()
    assert err <= 2e-2 * np.abs(want[valid]).max()


@pytest.mark.parametrize("bf16_apply", [False, True])
def test_rms_norm_rounds_as_jax(bf16_apply):
    """Without bf16_apply the output is f32 (the bf16-rounded normalised x
    times the f32 weight); with it, bf16. Equal to JAX's to 1e-6 in
    either dtype's terms."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    jmod = jlayers.RMSNorm(bf16_apply=bf16_apply, dtype=jnp.bfloat16)
    jx = jnp.asarray(x, jnp.bfloat16)
    want = jmod.apply({"params": {"weight": jnp.asarray(scale)}}, jx)
    tmod = layers.RMSNorm(16, bf16_apply=bf16_apply, dtype=torch.bfloat16)
    tmod.load_state_dict({"weight": torch.from_numpy(scale)})
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).bfloat16())
    assert got.dtype == (torch.bfloat16 if bf16_apply else torch.float32)
    assert want.dtype == (jnp.bfloat16 if bf16_apply else jnp.float32)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-6,
                               atol=1e-6 if not bf16_apply else 1e-2)


@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rotary_matches_jax(interleaved, dtype):
    """The tables and the rotation, at rope theta 1e4 and 5e5, and the
    tables tiled for packed items (positions restarting every 9)."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    x = np.random.default_rng(7).standard_normal((2, 27, 3, 8)).astype(
        np.float32)
    for base in (10000.0, 500000.0):
        if interleaved:
            jcos, jsin = jlayers.rotary_interleaved_embedding(9, 4, base, jdt)
            jrot = jlayers.apply_rotary_partial_interleaved
        else:
            jcos, jsin = jlayers.rotary_embedding(9, 8, base, jdt)
            jrot = jlayers.apply_rotary
        jcos, jsin = jnp.tile(jcos, (3, 1)), jnp.tile(jsin, (3, 1))
        cos, sin = layers.rotary_tables(interleaved, 9, 27, 4 if interleaved
                                        else 8, base, tdt, "cpu")
        # f32: within an ulp of 1 (the two libraries' cos and sin); bf16:
        # the same values rounded, so within one bf16 ulp
        tol = 1e-6 if dtype == "f32" else 2 ** -8
        for t, jt in ((cos, jcos), (sin, jsin)):
            np.testing.assert_allclose(t.float().numpy(),
                                       np.asarray(jt, np.float32), rtol=0,
                                       atol=tol)
        rot = (layers.apply_rotary_partial_interleaved if interleaved
               else layers.apply_rotary)
        got = rot(torch.from_numpy(x).to(tdt), cos, sin).float().numpy()
        want = np.asarray(jrot(jnp.asarray(x, jdt), jcos, jsin), np.float32)
        tol = 1e-5 if dtype == "f32" else 2e-2
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_causal_packed_bias_is_jaxs():
    _, mask = _inputs()
    G = 128 // L
    x = np.zeros((B, L, 1), np.float32)
    _, jmask_p, _ = jlayers.pack_items(jnp.asarray(x), jnp.asarray(mask), G)
    _, mask_p, pad = layers.pack_items(torch.from_numpy(x),
                                       torch.from_numpy(mask), G)
    assert pad == G - B
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = layers.packed_mask_bias(mask_p, L, dt, causal=True)
        want = jlayers.packed_mask_bias(jmask_p, L, jdt, causal=True)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    # without packing: the slice's causal + key-padding bias
    got = layers.causal_mask_bias(torch.from_numpy(mask), torch.float32)
    allowed = np.tril(np.ones((L, L), bool))[None, None] & mask.astype(
        bool)[:, None, None, :]
    np.testing.assert_array_equal(got.numpy() == 0, allowed)


def test_opt_positions_follow_valid_tokens():
    """Position rows clip(cumsum(mask) - 1, 0) + 2 of the table, only at
    start 0: a slice of no layers returns x + those rows."""
    x, mask = _inputs(8)
    mod = layers.OPTDecoderSlice(num_layers=0, dim=D, max_position=16,
                                 final_norm=False, dtype=torch.float32)
    with torch.no_grad():
        got = mod(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    pos = np.clip(np.cumsum(mask, axis=1) - 1, 0, None) + 2
    table = mod.position_embeddings.detach().numpy()
    np.testing.assert_array_equal(got, x + table[pos])
    upper = layers.OPTDecoderSlice(num_layers=1, dim=D, start=1,
                                   dtype=torch.float32)
    assert not hasattr(upper, "position_embeddings")


@pytest.mark.parametrize("cls", [layers.LlamaDecoderSlice,
                                 layers.OPTDecoderSlice])
def test_decoder_knobs_not_ported_raise(cls):
    # collect_pooled (IISAN), fused_qkv (tests/test_torch_lm_knobs.py)
    # and pipeline_stages (tests/test_torch_pp.py) are ported; a stack
    # that does not divide into the stages raises, with them too, and
    # JAX refuses collect_pooled staged under a pp mesh
    from legommenders_tpu_torch.parallel import mesh as tmesh

    assert cls(num_layers=1, dim=D, num_heads=2,
               fused_qkv=True).layer_0.fused_qkv
    pooled = cls(num_layers=2, dim=D, num_heads=2, pipeline_stages=2,
                 collect_pooled=True, dtype=torch.float32)
    with tmesh.pipeline_parallel(tmesh.Mesh(1, 0, pp=2)):
        for knob in (dict(fused_qkv=True, pipeline_stages=2),
                     dict(pipeline_stages=2)):
            odd = cls(num_layers=1, dim=D, num_heads=2, dtype=torch.float32,
                      **knob)
            with pytest.raises(ValueError, match="% pipeline_stages 2 != 0"):
                odd(torch.zeros(2, 3, D), torch.ones(2, 3))
        with pytest.raises(ValueError, match="IISAN pooled collection"):
            pooled(torch.zeros(2, 3, D), torch.ones(2, 3))
