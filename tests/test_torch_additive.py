"""The port's additive pool and masked ops vs the JAX package.

The plain version of `legommenders_tpu_torch/ops/additive.py` is held
against the JAX `_forward_jnp` and against the Pallas kernel run in
interpret mode, on the same numpy inputs; the AdditiveAttention module is
held against the flax module on the same weights. f32 throughout; the
tolerance is 1e-5 (the sums run in another order on each side). The
gradients of `additive_pool` (an autograd Function whose backward is the
plain recompute `additive_pool_backward_reference`) and of the module are
held against `jax.grad` through the JAX `additive_attention_fused` and its
custom backward, within the tolerances of tests/test_ops.py (1e-4
relative, 1e-5 absolute).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legommenders_tpu.models.common import AdditiveAttention as JAdditive
from legommenders_tpu.ops import core as jcore
from legommenders_tpu.ops.pallas_additive import (
    _forward_jnp, additive_attention_fused,
)
from legommenders_tpu_torch.models.common import AdditiveAttention
from legommenders_tpu_torch.ops import core
from legommenders_tpu_torch.ops.additive import (
    additive_pool, additive_pool_reference,
)

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Single-threaded torch while this module runs (the suite runs in
    parallel workers); restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pool_inputs():
    rng = np.random.default_rng(7)
    N, L, D, H = 37, 12, 16, 32
    x = rng.normal(size=(N, L, D)).astype(np.float32)
    mask = (rng.random((N, L)) < 0.7).astype(np.float32)
    mask[0] = 0          # all-masked
    mask[1] = 1          # all-valid
    mask[2, 1:] = 0      # one valid position
    w1 = (rng.normal(size=(D, H)) * 0.3).astype(np.float32)
    b1 = (rng.normal(size=(H,)) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(H,)) * 0.3).astype(np.float32)
    return x, mask, w1, b1, w2


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_reference_matches_forward_jnp(pool_inputs):
    want = np.asarray(_forward_jnp(*map(jnp.asarray, pool_inputs)))
    got = additive_pool_reference(*_torch(*pool_inputs)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert np.all(got[0] == 0.0)


def test_reference_matches_pallas_interpret(pool_inputs):
    from jax.experimental import pallas as pl
    import legommenders_tpu.ops.pallas_additive as mod

    orig = pl.pallas_call
    try:
        pl.pallas_call = functools.partial(orig, interpret=True)
        want = np.asarray(mod._forward_pallas(
            *map(jnp.asarray, pool_inputs), tile_n=16))
    finally:
        pl.pallas_call = orig
    got = additive_pool_reference(*_torch(*pool_inputs)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert np.all(got[0] == 0.0)


def test_wrapper_on_cpu_takes_plain_version(pool_inputs):
    before = additive_pool.launches
    t = _torch(*pool_inputs)
    got = additive_pool(*t)
    assert torch.equal(got, additive_pool_reference(*t))
    assert additive_pool.launches == before


def test_wrapper_rejects_other_devices(pool_inputs):
    t = [a.to("meta") for a in _torch(*pool_inputs)]
    with pytest.raises(ValueError, match="unsupported device"):
        additive_pool(*t)


def test_additive_attention_module_matches_flax(pool_inputs):
    x, mask, *_ = pool_inputs
    lead_x = x.reshape(1, *x.shape)            # leading dims are restored
    lead_m = mask.reshape(1, *mask.shape)
    jmod = JAdditive(hidden_size=32)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(lead_x),
                       jnp.asarray(lead_m))
    want = np.asarray(jmod.apply(params, jnp.asarray(lead_x),
                                 jnp.asarray(lead_m)))
    mod = AdditiveAttention(16, 32)
    p = params["params"]
    mod.load_state_dict({k: torch.from_numpy(np.array(p[k]))
                         for k in ("proj_kernel", "proj_bias", "query")})
    with torch.no_grad():
        got = mod(torch.from_numpy(lead_x), torch.from_numpy(lead_m)).numpy()
    assert got.shape == want.shape == (1, 37, 16)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_pool_weights_cached_until_a_parameter_changes():
    """Without grad the compute-dtype casts are made once per parameter
    state; an in-place write or a new state dict refreshes them, and with
    grad they stay attached to the parameters."""
    mod = AdditiveAttention(16, 32, dtype=torch.bfloat16)
    want = lambda: tuple(p.to(torch.bfloat16).float() for p in  # noqa: E731
                         (mod.proj_kernel, mod.proj_bias, mod.query[:, 0]))
    with torch.no_grad():
        first = mod.pool_weights()
        assert all(w.dtype == torch.float32 for w in first)
        assert all(torch.equal(a, b) for a, b in zip(first, want()))
        assert all(a is b for a, b in zip(first, mod.pool_weights()))
        mod.proj_bias.add_(0.5)
        second = mod.pool_weights()
    assert torch.equal(second[1], want()[1]) and not torch.equal(first[1],
                                                                 second[1])
    mod.load_state_dict({k: v * 2 for k, v in mod.state_dict().items()})
    with torch.inference_mode():
        third = mod.pool_weights()
    assert all(torch.equal(a, b) for a, b in zip(third, want()))
    assert all(w.requires_grad for w in mod.pool_weights())


@pytest.mark.parametrize("name", ["masked_softmax", "masked_mean",
                                  "masked_max"])
def test_masked_ops_match_jax(name):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 7, 4)).astype(np.float32)
    m = (rng.random((5, 7)) < 0.6).astype(np.float32)
    m[0] = 0
    if name == "masked_softmax":
        args = (x[..., 0], m)
    else:
        args = (x, m)
    want = np.asarray(getattr(jcore, name)(*map(jnp.asarray, args)))
    got = getattr(core, name)(*_torch(*args)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=1e-6)
    assert np.all(got[0] == 0.0)


@pytest.mark.parametrize("loss", ["square", "weighted"])
def test_pool_gradients_match_jax(pool_inputs, loss):
    """d/d(x, w1, b1, w2) of sum(out**2) and of sum(out * w) for a fixed
    random w; the all-masked row gets zero gradient in x."""
    x, mask, w1, b1, w2 = pool_inputs
    wgt = np.random.default_rng(5).normal(size=(x.shape[0], x.shape[2]))
    wgt = wgt.astype(np.float32)

    def reduce(out, lib):
        if loss == "square":
            return (out ** 2).sum()
        return (out * (jnp.asarray(wgt) if lib == "jax"
                       else torch.from_numpy(wgt))).sum()

    want = jax.grad(lambda *a: reduce(additive_attention_fused(
        a[0], jnp.asarray(mask), *a[1:]), "jax"), argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (x, w1, b1, w2)))
    tx, tw1, tb1, tw2 = (torch.from_numpy(a).requires_grad_(True)
                         for a in (x, w1, b1, w2))
    out = additive_pool(tx, torch.from_numpy(mask), tw1, tb1, tw2)
    got = torch.autograd.grad(reduce(out, "torch"), (tx, tw1, tb1, tw2))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)
    assert np.all(got[0].numpy()[0] == 0.0)


def test_additive_attention_module_gradients_match_flax(pool_inputs):
    """The module's parameter and input gradients (through the cast
    weights of pool_weights) against jax.grad of the flax module."""
    x, mask, *_ = pool_inputs
    jmod = JAdditive(hidden_size=32)
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x),
                       jnp.asarray(mask))
    jx, jm = jnp.asarray(x), jnp.asarray(mask)
    gp, gx = jax.grad(lambda p, a: (jmod.apply(p, a, jm) ** 2).sum(),
                      argnums=(0, 1))(params, jx)
    mod = AdditiveAttention(16, 32)
    mod.load_state_dict({k: torch.from_numpy(np.array(params["params"][k]))
                         for k in ("proj_kernel", "proj_bias", "query")})
    tx = torch.from_numpy(x).requires_grad_(True)
    (mod(tx, torch.from_numpy(mask)) ** 2).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-4,
                               atol=1e-5)
    for k in ("proj_kernel", "proj_bias", "query"):
        np.testing.assert_allclose(getattr(mod, k).grad.numpy(),
                                   np.asarray(gp["params"][k]), rtol=1e-4,
                                   atol=1e-5)
