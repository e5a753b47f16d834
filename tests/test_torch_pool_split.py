"""The long-sequence pool's split of an item into tiles, emulated on the CPU.

`additive_pool_long` (legommenders_tpu_torch/csrc/additive_pool.cu) scores
an item's positions in tiles of 128 on as many CTAs, each keeping its
masked max m_t, sum_t = sum exp(s - m_t') * mask and acc_t = sum e * x (m_t'
by the reference's all-masked rule), and one CTA combines them in tile
order: out = sum_t f_t acc_t / (sum_t f_t sum_t + EPS), f_t = e^{m_t - M'}
with M' the guarded max over the item, a tile with no valid position adding
exactly 0. `split_pool` below is that arithmetic in torch (f32); it is held
against the JAX package's `additive_attention_fused` (its `_forward_jnp`
path, the function the kernel replaces) on the same numpy inputs within
1e-6 at f32 (sums in another order), at L one past a tile, the flattened
histories' 495 and 1,023 and 4,096, with an all-masked item, an item valid
only in its last tile and one whose middle tile is all masked; and once
more with every score -100 (the tanh saturated, so that both sides score
alike), where e^{0 - M'} of a masked tile would overflow and an all-masked
tile computed that way would give inf * 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legommenders_tpu.ops.pallas_additive import additive_attention_fused

TILE, EPS, TOL = 128, 1e-8, 1e-6
N, D, H = 6, 16, 8


def split_pool(x, mask, w1, b1, w2, tile=TILE):
    """The long kernel's arithmetic: per tile partials, then the combine."""
    neg = torch.finfo(torch.float32).min
    s = torch.tanh(x @ w1 + b1) @ w2  # (N, L)
    parts = []
    for t0 in range(0, x.shape[1], tile):
        st, mt = s[:, t0:t0 + tile], mask[:, t0:t0 + tile]
        m = torch.where(mt > 0, st, neg).amax(dim=1)  # the raw max, m_t
        mg = torch.where(m > neg / 2, m, torch.zeros_like(m))
        e = torch.where(mt > 0, torch.exp(st - mg[:, None]) * mt,
                        torch.zeros_like(st))
        parts.append((m, e.sum(dim=1),
                      torch.einsum("nl,nld->nd", e, x[:, t0:t0 + tile])))
    M = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    Mg = torch.where(M > neg / 2, M, torch.zeros_like(M))
    den = torch.zeros_like(M)
    acc = torch.zeros(x.shape[0], x.shape[2])
    for m, z, a in parts:  # in tile order
        valid = m > neg / 2
        f = torch.where(valid, torch.exp(torch.where(valid, m - Mg, 0.0)),
                        torch.zeros_like(m))
        den = den + f * z
        acc = acc + f[:, None] * a
    return acc / (den + EPS)[:, None]


def _inputs(L, very_negative, seed):
    """x ~ N(0, 1); item 0 all masked, item 1 valid only in its last tile,
    item 2 with its middle tile (the first, at two tiles) all masked, the
    rest valid at random; with very_negative, b1 = 20 (every tanh 1 in
    f32) and w2 = -100 / H, so that every score is exactly -100."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, L, D)).astype(np.float32)
    mask = (rng.random((N, L)) < 0.8).astype(np.float32)
    last = (L - 1) // TILE * TILE
    mask[0] = 0.0
    mask[1, :last] = 0.0
    mask[1, last] = 1.0
    mid = (L - 1) // TILE // 2 * TILE
    mask[2, mid:mid + TILE] = 0.0
    w1 = (rng.standard_normal((D, H)) / np.sqrt(D)).astype(np.float32)
    b1 = (rng.standard_normal(H) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal(H) / np.sqrt(H)).astype(np.float32)
    if very_negative:
        w1 *= 0.1
        b1 = np.full(H, 20.0, np.float32)
        w2 = np.full(H, -100.0 / H, np.float32)
    return x, mask, w1, b1, w2


@pytest.mark.parametrize("very_negative", [False, True])
@pytest.mark.parametrize("L", [129, 495, 1023, 4096])
def test_split_combine_matches_jax(L, very_negative):
    args = _inputs(L, very_negative, seed=L)
    got = split_pool(*(torch.from_numpy(a) for a in args))
    want = np.asarray(additive_attention_fused(*(jnp.asarray(a)
                                                 for a in args)))
    assert np.isfinite(got.numpy()).all()
    assert (got[0] == 0).all()  # the all-masked item, exactly
    assert np.abs(got.numpy() - want).max() <= TOL
    if very_negative:
        s = np.tanh(args[0] @ args[2] + args[3]) @ args[4]
        assert (s == -100).all()  # e^{0 - M'} would overflow f32
        assert 100 > np.log(np.finfo(np.float32).max)
