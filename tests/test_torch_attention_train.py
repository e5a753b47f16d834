"""The port's packed attention in training vs the JAX package.

`packed_attention` (an autograd Function in legommenders_tpu_torch/ops/
attention.py; on the CPU its plain forward and plain backward) against
`jax.vjp` of the JAX `packed_attention`, whose Pallas forward and backward
kernels run in interpret mode here, at dropout 0: outputs within 1e-5,
gradients within 1e-4 relative (f32, sums in another order). At dropout
0.375 the JAX package's CPU twin draws its keep mask with threefry; that
mask (JAX `dropout_keep_mask`) is fed to the port's plain forward and plain
backward, which must give the JAX output and gradients within 3e-4, as
tests/test_pallas_attention.py holds the kernels to the same mask. The
plain backward, which follows `_bwd_kernel` step by step, must equal
autograd of the plain forward (1e-5) with and without a mask, and the
port's own Philox mask must be a deterministic function of the seed.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legommenders_tpu.models.lm import layers as jlayers
from legommenders_tpu.ops.pallas_attention import (
    dropout_keep_mask as jkeep_mask, packed_attention as jpacked,
)
from legommenders_tpu_torch.ops.attention import (
    dropout_bits_reference, dropout_keep_mask, keep_threshold,
    packed_attention, packed_attention_backward, reference_attention,
    reference_attention_backward,
)

H = 2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Single-threaded torch while this module runs (the suite runs in
    parallel workers); restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(case):
    """q, k, v, g ~ N(0, 1) and the bias: key validity (plain) or the
    block-diagonal bias of packed items."""
    B, T, D, L = case
    rng = np.random.default_rng(B * 1000 + T)
    q, k, v, g = (rng.standard_normal((B, T, D)).astype(np.float32)
                  for _ in range(4))
    if L:
        lens = rng.integers(1, L + 1, B * (T // L))
        mask = (np.arange(L)[None] < lens[:, None]).astype(np.int32)
        _, mask_p, _ = jlayers.pack_items(
            jnp.zeros((len(lens), L, 1)), jnp.asarray(mask), T // L)
        bias = np.array(jlayers.packed_mask_bias(mask_p, L, jnp.float32)[:, 0])
    else:
        lens = rng.integers(1, T + 1, B)
        valid = np.arange(T)[None] < lens[:, None]
        bias = np.where(valid, 0.0, np.finfo(np.float32).min)
        bias = np.ascontiguousarray(np.broadcast_to(
            bias[:, None], (B, T, T)).astype(np.float32))
    return q, k, v, bias, g


# (B, T, D, packed item length): odd B and T, plain and packed biases
CASES = {"plain_B5_T9": (5, 9, 16, 0), "packed_B2_T39": (2, 39, 16, 13)}


def _jax_vjp(p, q, k, v, bias, g, seed):
    out, vjp = jax.vjp(lambda a, b, c: jpacked(H, p, a, b, c, jnp.asarray(bias),
                                               seed),
                       *map(jnp.asarray, (q, k, v)))
    return np.asarray(out), [np.asarray(t) for t in vjp(jnp.asarray(g))]


def _port(p, q, k, v, bias, g, seed):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    before = (packed_attention.launches, packed_attention_backward.launches)
    out = packed_attention(H, p, tq, tk, tv, torch.from_numpy(bias), seed)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    # the CPU takes the plain versions: no kernel launched
    assert (packed_attention.launches,
            packed_attention_backward.launches) == before
    return out.detach().numpy(), [t.numpy() for t in grads]


def _assert_rel(got, want, rel, what):
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


@pytest.mark.parametrize("case", sorted(CASES))
def test_function_matches_jax_kernels_at_dropout_0(case):
    q, k, v, bias, g = _inputs(CASES[case])
    want_out, want_grads = _jax_vjp(0.0, q, k, v, bias, g,
                                    jnp.zeros((1,), jnp.int32))
    got_out, got_grads = _port(0.0, q, k, v, bias, g, None)
    np.testing.assert_allclose(got_out, want_out, rtol=1e-5, atol=1e-5)
    for name, a, b in zip("qkv", got_grads, want_grads):
        _assert_rel(a, b, 1e-4, f"d{name}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_versions_match_jax_dropout_contract(case):
    """dropout 0.375: the port's plain forward and backward, given the
    keep mask JAX draws for the seed, against JAX's output and gradients
    (its CPU twin draws that same mask)."""
    p = 0.375
    q, k, v, bias, g = _inputs(CASES[case])
    B, T, _ = q.shape
    jseed = jnp.asarray([17], jnp.int32)
    keep = np.asarray(jkeep_mask(H, p, B, T, jseed))
    assert keep.shape == (B, H, T, T) and 0.45 < keep.mean() < 0.8
    want_out, want_grads = _jax_vjp(p, q, k, v, bias, g, jseed)
    tkeep = torch.from_numpy(keep)
    args = [torch.from_numpy(a) for a in (q, k, v, bias)]
    got_out = reference_attention(H, p, *args, tkeep).numpy()
    got_grads = reference_attention_backward(H, p, *args, torch.from_numpy(g),
                                             tkeep)
    np.testing.assert_allclose(got_out, want_out, rtol=3e-4, atol=3e-4)
    for a, b in zip(got_grads, want_grads):
        np.testing.assert_allclose(a.numpy(), b, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("p", [0.0, 0.375])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_autograd_of_plain_forward(case, p):
    q, k, v, bias, g = _inputs(CASES[case])
    B, T, _ = q.shape
    keep = (dropout_keep_mask(H, p, B, T, torch.tensor([3], dtype=torch.int32))
            if p else None)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tb, tg = torch.from_numpy(bias), torch.from_numpy(g)
    out = reference_attention(H, p, tq, tk, tv, tb, keep)
    want = torch.autograd.grad(out, (tq, tk, tv), tg)
    got = reference_attention_backward(H, p, tq.detach(), tk.detach(),
                                       tv.detach(), tb, tg, keep)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_function_with_dropout_uses_the_seeds_mask():
    """On the CPU the Function draws the Philox mask of its seed in the
    forward and again in the backward: its output and gradients are those
    of the plain versions with dropout_keep_mask(seed)."""
    p = 0.1
    q, k, v, bias, g = _inputs(CASES["packed_B2_T39"])
    seed = torch.tensor([-123456789], dtype=torch.int32)
    got_out, got_grads = _port(p, q, k, v, bias, g, seed)
    keep = dropout_keep_mask(H, p, 2, 39, seed)
    args = [torch.from_numpy(a) for a in (q, k, v, bias)]
    np.testing.assert_array_equal(
        got_out, reference_attention(H, p, *args, keep).numpy())
    for a, b in zip(got_grads, reference_attention_backward(
            H, p, *args, torch.from_numpy(g), keep)):
        np.testing.assert_array_equal(a, b.numpy())


def test_keep_mask_is_a_function_of_the_seed():
    """The same seed gives the same bits, another seed others; bits are
    uniform (keep fraction within 4 sigma of 1 - p); element (i, j) and
    its neighbours in one Philox draw get distinct words."""
    B, T, p = 3, 40, 0.1
    a = dropout_bits_reference(H, B, T, 11)
    assert torch.equal(a, dropout_bits_reference(H, B, T, 11))
    assert (a != dropout_bits_reference(H, B, T, 12)).float().mean() > 0.99
    assert int(a.min()) >= 0 and int(a.max()) < 2 ** 32
    keep = dropout_keep_mask(H, p, B, T, torch.tensor([11], dtype=torch.int32))
    assert torch.equal(keep, a >= keep_threshold(p))
    n = keep.numel()
    assert abs(keep.float().mean().item() - (1 - p)) <= 4 * (p * (1 - p) / n) ** 0.5
    # the four words of one draw: (i, j), (i, j+1), (i+8, j), (i+8, j+1)
    quad = torch.stack([a[..., 0, 0], a[..., 0, 1], a[..., 8, 0],
                        a[..., 8, 1]], -1)
    assert all(len(set(r.tolist())) == 4 for r in quad.reshape(-1, 4))


# Philox4x32-10 known answers, (counter, key) -> output, from the
# kat_vectors file of Random123 (Salmon et al., "Parallel random numbers:
# as easy as 1, 2, 3", SC 2011), lines "philox4x32 10 ...".
PHILOX_KAT = [
    ((0x00000000, 0x00000000, 0x00000000, 0x00000000),
     (0x00000000, 0x00000000),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF),
     (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", PHILOX_KAT)
def test_philox_matches_random123_known_answers(ctr, key, want):
    """The PyTorch Philox behind dropout_bits_reference (and, through the
    card tests' bit-for-bit check, the kernels' Philox) gives Random123's
    published outputs."""
    from legommenders_tpu_torch.ops.attention import _philox4x32_10

    got = _philox4x32_10([torch.tensor([c], dtype=torch.int64) for c in ctr],
                         key)
    assert [int(w) for w in got] == list(want)


def _row_hoisted_draw(seed, b, h, i0, jp):
    """The kernels' split of one draw (csrc/packed_attention.cu
    `philox_row` + `dropout_bits4_at`): what rounds 0 and 1 take from
    (i0, h, b) once per row, then per column pair two products and three
    XORs before rounds 2-9."""
    from legommenders_tpu_torch.ops.attention import (
        _PHILOX_M, _PHILOX_W, _U32, _mulhilo,
    )

    t = functools.partial(torch.tensor, dtype=torch.int64)
    kx = [(seed + r * _PHILOX_W[0]) & _U32 for r in range(10)]
    hi1, lo1 = _mulhilo(_PHILOX_M[1], t([h]))                   # philox_row
    hia, loa = _mulhilo(_PHILOX_M[0], hi1 ^ i0 ^ kx[0])
    q, p, r = lo1 ^ kx[1], hia ^ _PHILOX_W[1], loa
    hi0, lo0 = _mulhilo(_PHILOX_M[0], t([jp]))                  # per draw
    hi1, lo1 = _mulhilo(_PHILOX_M[1], hi0 ^ b)
    c = [hi1 ^ q, lo1, lo0 ^ p, r]
    for rnd in range(2, 10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c[0])
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c[2])
        c = [hi1 ^ c[1] ^ kx[rnd], lo1, hi0 ^ c[3] ^ ((rnd * _PHILOX_W[1]) & _U32),
             lo0]
    return [int(w) for w in c]


@pytest.mark.parametrize("seed,b,h,i0,jp", [
    (0, 0, 0, 0, 0), (20231, 170, 11, 119, 59), (0xFFFFFFFF, 3, 7, 23, 1),
    (0x7FFFFFFF, 2 ** 31 - 1, 2 ** 16, 2 ** 20 + 7, 2 ** 31 + 5)])
def test_row_hoisted_draw_is_philox(seed, b, h, i0, jp):
    """Hoisting rounds 0-1's row terms out of the draw, as the mask, the
    forward and the backward kernels do, keeps Philox4x32-10 of counter
    (jp, i0, h, b) and key (seed, 0) bit for bit."""
    from legommenders_tpu_torch.ops.attention import _philox4x32_10

    want = _philox4x32_10([torch.tensor([c], dtype=torch.int64)
                           for c in (jp, i0, h, b)], (seed, 0))
    assert _row_hoisted_draw(seed, b, h, i0, jp) == [int(w) for w in want]


def _column_split_draw(seed, b, h, i0, jp):
    """The mask kernel's split of one draw (csrc/packed_attention.cu
    `philox_col`, `philox_head`, `philox_col_item`, `philox_row2`,
    `dropout_bits4_split`): round 0's products of jp and of h, rounds 1-2's
    of (jp, b) and (jp, b, h), round 1's of (i0, h), then per draw round
    2's product of (jp, i0, h) and rounds 3-9."""
    from legommenders_tpu_torch.ops.attention import (
        _PHILOX_M, _PHILOX_W, _U32, _mulhilo,
    )

    t = functools.partial(torch.tensor, dtype=torch.int64)
    kx = [(seed + r * _PHILOX_W[0]) & _U32 for r in range(10)]
    col_hi, col_lo = _mulhilo(_PHILOX_M[0], t([jp]))            # philox_col
    head_hi, head_lo = _mulhilo(_PHILOX_M[1], t([h]))           # philox_head
    zh, zl = _mulhilo(_PHILOX_M[1], col_hi ^ b)                 # philox_col_item
    xh, xl = _mulhilo(_PHILOX_M[0], zh ^ head_lo ^ kx[1])
    ci = (zl ^ kx[2], xh ^ ((2 * _PHILOX_W[1]) & _U32), xl)
    rh, rl = _mulhilo(_PHILOX_M[0], head_hi ^ i0 ^ kx[0])       # philox_row2
    row_p, row_w = rh ^ _PHILOX_W[1], rl
    hi, lo = _mulhilo(_PHILOX_M[1], row_p ^ col_lo)             # per draw
    c = [hi ^ ci[0], lo, ci[1] ^ row_w, ci[2]]
    for rnd in range(3, 10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c[0])
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c[2])
        c = [hi1 ^ c[1] ^ kx[rnd], lo1, hi0 ^ c[3] ^ ((rnd * _PHILOX_W[1]) & _U32),
             lo0]
    return [int(w) for w in c]


@pytest.mark.parametrize("seed,b,h,i0,jp", [
    (0, 0, 0, 0, 0), (20231, 170, 11, 119, 59), (0xFFFFFFFF, 3, 7, 23, 1),
    (0x7FFFFFFF, 2 ** 31 - 1, 2 ** 16, 2 ** 20 + 7, 2 ** 31 + 5)])
def test_column_split_draw_is_philox(seed, b, h, i0, jp):
    """Taking a draw's column, head and item terms apart from its row's, as
    the mask kernel does, keeps Philox4x32-10 of counter (jp, i0, h, b) and
    key (seed, 0) bit for bit."""
    from legommenders_tpu_torch.ops.attention import _philox4x32_10

    want = _philox4x32_10([torch.tensor([c], dtype=torch.int64)
                           for c in (jp, i0, h, b)], (seed, 0))
    assert _column_split_draw(seed, b, h, i0, jp) == [int(w) for w in want]
