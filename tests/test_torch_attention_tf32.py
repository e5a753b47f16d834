"""The numerics of the f32 attention kernels (`attention_fwd_tf32` and
`attention_bwd_tf32` of legommenders_tpu_torch/csrc/packed_attention.cu)
emulated on the CPU.

The kernels take every product on the tensor cores in 3xTF32: each f32
operand is split into hi = rna_tf32(x) and lo = rna_tf32(x - hi), and each
k step of 8 issues lo.hi, hi.lo and hi.hi (lo.lo dropped) into a fresh
accumulator, which is then added to the sum in f32. `_mm` does the same in
plain torch: `_tf32` rounds f32 to TF32 (to nearest, ties away from zero)
by integer operations on the f32 bits, as the kernels do, each k step's
three products are summed in f32 in the kernels' order, and the steps are
added in order. The attention around the products follows
the kernels: the forward's S, the softmax with the dropout's keep factors,
then P.V; the backward's phase 1 over the query rows (S, dPd, the row
statistics, dS, dQ) and phase 2 over the key rows (S^T and dPd^T, P
recomputed from phase 1's statistics, dV and dK).

The emulation cannot model the tensor core's own accumulation inside one
mma (it truncates where an f32 sum rounds): the card's checks
(chip_smoke.py, tests/test_torch_cuda.py) hold the kernels themselves.

Inputs from numpy with a seed: bert-naml's training page cut to B 8 (T 120,
12 heads of 64, the packed bias of 3 items of 40, dropout 0.1 with the
plain Philox's keep mask) and a causal page at head width 128 (B 2, T 128,
4 heads, 4 causal items of 32). The emulated forward and dq, dk, dv must
lie within F32_TOL (1e-5 absolute; values O(1)) of `reference_attention` /
`reference_attention_backward`, and the forward of the JAX package's
`reference_attention` on the same inputs; one TF32 product alone (hi.hi)
must not, which is why the kernels issue three.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legommenders_tpu.ops.pallas_attention import (
    reference_attention as jreference,
)
from legommenders_tpu_torch.models.lm.layers import (
    pack_items, packed_mask_bias,
)
from legommenders_tpu_torch.ops.attention import (
    dropout_keep_mask, reference_attention, reference_attention_backward,
)

F32_TOL = 1e-5
# (B, T, heads, dh, item length L, causal, dropout)
PAGES = {"bert-naml training": (8, 120, 12, 64, 40, False, 0.1),
         "causal dh 128": (2, 128, 4, 128, 32, True, 0.0)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Single-threaded torch while this module runs (the suite runs in
    parallel workers); restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero, as cvt.rna.tf32.f32 rounds) as the kernels compute it: half of
    the 13 dropped bits added to the magnitude's bits, then those bits
    cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    """(hi, lo): hi = rna_tf32(x), lo = rna_tf32(x - hi)."""
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mm(a, b, three=True):
    """a (..., M, K) @ b (..., K, N) as the kernels take it: per k step of
    8, lo.hi + hi.lo + hi.hi in f32 (hi.hi alone where not `three`), the
    steps added in order."""
    ah, al = _split(a)
    bh, bl = _split(b)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        t = ah[..., ks] @ bh[..., ks, :]
        if three:
            t = (al[..., ks] @ bh[..., ks, :] + ah[..., ks] @ bl[..., ks, :]) + t
        acc = acc + t
    return acc


def _heads(x, H):
    B, T, D = x.shape
    return x.reshape(B, T, H, D // H).transpose(1, 2)


def _merge(x):
    B, H, T, dh = x.shape
    return x.transpose(1, 2).reshape(B, T, H * dh)


def _keep_factor(keep, p):
    scale = torch.tensor(1.0 / (1.0 - p), dtype=torch.float32)
    return None if keep is None else keep.float() * scale


def emulated_forward(H, p, q, k, v, bias, keep, three=True):
    qh, kh, vh = (_heads(x, H) for x in (q, k, v))
    scale = torch.tensor(1.0 / math.sqrt(qh.shape[-1]), dtype=torch.float32)
    s = _mm(qh, kh.transpose(-1, -2), three) * scale + bias[:, None]
    e = torch.exp(s - s.amax(-1, keepdim=True))
    pr = e / e.sum(-1, keepdim=True)
    kf = _keep_factor(keep, p)
    if kf is not None:
        pr = pr * kf
    return _merge(_mm(pr, vh, three))


def emulated_backward(H, p, q, k, v, bias, g, keep, three=True):
    qh, kh, vh, gh = (_heads(x, H) for x in (q, k, v, g))
    scale = torch.tensor(1.0 / math.sqrt(qh.shape[-1]), dtype=torch.float32)
    kf = _keep_factor(keep, p)
    # phase 1: the query rows
    s = _mm(qh, kh.transpose(-1, -2), three) * scale + bias[:, None]
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    ell = e.sum(-1, keepdim=True)
    pr = e / ell
    dp = _mm(gh, vh.transpose(-1, -2), three)
    if kf is not None:
        dp = dp * kf
    rs = (dp * pr).sum(-1, keepdim=True)
    dq = _mm(pr * (dp - rs) * scale, kh, three)
    # phase 2: the key rows, P from phase 1's statistics
    st = (_mm(kh, qh.transpose(-1, -2), three) * scale
          + bias[:, None].transpose(-1, -2))
    pt = torch.exp(st - m.transpose(-1, -2)) / ell.transpose(-1, -2)
    dpt = _mm(vh, gh.transpose(-1, -2), three)
    kft = None if kf is None else kf.transpose(-1, -2)
    pdt = pt if kft is None else pt * kft
    dst = pt * ((dpt if kft is None else dpt * kft)
                - rs.transpose(-1, -2)) * scale
    dv = _mm(pdt, gh, three)
    dk = _mm(dst, qh, three)
    return tuple(_merge(x) for x in (dq, dk, dv))


def _page(name):
    """q, k, v, g ~ N(0, 1) from numpy, the page's packed bias (item
    lengths from numpy), the keep mask (or None) and its parameters."""
    B, T, H, dh, L, causal, p = PAGES[name]
    rng = np.random.default_rng(17)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(
        (B, T, H * dh)).astype(np.float32)) for _ in range(4))
    G = T // L
    lens = torch.from_numpy(rng.integers(L // 2, L + 1, B * G))
    mask = (torch.arange(L)[None] < lens[:, None]).int()
    _, mask_p, _ = pack_items(torch.zeros(B * G, L, 1), mask, G)
    bias = packed_mask_bias(mask_p, L, torch.float32, causal=causal)[:, 0]
    keep = None
    if p:
        keep = dropout_keep_mask(H, p, B, T,
                                 torch.tensor([2024], dtype=torch.int32))
    return H, p, q, k, v, bias.contiguous(), g, keep


def _errors(three, name):
    H, p, q, k, v, bias, g, keep = _page(name)
    got = (emulated_forward(H, p, q, k, v, bias, keep, three),) + \
        emulated_backward(H, p, q, k, v, bias, g, keep, three)
    want = (reference_attention(H, p, q, k, v, bias, keep),) + \
        reference_attention_backward(H, p, q, k, v, bias, g, keep)
    for a in got:
        assert torch.isfinite(a).all()
    return {part: (a - b).abs().max().item()
            for part, a, b in zip(("out", "dq", "dk", "dv"), got, want)}


@pytest.mark.parametrize("name", list(PAGES))
def test_three_tf32_products_are_within_f32_tol(name):
    errs = _errors(True, name)
    assert max(errs.values()) <= F32_TOL, errs


@pytest.mark.parametrize("name", list(PAGES))
def test_one_tf32_product_is_not(name):
    errs = _errors(False, name)
    assert min(errs.values()) > F32_TOL, errs


@pytest.mark.parametrize("name", list(PAGES))
def test_emulated_forward_matches_jax_reference(name):
    H, p, q, k, v, bias, _, keep = _page(name)
    got = emulated_forward(H, p, q, k, v, bias, keep)
    want = np.asarray(jreference(
        H, p, *(jnp.asarray(x.numpy()) for x in (q, k, v, bias)),
        keep_mask=None if keep is None else jnp.asarray(keep.numpy())))
    assert np.abs(got.numpy() - want).max() <= F32_TOL


def test_tf32_rounding_is_to_nearest_ties_away():
    """_tf32 against the rule on chosen bit patterns: 1 + 2^-11 (a tie)
    rounds up to 1 + 2^-10, 1 + 2^-11 - 2^-23 down to 1, and the same
    magnitudes negative the same way; the low 13 bits come out clear."""
    x = torch.tensor([1 + 2 ** -11, 1 + 2 ** -11 - 2 ** -23,
                      -(1 + 2 ** -11), -(1 + 2 ** -11 - 2 ** -23), 3.0],
                     dtype=torch.float32)
    want = torch.tensor([1 + 2 ** -10, 1.0, -(1 + 2 ** -10), -1.0, 3.0],
                        dtype=torch.float32)
    got = _tf32(x)
    assert torch.equal(got, want)
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(
        1000).astype(np.float32))
    assert (_tf32(r).view(torch.int32) & 0x1FFF).eq(0).all()
    hi, lo = _split(r)
    assert (_tf32(r) == r).sum() < 10  # the inputs use their low bits
    assert ((hi + lo) - r).abs().max() <= 2 ** -21 * r.abs().max()
