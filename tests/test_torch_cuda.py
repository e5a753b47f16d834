"""The CUDA kernels on the card (skips without one): the additive pool
and the packed attention's forward (with and without dropout), backward
and keep mask.

Imports no JAX, so that it runs on a machine with the card but without
JAX: `python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`.
Each kernel is held against its plain version at small, odd shapes (the
pool: L not a multiple of a warp's 16 rows, H below and above a 64-column
group; the attention: odd B and T <= 128, packed and plain biases, every
head width of the tensor-core path and two of the CUDA-core path, at
dropout 0 and 0.1 with the mask the mask kernel draws) with f32 inputs
within 1e-5 (values O(1), sums in another order) and bf16 within 2e-2 of
the largest output, and every input a wrapper refuses must raise before a
launch. The mask kernel must give the plain Philox's mask exactly. The
bf16 tensor-core kernels (persistent, TMA-fed) are held besides at the
shapes their schedule and loads make risky (TC_CASES: bert-naml's full
pages, B * H far above and below the grid, T around the 64-row tiles,
every head width, ragged, broadcast and f32 biases), and the keep mask the
forward and the backward apply is read back from their outputs and must
equal the mask kernel's bit for bit. The bf16 tensor-core pool (whole items
per 128-row tile) is held at every main-path L with N around one tile, a
page and more tiles than the grid, with all-masked and single-position
items, an f32 W1, one item per tile and every hidden width, and at the news
zoo's pools (L 1 and 30 at H 256, L 32-34 and 50 at H 64); the profiler's
kernel names must show it took those and additive_pool_kernel f32 and
the odd shapes. The run loop on the card (a 150-item NAML fixture, f32): four
Trainer steps on host batches and on device batches, a checkpoint round
trip of CUDA tensors (exact), and full-forward scores against cached ones
(1e-5). The f32 kernels (attention_fwd_tf32 and attention_bwd_tf32, 3xTF32
on the tensor cores) at the shapes their fragments and chunk skipping make
risky (TF32_CASES: T 1, 9, 33 and 117, not multiples of the 16-row and
8-key fragments; dh 8 and 128, the backward keeping pd and dS in shared
memory at the narrow widths and recomputing them at 128; B * H far below
and above the SMs; packed, causal, key-validity and broadcast biases), and
the backward at head width 128: T 128 (the Llama training page), 117 and
116, with and without dropout; the keep mask both apply read back as in
bf16; the long-sequence pool (additive_pool_long) at L 129, 495 and
1,023, f32 and bf16, all-masked items exactly 0; both tile kernels
(additive_pool_kernel, additive_pool_long) at chip_smoke.py's edge cases
(L 129 to 4,096 over N 1, 7, 131 and 600; D 4 / 20 / 100, H 1 / 33 /
100 / 300), each call twice and bit-equal. The LM knobs: fused_qkv and norm_bf16 in the BERT,
Llama and OPT slices at bf16 against the CPU (2e-2), the `ffn` and `dots`
page remat against `full` (1e-5, the attention launched twice a page);
the pool at L 4 (an item's semantic codes). The attention forward and
backward at a TP rank's heads (half the heads at their head offset) equal
the whole call's head slice bit for bit and the plain versions. The
attention kernels on a pp stage's microbatch (bert-naml's trained slice,
bf16 and f32; the Llama-7B width's causal page) equal the same rows of
the whole call bit for bit.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from legommenders_tpu_torch.ops.additive import (  # noqa: E402
    additive_pool, additive_pool_backward_reference, additive_pool_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(N, L, D, H, device, dtype=torch.float32):
    g = torch.Generator(device=device).manual_seed(N + L + D + H)
    x = torch.randn(N, L, D, generator=g, device=device).to(dtype)
    mask = (torch.rand(N, L, generator=g, device=device) < 0.7).float()
    mask[0] = 0.0
    w1 = torch.randn(D, H, generator=g, device=device) / D ** 0.5
    b1 = torch.randn(H, generator=g, device=device) * 0.1
    w2 = torch.randn(H, generator=g, device=device) / H ** 0.5
    return x, mask, w1, b1, w2


@pytest.mark.parametrize("N,L,D,H", [(37, 13, 16, 32), (300, 50, 64, 256),
                                     (5, 1, 8, 300)])
def test_kernel_matches_plain(device, N, L, D, H):
    args = _inputs(N, L, D, H, device)
    before = additive_pool.launches
    with torch.no_grad():
        got = additive_pool(*args)
        want = additive_pool_reference(*args)
    torch.cuda.synchronize()
    assert additive_pool.launches == before + 1
    assert (got - want).abs().max().item() <= 1e-5
    assert (got[0] == 0).all()


def test_kernel_bf16_output(device):
    args = _inputs(64, 31, 64, 256, device, torch.bfloat16)
    with torch.no_grad():
        got = additive_pool(*args)
        want = additive_pool_reference(args[0].float(), *args[1:])
    assert got.dtype == torch.bfloat16
    err = (got.float() - want).abs().max() / want.abs().max()
    assert err.item() <= 2e-2


def test_wrapper_refuses(device):
    x, mask, w1, b1, w2 = _inputs(8, 5, 16, 32, device)
    with pytest.raises(ValueError, match="contiguous"):
        additive_pool(x.transpose(0, 1), mask, w1, b1, w2)
    with pytest.raises(TypeError, match="dtype"):
        additive_pool(x.half(), mask, w1, b1, w2)
    with pytest.raises(ValueError, match="shape"):
        additive_pool(x, mask[:, :4], w1, b1, w2)
    with pytest.raises(ValueError, match="multiple of 4"):
        additive_pool(x[..., :6].contiguous(), mask, w1[:6], b1, w2)
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros(1, 8, 256, device=device)
        additive_pool(big, torch.ones(1, 8, device=device),
                      torch.zeros(256, 1024, device=device),
                      torch.zeros(1024, device=device),
                      torch.zeros(1024, device=device))
    with pytest.raises(ValueError, match="on cpu"):
        additive_pool(x, mask.cpu(), w1, b1, w2)
    # under grad the kernel runs and the plain backward follows it
    w1.requires_grad_(True)
    before = additive_pool.launches
    out = additive_pool(x, mask, w1, b1, w2)
    assert additive_pool.launches == before + 1
    g = torch.randn_like(out)
    (dw1,) = torch.autograd.grad(out, (w1,), g)
    want = additive_pool_backward_reference(x, mask, w1.detach(), b1, w2, g)
    assert (dw1 - want[1]).abs().max().item() <= 1e-5


# ---------------------------------------------------------------------------
# the tensor-core pool (additive_pool_tc): bf16, whole items per 128-row tile
# ---------------------------------------------------------------------------
from legommenders_tpu_torch.ops.additive import (  # noqa: E402
    LONG_KERNEL, SIMT_KERNEL, TC_KERNEL, pool_kernel,
)

SMS = 132  # the H100's persistent grid


def _pool_tc_ns(L):
    """N = 1, G - 1, G, G + 1 (around one tile), a page and one more item,
    and three waves of tiles over the persistent grid, ragged."""
    G = 128 // L
    return sorted({1, max(G - 1, 1), G, G + 1, 512, 513, 3 * SMS * G + 7})


# every L a main path pools at (D 64, H 256), at each N of _pool_tc_ns
TC_POOL_CASES = [(N, L) for L in (31, 34, 40, 50) for N in _pool_tc_ns(L)]


def _pool_tc_inputs(N, L, device, H=256, bf16_w1=True):
    """bf16 x; W1 rounded to bf16 values, as AdditiveAttention hands it
    over (bf16_w1), or left f32; item 0 all masked, unless it is the only
    one."""
    x, mask, w1, b1, w2 = _inputs(N, L, 64, H, device, torch.bfloat16)
    if N == 1:
        mask[0, ::2] = 1.0
    if bf16_w1:
        w1 = w1.to(torch.bfloat16).float()
    return x, mask, w1, b1, w2


def _pool_tc_check(args):
    """The pool of args against the plain version in f32 from the same
    inputs, within 2e-2 of the largest output; one launch; all-masked items
    exactly 0. Returns the output."""
    x, mask = args[0], args[1]
    before = additive_pool.launches
    with torch.no_grad():
        got = additive_pool(*args)
        want = additive_pool_reference(x.float(), *args[1:])
    torch.cuda.synchronize()
    assert additive_pool.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (x.shape[0], 64)
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want).abs().max() / want.abs().max()
    assert err.item() <= 2e-2
    assert (got[mask.sum(dim=1) == 0] == 0).all()
    return got


@pytest.mark.parametrize("N,L", TC_POOL_CASES)
def test_tc_pool_matches_plain(device, N, L):
    assert pool_kernel(torch.bfloat16, L, 64, 256)[0] == TC_KERNEL
    _pool_tc_check(_pool_tc_inputs(N, L, device))


def _masked_items_inputs(device, N=300, L=31):
    """Every third item all masked, every third one valid at one position
    only, the rest with random holes."""
    x, mask, w1, b1, w2 = _pool_tc_inputs(N, L, device)
    g = torch.Generator(device="cpu").manual_seed(3)
    pos = torch.randint(0, L, (len(range(1, N, 3)),), generator=g).to(device)
    mask[0::3] = 0.0
    mask[1::3] = 0.0
    mask[torch.arange(1, N, 3, device=device), pos] = 1.0
    return (x, mask, w1, b1, w2), pos


def test_tc_pool_all_masked_and_single_position_items(device):
    args, pos = _masked_items_inputs(device)
    got = _pool_tc_check(args)
    x = args[0]
    assert (got[0::3] == 0).all()
    # one valid position: its weight is 1 / (1 + EPS), so out is that row
    rows = torch.arange(1, x.shape[0], 3, device=device)
    one = x[rows, pos].float()
    assert (got[1::3].float() - one).abs().max() <= 2e-2 * one.abs().max()


def test_tc_pool_w1_not_bf16_exact(device):
    """An f32 W1 (chip_smoke's pool inputs draw one) is rounded to bf16
    once in the kernel: still within the bf16 gate."""
    args = _pool_tc_inputs(513, 31, device, bf16_w1=False)
    assert not torch.equal(args[2], args[2].to(torch.bfloat16).float())
    _pool_tc_check(args)


def test_tc_pool_unaligned_views(device):
    """x, mask and W1 as views that start off the 16 bytes TMA and the bulk
    copy need: the wrapper hands the kernel aligned copies, each held until
    the launch is enqueued (none may take another's freed memory)."""
    x, mask, w1, b1, w2 = _pool_tc_inputs(513, 31, device)

    def shifted(t, by):
        buf = torch.empty(t.numel() + by, dtype=t.dtype, device=device)
        view = buf[by:].view(t.shape)
        view.copy_(t)
        return view

    args = (shifted(x, 1), shifted(mask, 1), shifted(w1, 1), b1, w2)
    assert all(t.data_ptr() % 16 for t in args[:3])
    got = _pool_tc_check(args)
    assert torch.equal(got, additive_pool(x, mask, w1, b1, w2))


@pytest.mark.parametrize("N", [1, 300])
def test_tc_pool_one_item_per_tile(device, N):
    """L = 128: G = 1, the whole 128-row tile one item."""
    assert pool_kernel(torch.bfloat16, 128, 64, 256) == (TC_KERNEL, 1)
    _pool_tc_check(_pool_tc_inputs(N, 128, device))


@pytest.mark.parametrize("H", [64, 128, 192])
def test_tc_pool_other_hidden_widths(device, H):
    """The kernel's other instances: H / 64 groups of 64 columns."""
    assert pool_kernel(torch.bfloat16, 31, 64, H)[0] == TC_KERNEL
    _pool_tc_check(_pool_tc_inputs(300, 31, device, H=H))


# the news zoo's pools (D 64): LSTUR's category (L 1, 128 items a tile)
# and title (L 30) at H 256; Fastformer's and MINER's items (L 31-34
# around the ConcatInputer's slots) and Fastformer's users (L 50) at H 64;
# N around one tile, a page and more tiles than the grid
ZOO_POOL_CASES = ([(N, L, 256) for L in (1, 30) for N in _pool_tc_ns(L)]
                  + [(N, L, 64) for L in (32, 33, 34, 50)
                     for N in _pool_tc_ns(L)])


@pytest.mark.parametrize("N,L,H", ZOO_POOL_CASES)
def test_tc_pool_zoo_shapes_match_plain(device, N, L, H):
    assert pool_kernel(torch.bfloat16, L, 64, H) == (TC_KERNEL, 128 // L)
    _pool_tc_check(_pool_tc_inputs(N, L, device, H=H))


def test_pool_kernels_by_profiled_name(device):
    """Under torch.profiler: every tensor-core case above launches
    additive_pool_tc, and f32 and the odd shapes launch
    additive_pool_kernel (f32 within 1e-5, bf16 within 2e-2), and L > 128
    launches additive_pool_long."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tc = [_pool_tc_inputs(N, L, device) for N, L in TC_POOL_CASES]
    tc += [_masked_items_inputs(device)[0],
           _pool_tc_inputs(513, 31, device, bf16_w1=False),
           _pool_tc_inputs(300, 128, device)]
    tc += [_pool_tc_inputs(300, 31, device, H=H) for H in (64, 128, 192)]
    simt = [_inputs(N, L, D, H, device, dt) for N, L, D, H, dt in (
        (37, 13, 16, 32, torch.float32), (300, 50, 64, 256, torch.float32),
        (5, 1, 8, 300, torch.float32), (513, 31, 64, 256, torch.float32),
        (37, 13, 16, 32, torch.bfloat16), (5, 1, 8, 300, torch.bfloat16),
        (9, 31, 64, 96, torch.bfloat16))]
    for args in tc:
        assert pool_kernel(args[0].dtype, *args[0].shape[1:],
                           args[2].shape[1])[0] == TC_KERNEL
    for args in simt:
        assert pool_kernel(args[0].dtype, *args[0].shape[1:],
                           args[2].shape[1])[0] == SIMT_KERNEL
    # past one tile, either dtype: the long-sequence kernel
    long = [_inputs(N, L, 64, H, device, dt) for N, L, H, dt in (
        (5, 129, 256, torch.bfloat16), (7, 495, 64, torch.float32))]
    torch.cuda.synchronize()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        outs = [additive_pool(*args) for args in tc + simt + long]
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    def launches(name):
        return sum(e.count for e in evs if name in e.key)

    assert launches(TC_KERNEL) == len(tc)
    assert launches(SIMT_KERNEL) == len(simt)
    assert launches(LONG_KERNEL) == len(long)
    with torch.no_grad():
        for args, got in zip(simt, outs[len(tc):]):
            want = additive_pool_reference(args[0].float(), *args[1:])
            err = (got.float() - want).abs().max()
            if args[0].dtype == torch.float32:
                assert err.item() <= 1e-5
            else:
                assert (err / want.abs().max()).item() <= 2e-2


# ---------------------------------------------------------------------------
# packed attention (csrc/packed_attention.cu)
# ---------------------------------------------------------------------------
from legommenders_tpu_torch.models.lm.layers import (  # noqa: E402
    causal_mask_bias, pack_items, packed_mask_bias,
)
from legommenders_tpu_torch.ops.attention import (  # noqa: E402
    dropout_bits_reference, dropout_keep_mask,
    keep_threshold, packed_attention, packed_attention_backward,
    reference_attention, reference_attention_backward,
)


def _attn_inputs(B, T, D, device, dtype, packed_L=0, seed=0):
    """q, k, v ~ N(0, 1); bias: block-diagonal over items of L = packed_L
    tokens of random length (packed_mask_bias), or key validity."""
    g = torch.Generator(device="cpu").manual_seed(seed + B + T + D)
    q, k, v = (torch.randn(B, T, D, generator=g).to(device, dtype)
               for _ in range(3))
    if packed_L:
        G = T // packed_L
        lens = torch.randint(1, packed_L + 1, (B * G,), generator=g)
        mask = (torch.arange(packed_L)[None] < lens[:, None]).int()
        _, mask_p, _ = pack_items(torch.zeros(B * G, packed_L, 1), mask, G)
        bias = packed_mask_bias(mask_p, packed_L, dtype)[:, 0]
    else:
        lens = torch.randint(1, T + 1, (B,), generator=g)
        valid = torch.arange(T)[None] < lens[:, None]
        neg = torch.finfo(dtype).min
        bias = torch.where(valid, 0.0, neg)[:, None].expand(B, T, T)
        bias = bias.to(dtype).contiguous()
    return q, k, v, bias.to(device)


# (B, T, heads, dh, packed_L): odd B and T, every head width of the bf16
# kernel in both types, and two more head widths in f32
ATTN_SHAPES = [(5, 102, 12, 64, 34), (3, 117, 2, 16, 13), (7, 9, 4, 32, 0),
               (2, 128, 2, 128, 0), (1, 1, 3, 64, 0)]
ATTN_CASES = ([s + (dt,) for s in ATTN_SHAPES for dt in ("f32", "bf16")]
              + [(4, 33, 3, 24, 11, "f32"), (6, 70, 2, 40, 0, "f32")])


@pytest.mark.parametrize("B,T,heads,dh,L,dtype", ATTN_CASES)
def test_attention_kernel_matches_plain(device, B, T, heads, dh, L, dtype):
    """f32 within 1e-5 absolute; bf16 within 2e-2 of the largest output of
    the plain version on the same bf16 inputs."""
    tdtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    q, k, v, bias = _attn_inputs(B, T, heads * dh, device, tdtype, L)
    before = packed_attention.launches
    with torch.no_grad():
        got = packed_attention(heads, 0.0, q, k, v, bias)
        want = reference_attention(heads, 0.0, q, k, v, bias)
    torch.cuda.synchronize()
    assert packed_attention.launches == before + 1
    assert got.dtype == tdtype and got.shape == q.shape
    err = (got.float() - want.float()).abs().max().item()
    if dtype == "f32":
        assert err <= 1e-5
    else:
        assert err <= 2e-2 * want.float().abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_masked_keys_get_zero_weight(device, dtype):
    """Values at masked keys are huge: a weight above zero would show. The
    bias is a broadcast view (stride 0 over the query rows) and f32."""
    B, T, heads, dh = 4, 50, 2, 64
    q, k, v, _ = _attn_inputs(B, T, heads * dh, device, dtype)
    valid = torch.arange(T, device=device)[None] < torch.tensor(
        [1, 20, 37, 50], device=device)[:, None]
    v[~valid] = 1e30
    bias = torch.where(valid, 0.0, torch.finfo(torch.float32).min)
    bias = bias[:, None].expand(B, T, T)
    with torch.no_grad():
        got = packed_attention(heads, 0.0, q, k, v, bias)
        want = reference_attention(heads, 0.0, q, k, v, bias)
    assert torch.isfinite(got.float()).all()
    assert got.float().abs().max().item() < 100.0
    tol = 1e-5 if dtype == torch.float32 else 2e-2 * want.float().abs().max()
    assert (got.float() - want.float()).abs().max().item() <= tol


def test_attention_wrapper_refuses(device):
    q, k, v, bias = _attn_inputs(3, 10, 32, device, torch.bfloat16)
    with pytest.raises(ValueError, match="needs a seed"):
        packed_attention(2, 0.1, q, k, v, bias)
    with pytest.raises(TypeError, match="int32"):
        packed_attention(2, 0.1, q, k, v, bias,
                         torch.zeros(1, dtype=torch.int64, device=device))
    with pytest.raises(ValueError, match="seed on cpu"):
        packed_attention(2, 0.1, q, k, v, bias,
                         torch.zeros(1, dtype=torch.int32))
    big = torch.zeros(1, 129, 32, device=device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="T=129"):
        packed_attention(2, 0.0, big, big, big,
                         torch.zeros(1, 129, 129, device=device))
    with pytest.raises(ValueError, match="multiple of num_heads"):
        packed_attention(3, 0.0, q, k, v, bias)
    with pytest.raises(ValueError, match="head widths"):
        packed_attention(4, 0.0, q, k, v, bias)
    with pytest.raises(ValueError, match="shape"):
        packed_attention(2, 0.0, q, k[:, :9], v, bias)
    with pytest.raises(ValueError, match="shape"):
        packed_attention(2, 0.0, q, k, v, bias[:, :, :9])
    with pytest.raises(TypeError, match="f32/bf16"):
        packed_attention(2, 0.0, q.half(), k.half(), v.half(), bias)
    with pytest.raises(TypeError, match="differ"):
        packed_attention(2, 0.0, q, k.float(), v, bias)
    with pytest.raises(TypeError, match="bias dtype"):
        packed_attention(2, 0.0, q.float(), k.float(), v.float(), bias)
    with pytest.raises(ValueError, match="on cpu"):
        packed_attention(2, 0.0, q, k, v, bias.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        packed_attention(2, 0.0, q.transpose(0, 1).contiguous().transpose(
            0, 1), k, v, bias)
    with pytest.raises(ValueError, match="last dimension"):
        packed_attention(2, 0.0, q, k, v, bias.transpose(1, 2))
    flat = torch.zeros(q.numel() + 1, device=device, dtype=q.dtype)
    with pytest.raises(ValueError, match="aligned"):
        packed_attention(2, 0.0, flat[1:].view(q.shape), k, v, bias)
    # the f32 kernels take head widths that are multiples of 8 up to 128,
    # forward and backward: 256, 136 and 12 raise before a launch
    for dh in (256, 136, 12):
        wide = torch.zeros(1, 128, 2 * dh, device=device)
        bias0 = torch.zeros(1, 128, 128, device=device)
        before = (packed_attention.launches,
                  packed_attention_backward.launches)
        with pytest.raises(ValueError, match="multiples of 8 up to 128"):
            packed_attention(2, 0.0, wide, wide, wide, bias0)
        with pytest.raises(ValueError, match="multiples of 8 up to 128"):
            packed_attention_backward(2, 0.0, wide, wide, wide, bias0, None,
                                      wide)
        assert (packed_attention.launches,
                packed_attention_backward.launches) == before


# ---------------------------------------------------------------------------
# dropout, backward and keep mask
# ---------------------------------------------------------------------------
def _close(got, want, dtype):
    err = (got.float() - want.float()).abs().max().item()
    if dtype == "f32":
        return err <= 1e-5
    return err <= 2e-2 * want.float().abs().max().item()


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("B,T,heads,dh,L,dtype", ATTN_CASES)
def test_attention_dropout_and_backward_match_plain(device, B, T, heads, dh,
                                                    L, dtype, p):
    """The forward at dropout p and the backward (dq, dk, dv) against the
    plain versions with the mask the mask kernel draws for the seed."""
    tdtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    q, k, v, bias = _attn_inputs(B, T, heads * dh, device, tdtype, L, seed=1)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(T)
                    ).to(device, tdtype)
    seed = torch.tensor([1234 + T], dtype=torch.int32, device=device)
    keep = dropout_keep_mask(heads, p, B, T, seed) if p > 0 else None
    with torch.no_grad():
        got = packed_attention(heads, p, q, k, v, bias, seed)
        want = reference_attention(heads, p, q, k, v, bias, keep)
    assert _close(got, want, dtype)
    before = packed_attention_backward.launches
    got = packed_attention_backward(heads, p, q, k, v, bias, seed, g)
    want = reference_attention_backward(heads, p, q, k, v, bias, g, keep)
    torch.cuda.synchronize()
    assert packed_attention_backward.launches == before + 1
    for a, b in zip(got, want):
        assert a.dtype == tdtype and a.shape == q.shape
        assert torch.isfinite(a.float()).all()
        assert _close(a, b, dtype)


# (B, T, heads, dh, packed_L, dtype) of a whole page cut in two by heads, as
# a TP rank at mp 2 runs it: bert-naml's training page, the Llama one
HEAD_OFFSET_CASES = [(171, 120, 12, 64, 40, "bf16"),
                     (171, 120, 12, 64, 40, "f32"),
                     (5, 128, 32, 128, 32, "bf16")]


@pytest.mark.parametrize("B,T,heads,dh,L,dtype", HEAD_OFFSET_CASES)
def test_attention_at_head_offset_is_the_whole_calls_slice(device, B, T,
                                                           heads, dh, L,
                                                           dtype):
    """Each half of the heads at its head offset, dropout 0.1: the forward
    and the backward equal the whole call's head slice bit for bit (each
    head is computed alike) and the plain versions given the mask
    kernel's mask at that offset."""
    tdtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    q, k, v, bias = _attn_inputs(B, T, heads * dh, device, tdtype, L, seed=2)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(T)
                    ).to(device, tdtype)
    seed = torch.tensor([4321], dtype=torch.int32, device=device)
    with torch.no_grad():
        whole = (packed_attention(heads, 0.1, q, k, v, bias, seed),) + tuple(
            packed_attention_backward(heads, 0.1, q, k, v, bias, seed, g))
        half, width = heads // 2, heads // 2 * dh
        for r in range(2):
            cols = slice(r * width, (r + 1) * width)
            qr, kr, vr, gr = (t[..., cols].contiguous() for t in (q, k, v, g))
            keep = dropout_keep_mask(half, 0.1, B, T, seed,
                                     head_offset=r * half)
            got = (packed_attention(half, 0.1, qr, kr, vr, bias, seed,
                                    head_offset=r * half),) + tuple(
                packed_attention_backward(half, 0.1, qr, kr, vr, bias, seed,
                                          gr, head_offset=r * half))
            want = (reference_attention(half, 0.1, qr, kr, vr, bias,
                                        keep),) + tuple(
                reference_attention_backward(half, 0.1, qr, kr, vr, bias,
                                             gr, keep))
            torch.cuda.synchronize()
            for a, w, b in zip(got, whole, want):
                assert torch.equal(a, w[..., cols])
                assert _close(a, b, dtype)


# (B, T, heads, dh, dtype, causal) of a pp stage's microbatches: bert-naml's
# trained slice at pp 2 (a page of 512 items of T 40, unpacked, in 4
# microbatches of 128) and the Llama-7B-width slice's causal page of 128
# rows of T 128 (4 microbatches of 32)
PP_CASES = [(512, 40, 12, 64, "bf16", False), (512, 40, 12, 64, "f32", False),
            (128, 128, 32, 128, "bf16", True)]


@pytest.mark.parametrize("B,T,heads,dh,dtype,causal", PP_CASES)
def test_attention_on_a_pp_microbatch_is_the_whole_calls_rows(
        device, B, T, heads, dh, dtype, causal):
    """A pp stage runs the attention kernels on each microbatch's rows:
    the forward and the backward of each of the 4 microbatches equal the
    same rows of the whole call bit for bit (each row is computed alike;
    dropout 0, as a staged stack's parity is held)."""
    tdtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    q, k, v, bias = _attn_inputs(B, T, heads * dh, device, tdtype, seed=3)
    if causal:
        bias = causal_mask_bias(torch.ones(B, T, dtype=torch.int32),
                                tdtype)[:, 0].contiguous().to(device)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(B)
                    ).to(device, tdtype)
    with torch.no_grad():
        whole = (packed_attention(heads, 0.0, q, k, v, bias),) + tuple(
            packed_attention_backward(heads, 0.0, q, k, v, bias, None, g))
        mb = B // 4
        for m in range(4):
            rows = slice(m * mb, (m + 1) * mb)
            qm, km, vm, bm, gm = (t[rows].contiguous()
                                  for t in (q, k, v, bias, g))
            got = (packed_attention(heads, 0.0, qm, km, vm, bm),) + tuple(
                packed_attention_backward(heads, 0.0, qm, km, vm, bm, None,
                                          gm))
            torch.cuda.synchronize()
            for a, w in zip(got, whole):
                assert torch.equal(a, w[rows])


def test_attention_autograd_runs_both_kernels(device):
    """packed_attention under autograd: one forward and one backward
    launch, the gradients those of the plain backward."""
    q, k, v, bias = _attn_inputs(5, 120, 12 * 64, device, torch.bfloat16, 40)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    seed = torch.tensor([7], dtype=torch.int32, device=device)
    f0, b0 = packed_attention.launches, packed_attention_backward.launches
    out = packed_attention(12, 0.1, q, k, v, bias, seed)
    g = torch.randn_like(out)
    grads = torch.autograd.grad(out, (q, k, v), g)
    torch.cuda.synchronize()
    assert packed_attention.launches == f0 + 1
    assert packed_attention_backward.launches == b0 + 1
    keep = dropout_keep_mask(12, 0.1, 5, 120, seed)
    want = reference_attention_backward(12, 0.1, q.detach(), k.detach(),
                                        v.detach(), bias, g, keep)
    for a, b in zip(grads, want):
        assert _close(a, b, "bf16")


# "at bits": the threshold set to one element's bits (kept: bits >= it)
@pytest.mark.parametrize("B,T,heads,p,side_stream", [
    (3, 120, 12, 0.1, False), (2, 9, 2, 0.1, False), (1, 128, 3, 0.1, False),
    (4, 1, 2, 0.1, False), (5, 33, 4, 0.1, False),
    # the serving page's T (byte stores, staged), B * H above the persistent
    # grid (4 CTAs per SM); the training page on a stream of its own
    (171, 102, 12, 0.1, False), (171, 120, 12, 0.1, True),
    # T > 128: staged (129), 8-byte stores (200), and T = 170, whose two
    # staged copies would not fit, straight to device memory
    (2, 129, 3, 0.1, False), (3, 200, 2, 0.5, False),
    (2, 170, 2, 0.1, False),
    # byte stores staged (124, 4 mod 8) and straight to device memory (164,
    # 4 mod 8; 157, odd); more column blocks than a CTA's threads (2049
    # bytes, 2056 8-byte stores)
    (3, 124, 2, 0.1, False), (2, 164, 2, 0.1, False),
    (2, 157, 3, 0.1, False), (1, 2049, 1, 0.1, False),
    (1, 2056, 2, 0.1, False),
    (6, 64, 12, 1e-4, False), (8, 64, 4, 0.999, False),
    (4, 120, 2, "at bits", False), (2, 102, 12, "at bits", True),
])
def test_keep_mask_kernel_matches_plain_philox(device, B, T, heads, p,
                                               side_stream):
    """Exact agreement with the plain Philox, at any T, on any stream; the
    same seed gives the same mask, another seed another; the keep fraction
    within 4 sigma of 1 - p."""
    seed = torch.tensor([99 + T], dtype=torch.int32, device=device)
    bits = dropout_bits_reference(heads, B, T, 99 + T, device)
    at = (B - 1, heads - 1, T - 1, T // 2)
    if p == "at bits":
        p = int(bits[at]) / 2.0 ** 32
        assert keep_threshold(p) == int(bits[at])
    want = bits >= keep_threshold(p)
    del bits
    stream = torch.cuda.Stream(device) if side_stream else \
        torch.cuda.current_stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    before = dropout_keep_mask.launches
    with torch.cuda.stream(stream):
        got = dropout_keep_mask(heads, p, B, T, seed)
    stream.synchronize()
    assert dropout_keep_mask.launches == before + 1
    assert got.dtype == torch.bool and got.view(torch.uint8).max() <= 1
    assert torch.equal(got, want)
    assert bool(got[at]) == bool(want[at])
    assert torch.equal(got, dropout_keep_mask(heads, p, B, T, seed))
    n = got.numel()
    if n >= 1000:
        other = dropout_keep_mask(heads, p, B, T, seed + 1)
        assert not torch.equal(got, other)
        frac = got.float().mean().item()
        assert abs(frac - (1 - p)) <= 4 * (p * (1 - p) / n) ** 0.5


# ---------------------------------------------------------------------------
# the tensor-core kernels' schedule and loads: persistent grid, TMA boxes of
# 128 rows zero-filled past T, the bias staged in shared memory
# ---------------------------------------------------------------------------
# (B, T, heads, dh, packed_L, bias): "bf16" contiguous in q's type,
# "broadcast" a bf16 view with stride 0 over the query rows, "f32" an f32
# bias beside bf16 q. bert-naml's training page (171 rows of T = 120, 12
# heads of 64) and serving page (T = 102: bf16 bias rows of 204 B, not a
# multiple of 16 B); B * H above (300) and below (1) the grid; T at and
# around the 64-row query tiles; every head width.
TC_CASES = [(171, 120, 12, 64, 40, "bf16"), (171, 102, 12, 64, 34, "bf16"),
            (300, 50, 1, 64, 0, "bf16"), (1, 77, 1, 64, 0, "bf16"),
            (3, 1, 2, 64, 0, "bf16"), (3, 8, 2, 64, 0, "f32"),
            (3, 63, 2, 64, 0, "bf16"), (3, 64, 2, 64, 0, "broadcast"),
            (3, 65, 2, 64, 0, "bf16"), (3, 127, 2, 64, 0, "f32"),
            (3, 128, 2, 64, 0, "bf16"), (4, 65, 3, 16, 13, "bf16"),
            (4, 127, 2, 32, 0, "broadcast"), (2, 63, 2, 128, 0, "f32"),
            (2, 128, 2, 128, 0, "broadcast"), (6, 96, 2, 16, 32, "f32"),
            (5, 8, 3, 32, 0, "bf16"),
            # dh 128 with an f32 bias past T ~88: the backward reads the
            # bias from device memory (no slot for it in shared memory)
            (2, 128, 2, 128, 0, "f32")]


def _tc_inputs(B, T, heads, dh, L, bias_kind, device):
    q, k, v, bias = _attn_inputs(B, T, heads * dh, device, torch.bfloat16, L,
                                 seed=2)
    btype = torch.float32 if bias_kind == "f32" else torch.bfloat16
    if L:
        G = T // L
        g = torch.Generator(device="cpu").manual_seed(B + T)
        lens = torch.randint(1, L + 1, (B * G,), generator=g)
        mask = (torch.arange(L)[None] < lens[:, None]).int()
        _, mask_p, _ = pack_items(torch.zeros(B * G, L, 1), mask, G)
        bias = packed_mask_bias(mask_p, L, btype)[:, 0].to(device)
    elif bias_kind == "broadcast":
        bias = bias[:, :1].expand(B, T, T)
        assert bias.stride(1) == 0
    else:
        bias = bias.to(btype)
    return q, k, v, bias


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("B,T,heads,dh,L,bias_kind", TC_CASES)
def test_tc_attention_shapes_match_plain(device, B, T, heads, dh, L,
                                         bias_kind, p):
    """The bf16 forward and backward against the plain versions given the
    mask kernel's mask, within 2e-2 of the largest output."""
    q, k, v, bias = _tc_inputs(B, T, heads, dh, L, bias_kind, device)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(B)
                    ).to(device, torch.bfloat16)
    seed = torch.tensor([4321 + T], dtype=torch.int32, device=device)
    keep = dropout_keep_mask(heads, p, B, T, seed) if p > 0 else None
    f0, b0 = packed_attention.launches, packed_attention_backward.launches
    with torch.no_grad():
        got = packed_attention(heads, p, q, k, v, bias, seed)
        want = reference_attention(heads, p, q, k, v, bias, keep)
        grads = packed_attention_backward(heads, p, q, k, v, bias, seed, g)
        wgrads = reference_attention_backward(heads, p, q, k, v, bias, g, keep)
    torch.cuda.synchronize()
    assert packed_attention.launches == f0 + 1
    assert packed_attention_backward.launches == b0 + 1
    for a, b in ((got, want),) + tuple(zip(grads, wgrads)):
        assert a.dtype == torch.bfloat16 and a.shape == q.shape
        assert torch.isfinite(a.float()).all()
        assert _close(a, b, "bf16")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,T,heads,dh", [(3, 64, 2, 64), (4, 37, 2, 64),
                                          (5, 120, 3, 128), (2, 16, 2, 16),
                                          (3, 117, 2, 128), (2, 9, 3, 16)])
def test_tc_keep_mask_is_the_mask_kernels(device, B, T, heads, dh, dtype):
    """The keep mask the forward and the backward apply (the bf16 and the
    f32 kernels), read back exactly: with q = k = 0 and a zero bias every
    weight is 1/T, and with v (or g) the identity over the keys out[i, j]
    (dv[j, i]) is above 0 iff element (i, j) is kept. It must equal the
    mask kernel's bit for bit."""
    p = 0.1
    D = heads * dh
    z = torch.zeros(B, T, D, device=device, dtype=dtype)
    eye = torch.zeros(B, T, heads, dh, device=device, dtype=dtype)
    idx = torch.arange(T, device=device)
    eye[:, idx, :, idx] = 1.0
    eye = eye.reshape(B, T, D)
    bias = torch.zeros(B, T, T, device=device, dtype=dtype)
    seed = torch.tensor([777 + T], dtype=torch.int32, device=device)
    keep = dropout_keep_mask(heads, p, B, T, seed)
    with torch.no_grad():
        out = packed_attention(heads, p, z, z, eye, bias, seed)
        _, _, dv = packed_attention_backward(heads, p, z, z, z, bias, seed,
                                             eye)
    fwd = out.reshape(B, T, heads, dh)[..., :T].permute(0, 2, 1, 3) > 0
    bwd = dv.reshape(B, T, heads, dh)[..., :T].permute(0, 2, 3, 1) > 0
    assert torch.equal(fwd, keep)
    assert torch.equal(bwd, keep)


# ---------------------------------------------------------------------------
# the f32 kernels (3xTF32 mma.sync): 16-row and 8-key fragments, chunks the
# bias masks skipped, operands in padded shared-memory rows
# ---------------------------------------------------------------------------
# (B, T, heads, dh, packed_L, bias): "packed" block-diagonal items of
# packed_L, "causal" those items causal, "keys" key validity (one row per
# packed row, contiguous), "broadcast" key validity as a view with stride 0
# over the query rows. T 1, 9, 33 and 117 are not multiples of the
# fragments; dh 8 and 128 the narrowest and widest; 1 x 1 (b, h) items far
# below the SMs, 300 x 4 far above.
TF32_CASES = [(4, 1, 2, 64, 0, "keys"), (3, 9, 2, 8, 0, "broadcast"),
              (5, 33, 3, 24, 11, "packed"), (3, 117, 2, 128, 39, "causal"),
              (1, 117, 1, 64, 39, "packed"), (300, 50, 4, 32, 0, "keys"),
              (2, 128, 2, 128, 0, "broadcast"), (6, 120, 2, 8, 40, "causal"),
              (2, 9, 1, 128, 0, "keys"), (171, 102, 12, 64, 34, "packed")]


def _tf32_inputs(B, T, heads, dh, L, bias_kind, device):
    q, k, v, bias = _attn_inputs(B, T, heads * dh, device, torch.float32,
                                 L if bias_kind == "packed" else 0, seed=4)
    if bias_kind == "causal":
        bias = _causal_inputs(B, T, heads, dh, L, device, torch.float32)[3]
    elif bias_kind == "broadcast":
        bias = bias[:, :1].expand(B, T, T)
        assert T == 1 or bias.stride(1) == 0
    return q, k, v, bias


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("B,T,heads,dh,L,bias_kind", TF32_CASES)
def test_tf32_attention_shapes_match_plain(device, B, T, heads, dh, L,
                                           bias_kind, p):
    """The f32 forward and backward against the plain versions given the
    mask kernel's mask, within 1e-5 (values O(1))."""
    q, k, v, bias = _tf32_inputs(B, T, heads, dh, L, bias_kind, device)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(B)
                    ).to(device)
    seed = torch.tensor([5151 + T], dtype=torch.int32, device=device)
    keep = dropout_keep_mask(heads, p, B, T, seed) if p > 0 else None
    f0, b0 = packed_attention.launches, packed_attention_backward.launches
    with torch.no_grad():
        got = packed_attention(heads, p, q, k, v, bias, seed)
        want = reference_attention(heads, p, q, k, v, bias, keep)
        grads = packed_attention_backward(heads, p, q, k, v, bias, seed, g)
        wgrads = reference_attention_backward(heads, p, q, k, v, bias, g, keep)
    torch.cuda.synchronize()
    assert packed_attention.launches == f0 + 1
    assert packed_attention_backward.launches == b0 + 1
    for a, b in ((got, want),) + tuple(zip(grads, wgrads)):
        assert a.dtype == torch.float32 and a.shape == q.shape
        assert torch.isfinite(a).all()
        assert _close(a, b, "f32")


# --------------------------------------------------------------------- #
# the run loop on the card                                              #
# --------------------------------------------------------------------- #
RUN_DATA = dict(num_items=150, num_users=60, title_len=10, history_len=8,
                vocab_size=300, inters_per_user=12)
RUN_CFG = {
    "meta": {"item": "CNN", "user": "Ada", "predictor": "Dot"},
    "config": {"use_item_content": True, "hidden_size": 16,
               "cache_page_size": 64,
               "item_config": {"dropout": 0.1, "kernel_size": 3,
                               "additive_hidden_size": 32},
               "user_config": {"additive_hidden_size": 32}},
}


def _run_manager(device, **policy):
    from legommenders_tpu_torch.data.processors.synthetic import (
        SyntheticProcessor,
    )
    from legommenders_tpu_torch.runtime.manager import Manager

    exp = {"policy": {"batch_size": 16, "eval_batch_size": 64, **policy},
           "metrics": ["GAUC", "MRR"]}
    return Manager(model_cfg=RUN_CFG, exp_cfg=exp, device=device,
                   data=SyntheticProcessor(**RUN_DATA).as_lego_data())


@pytest.mark.parametrize("device_batching", [False, True])
def test_trainer_steps_on_card(device, device_batching, tmp_path):
    """4 steps of the Trainer (host batches through the Prefetcher, or the
    device pipeline), dev through the caches, the best checkpoint saved and
    reloaded, the test: finite, on the card, the pool kernel launched."""
    from legommenders_tpu_torch.runtime.trainer import Trainer

    m = _run_manager(device, epoch=1, epoch_batch=4,
                     device_batching=device_batching)
    tr = Trainer(m, seed=0, ckpt_path=str(tmp_path / "t.ckpt"))
    before = additive_pool.launches
    out = tr.train()
    res = tr.test()
    assert tr.global_step == 4
    assert additive_pool.launches > before + 8
    assert all(p.device.type == "cuda" for p in m.model.parameters())
    assert np.isfinite(out["best_dev"])
    assert all(np.isfinite(v) for v in res.values())


def test_checkpoint_round_trip_on_card(device, tmp_path):
    from legommenders_tpu_torch.runtime import checkpoint
    from legommenders_tpu_torch.runtime.trainer import Trainer, build_optimizer

    m = _run_manager(device, epoch=1, epoch_batch=3, accumulate_batch=2)
    tr = Trainer(m, seed=0)
    tr.train()
    path = str(tmp_path / "m.ckpt")
    checkpoint.save_checkpoint(path, m.model, tr.optimizer, meta={"e": 1})
    m2 = _run_manager(device, epoch=1, epoch_batch=3, accumulate_batch=2)
    opt = build_optimizer(m2.model, m2.policy)
    assert checkpoint.load_auto(path, m2.model, opt) == {"e": 1}
    for (n, a), b in zip(m.model.state_dict().items(),
                         m2.model.state_dict().values()):
        assert b.is_cuda and torch.equal(a, b), n
    want, got = tr.optimizer.state_dict(), opt.state_dict()
    assert got["mini_step"] == want["mini_step"] == 1
    for i, st in want["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v.cpu(), got["optimizer"]["state"][i][k].cpu())
    for a, b in zip(want["acc"], got["acc"]):
        assert (a is None and b is None) or (b.is_cuda and torch.equal(a, b))


def test_full_forward_matches_cached_on_card(device):
    """f32: the full-forward scores (pages of 64, the tail padded) against
    the cached path's, within 1e-5."""
    m = _run_manager(device)
    ev = m.evaluator()
    full = ev.score_phase_device_full("test")
    m.cache.cache()
    cached = ev.score_phase_device("test")
    assert full.shape == cached.shape == (720,)
    assert (full - cached).abs().max().item() <= 1e-5


ZOO_DATA = dict(num_items=150, num_users=60, title_len=12, history_len=10,
                vocab_size=300, inters_per_user=6)


def _zoo_manager(name, device, dtype="f32"):
    from legommenders_tpu_torch.config import parser
    from legommenders_tpu_torch.data.processors.synthetic import (
        SyntheticProcessor,
    )
    from legommenders_tpu_torch.runtime.manager import Manager

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = parser.parse_four_way(
        {"model": name, "item_layers": 1, "user_layers": 1},
        config_root=os.path.join(root, "config")).raw()["model"]
    return Manager(model_cfg=cfg, device=device,
                   exp_cfg={"policy": {"batch_size": 16, "dtype": dtype}},
                   data=SyntheticProcessor(**ZOO_DATA).as_lego_data())


def _weight_of(name: str) -> str:
    """A bias's layer's weight (a pool's proj_kernel for its proj_bias).
    Some biases get a gradient that is zero, exactly or to first order:
    an attention key's (softmax does not see a shift common to every
    key), a pool's (its softmax backward's weights sum to zero, tanh' ~1
    near the init). What is left is the rounding residue of the terms the
    weight's gradient sums too, so a bias is held against the larger of
    its own largest value and its weight's."""
    if name.endswith("proj_bias"):
        return name[:-len("proj_bias")] + "proj_kernel"
    if name.endswith(".bias"):
        return name[:-len("bias")] + "weight"
    return name


def _zoo_grads(m, batch):
    from legommenders_tpu_torch.runtime import steps

    m.model.zero_grad(set_to_none=True)
    gen = torch.Generator(device=m.device).manual_seed(0)
    loss_fn = steps.make_loss_fn(m.model, m.contents.columns, True)
    loss_fn(batch, gen).backward()
    return {n: p.grad.detach().cpu() for n, p in m.model.named_parameters()
            if p.grad is not None}


@pytest.mark.parametrize("name", ["nrms", "lstur", "fastformer", "miner"])
def test_zoo_models_on_card_match_cpu(device, name):
    """A news-zoo YAML (hidden 64, 1 layer) at f32 on the card against the
    same weights on the CPU: Tester.test() metrics within 1e-4; one
    batch's gradients with the catalog plans live, at dropout 0 (the two
    devices' generators draw other masks), within 1e-4 of each tensor's
    largest value (a bias: or of its weight's, see _weight_of), and no
    tensor held tighter than 1e-4 of the model's largest gradient: at the
    init NRMS's self-attention scores are ~1e-3, its softmax uniform, so
    every position of an item leaves it as the same vector and the item
    pool's gradients are zero to first order (1e-14 here); then one bf16
    fused step on the card: finite, its plans live. TF32 off throughout.
    """
    # cuDNN's GRU and convolution otherwise take TF32 products
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        _zoo_on_card_vs_cpu(device, name)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def _zoo_on_card_vs_cpu(device, name):
    from legommenders_tpu_torch.data.device_pipeline import (
        DeviceTrainPipeline,
    )
    from legommenders_tpu_torch.ops import catalog_grad
    from legommenders_tpu_torch.runtime import steps
    from legommenders_tpu_torch.runtime.tester import Tester

    gpu, cpu = _zoo_manager(name, device), _zoo_manager(name, "cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in
                               gpu.model.state_dict().items()})
    got, want = Tester(gpu).test(), Tester(cpu).test()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])

    for m in (gpu, cpu):
        for mod in m.model.modules():
            for attr in ("dropout", "hidden_dropout_prob"):
                if isinstance(getattr(mod, attr, None), float):
                    setattr(mod, attr, 0.0)
    dp = DeviceTrainPipeline(cpu.data, batch_size=16, seed=0, device="cpu")
    batch = dp.assemble(next(dp.epoch_indices(shuffle=False)),
                        torch.Generator().manual_seed(0))
    g_cpu = _zoo_grads(cpu, batch)
    g_gpu = _zoo_grads(gpu, {k: v.to(device) for k, v in batch.items()})
    assert set(catalog_grad.last_trace["live"]) == {"title", "category"}
    assert catalog_grad.last_trace["history"]
    assert g_gpu.keys() == g_cpu.keys()
    floor = 1e-4 * max(w.abs().max().item() for w in g_cpu.values())
    for n, w in g_cpu.items():
        scale = max(w.abs().max().item(),
                    g_cpu[_weight_of(n)].abs().max().item(), floor)
        assert (g_gpu[n] - w).abs().max().item() <= 1e-4 * scale, n

    m16 = _zoo_manager(name, device, "bf16")
    dp16 = DeviceTrainPipeline(m16.data, batch_size=16, seed=0, device=device)
    step = dp16.make_fused_train_step(m16.model, m16.contents.columns,
                                      steps.adam(m16.model, 1e-3))
    catalog_grad.record_trace((), ())
    loss = step(next(dp16.epoch_indices()), 0)
    assert torch.isfinite(loss).item()
    assert set(catalog_grad.last_trace["live"]) == {"title", "category"}


# ---------------------------------------------------------------------------
# the CTR zoo's user pools at L 50, D 64: the id models' Ada pool (H 256)
# over a training step's users (2,048) and a full-forward test page's
# (8,192); bst_text's Transformer pool (H 64) over a training step's users
# ---------------------------------------------------------------------------
CTR_POOL_SHAPES = ((2048, 256), (8192, 256), (2048, 64))


@pytest.mark.parametrize("N,H", CTR_POOL_SHAPES)
def test_tc_pool_ctr_shapes_match_plain(device, N, H):
    assert pool_kernel(torch.bfloat16, 50, 64, H) == (TC_KERNEL, 2)
    _pool_tc_check(_pool_tc_inputs(N, 50, device, H=H))


@pytest.mark.parametrize("N,H", CTR_POOL_SHAPES)
def test_simt_pool_ctr_shapes_match_plain(device, N, H):
    assert pool_kernel(torch.float32, 50, 64, H)[0] == SIMT_KERNEL
    args = _inputs(N, 50, 64, H, device)
    with torch.no_grad():
        got = additive_pool(*args)
        want = additive_pool_reference(*args)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5
    assert (got[0] == 0).all()


# ---------------------------------------------------------------------------
# the long-sequence pool (additive_pool_long): every L > 128
# ---------------------------------------------------------------------------
# (N, L, H): one past a tile, the flattened histories of the flatten
# Fastformer (15 clicks of 33 slots: 495) and the flatten Transformer (31
# clicks: 1,023), D 64
LONG_POOL_CASES = [(37, 129, 256), (64, 495, 64), (300, 1023, 64),
                   (5, 1023, 256)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("N,L,H", LONG_POOL_CASES)
def test_long_pool_matches_plain(device, N, L, H, dtype):
    """additive_pool_long against the plain version: f32 within 1e-5, bf16
    within 2e-2 of the largest output; item 0 all masked gives exactly 0,
    one item masked but for its last position, one fully valid (the
    profiler's name for it: test_pool_kernels_by_profiled_name)."""
    tdtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    args = _inputs(N, L, 64, H, device, tdtype)
    x, mask = args[0], args[1]
    mask[1] = 0.0
    mask[1, -1] = 1.0
    mask[2] = 1.0
    assert pool_kernel(tdtype, L, 64, H) == (LONG_KERNEL, 1)
    before = additive_pool.launches
    with torch.no_grad():
        got = additive_pool(*args)
        want = additive_pool_reference(x.float(), *args[1:])
    torch.cuda.synchronize()
    assert additive_pool.launches == before + 1
    assert got.dtype == tdtype and got.shape == (N, 64)
    assert torch.isfinite(got.float()).all()
    assert (got[0] == 0).all()
    err = (got.float() - want).abs().max()
    if dtype == "f32":
        assert err.item() <= 1e-5
    else:
        assert (err / want.abs().max()).item() <= 2e-2


# the tile kernels (additive_pool_kernel, additive_pool_long) at their
# edges: chip_smoke.py's phase-3 cases (check_pool_edges)
import chip_smoke  # noqa: E402
from legommenders_tpu_torch.ops import additive as _additive  # noqa: E402


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("N,L,D,H", chip_smoke.pool_edge_cases())
def test_tile_pools_at_their_edges(device, N, L, D, H, dtype):
    """additive_pool_long at L around its tiles of 128 positions over N 1,
    7 and 131 (an item spread over several CTAs) and 600 (an item on one
    CTA), with an all-masked item, one valid only in its last tile, one
    whose second tile is all masked; and both tile kernels at D 4 / 20 /
    100 and H 1 / 33 / 100 / 300, against the plain version: f32 within
    1e-5, bf16 within 2e-2 of the largest output; all-masked items exactly
    0; a second call bit-equal to the first; the long kernel's tickets 0
    again after it."""
    tdtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    kernel = pool_kernel(tdtype, L, D, H)[0]
    assert kernel == (LONG_KERNEL if L > 128 else SIMT_KERNEL)
    args = chip_smoke.pool_edge_inputs(N, L, tdtype, device, N + L + D + H,
                                       H, D)
    before = additive_pool.launches
    with torch.no_grad():
        got = additive_pool(*args)
        again = additive_pool(*args)
        want = additive_pool_reference(args[0].float(), *args[1:])
    torch.cuda.synchronize()
    assert additive_pool.launches == before + 2
    assert got.dtype == tdtype and got.shape == (N, D)
    assert torch.equal(got, again)
    assert (got[args[1].sum(dim=1) == 0] == 0).all()
    err = (got.float() - want).abs().max().item()
    if dtype == "f32":
        assert err <= 1e-5
    else:
        assert err / want.abs().max().item() <= 2e-2
    tickets = _additive._tickets.get(got.device)
    assert tickets is None or not tickets[:N].any()


CTR_ID_MODELS = ("dnn_id", "pnn_id", "deepfm_id", "dcn_id", "dcnv2_id",
                 "gdcn_id", "autoint_id", "masknet_id", "finalmlp_id",
                 "din_id", "naml_id", "nrms_id", "miner_id")


def _ctr_manager(name, device):
    from legommenders_tpu_torch.config import parser
    from legommenders_tpu_torch.data.processors.synthetic import (
        SyntheticProcessor,
    )
    from legommenders_tpu_torch.runtime.manager import Manager

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = parser.parse_four_way(
        {"model": name}, config_root=os.path.join(root, "config")
    ).raw()["model"]
    return Manager(model_cfg=cfg, device=device,
                   exp_cfg={"policy": {"batch_size": 16, "dtype": "bf16"}},
                   data=SyntheticProcessor(**ZOO_DATA).as_lego_data())


@pytest.mark.parametrize("name", CTR_ID_MODELS)
def test_ctr_id_models_on_card_match_cpu(device, name):
    """An id-only YAML at its defaults (hidden 64, MLPs of 1,000), bf16,
    on the card against the same weights on the CPU: every test score by
    full forwards (the pool kernel on the card, its plain version on the
    CPU; the same pages, so DIN's batch norm sees the same batches) within
    2e-2 of the largest; the metrics finite in [0, 1]."""
    from legommenders_tpu_torch.runtime.tester import Tester

    gpu, cpu = _ctr_manager(name, device), _ctr_manager(name, "cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in
                               gpu.model.state_dict().items()})
    assert gpu.cache is None and cpu.cache is None
    got = gpu.evaluator().score_phase_device_full("test").float().cpu()
    want = cpu.evaluator().score_phase_device_full("test").float()
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert (got - want).abs().max() <= 2e-2 * want.abs().max()
    res = Tester(gpu).test()
    assert all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in res.values())


# ---------------------------------------------------------------------------
# the decoders (Llama / GLM, OPT): causal packed biases at head width 128
# (32 heads, D 4096) and 64 (OPT, 12 heads, D 768)
# ---------------------------------------------------------------------------
# (B, T, heads, dh, L): the decoder pages of llama-naml and opt-naml on the
# synthetic MIND-small fixture (title 30 + category: L 31, 4 items a row,
# T 124; the layer-split cache pads L to 32: T 128; a page of 512 items is
# 128 rows), and the 3-item rows of L 34 and 40 (T 102, 120) of 171 rows
DECODER_ATTN_CASES = [(128, 124, 32, 128, 31), (128, 128, 32, 128, 32),
                      (171, 102, 32, 128, 34), (171, 120, 32, 128, 40),
                      (128, 124, 12, 64, 31), (171, 120, 12, 64, 40),
                      (5, 117, 4, 128, 39), (5, 116, 4, 128, 29),
                      (3, 9, 2, 128, 9)]


def _causal_inputs(B, T, heads, dh, L, device, dtype=torch.bfloat16):
    """q, k, v ~ N(0, 1) and the causal block-diagonal bias
    packed_mask_bias(..., causal=True) makes for items of random valid
    lengths (valid tokens first, as the compact inputer puts them)."""
    g = torch.Generator(device="cpu").manual_seed(B + T + heads * dh)
    q, k, v = (torch.randn(B, T, heads * dh, generator=g).to(device, dtype)
               for _ in range(3))
    G = T // L
    lens = torch.randint(1, L + 1, (B * G,), generator=g)
    mask = (torch.arange(L)[None] < lens[:, None]).int()
    _, mask_p, _ = pack_items(torch.zeros(B * G, L, 1), mask, G)
    bias = packed_mask_bias(mask_p, L, dtype, causal=True)[:, 0]
    return q, k, v, bias.to(device)


@pytest.mark.parametrize("B,T,heads,dh,L", DECODER_ATTN_CASES)
def test_decoder_attention_matches_plain(device, B, T, heads, dh, L):
    """bf16 forward and backward at dropout 0 (the decoders pass 0) with
    causal packed biases, within 2e-2 of the largest output of the plain
    versions; f32 (forward and backward) within 1e-5."""
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        q, k, v, bias = _causal_inputs(B, T, heads, dh, L, device, dtype)
        g = torch.randn(q.shape, generator=torch.Generator().manual_seed(T)
                        ).to(device, dtype)
        with torch.no_grad():
            got = packed_attention(heads, 0.0, q, k, v, bias)
            want = reference_attention(heads, 0.0, q, k, v, bias)
            assert torch.isfinite(got.float()).all()
            assert _close(got, want, name), name
            grads = packed_attention_backward(heads, 0.0, q, k, v, bias,
                                              None, g)
            wgrads = reference_attention_backward(heads, 0.0, q, k, v, bias,
                                                  g)
        for a, b in zip(grads, wgrads):
            assert torch.isfinite(a.float()).all()
            assert _close(a, b, name), name
        del q, k, v, bias, g, got, want
        torch.cuda.empty_cache()


# (B, T, heads, dh, L): the f32 backward at head width 128 at the Llama
# training page (T 128), at T 117 and at T 116 (the last T an earlier
# CUDA-core kernel took before it streamed its operands)
F32_BWD_CASES = [(128, 128, 32, 128, 32), (5, 117, 4, 128, 39),
                 (5, 116, 4, 128, 29)]


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("B,T,heads,dh,L", F32_BWD_CASES)
def test_f32_backward_at_head_width_128(device, B, T, heads, dh, L, p):
    """attention_bwd_tf32 (f32, 3xTF32, K and V then Q and g whole in
    shared memory) at dh 128 with causal packed biases, with and without
    dropout (the mask kernel's mask given to the plain backward), within
    1e-5."""
    q, k, v, bias = _causal_inputs(B, T, heads, dh, L, device, torch.float32)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(T)
                    ).to(device)
    seed = torch.tensor([77 + T], dtype=torch.int32, device=device)
    keep = dropout_keep_mask(heads, p, B, T, seed) if p > 0 else None
    before = packed_attention_backward.launches
    grads = packed_attention_backward(heads, p, q, k, v, bias, seed, g)
    want = reference_attention_backward(heads, p, q, k, v, bias, g, keep)
    torch.cuda.synchronize()
    assert packed_attention_backward.launches == before + 1
    for a, b in zip(grads, want):
        assert a.dtype == torch.float32 and a.shape == q.shape
        assert torch.isfinite(a).all()
        assert _close(a, b, "f32")


DECODER_MODELS = ("llama-naml", "glm-naml", "opt-naml")


def _decoder_manager(name, device, lm_dtype="bf16", tune_from=None):
    """A decoder YAML cut to 2 layers of D 64 (4 heads of 16; Llama's SwiGLU
    32 wide, GLM's 2 kv heads), over the zoo's 150-item fixture."""
    from legommenders_tpu_torch.config import parser
    from legommenders_tpu_torch.data.processors.synthetic import (
        SyntheticProcessor,
    )
    from legommenders_tpu_torch.runtime.manager import Manager

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = parser.parse_four_way(
        {"model": name, "lm_dtype": lm_dtype, "tune_from": tune_from},
        config_root=os.path.join(root, "config")).raw()["model"]
    cfg["config"]["embedding_dim"] = 64
    cfg["config"]["item_config"].update(num_hidden_layers=2,
                                        num_attention_heads=4)
    if not name.startswith("opt"):
        cfg["config"]["item_config"]["intermediate_size"] = 32
    return Manager(model_cfg=cfg, device=device,
                   exp_cfg={"policy": {"batch_size": 16, "dtype": "bf16"}},
                   data=SyntheticProcessor(**ZOO_DATA).as_lego_data())


@pytest.mark.parametrize("name", DECODER_MODELS)
def test_decoder_models_on_card_match_cpu(device, name):
    """A decoder YAML (2 layers, D 64), bf16, on the card (the attention
    and pool kernels) against the same weights on the CPU (their plain
    versions): the served item and user reprs within 2e-2 of the largest;
    then, layer-split at tune_from 1, the cache within 2e-2 and one fused
    training step on the card: finite, the attention forward and backward
    launched."""
    from legommenders_tpu_torch.data.device_pipeline import (
        DeviceTrainPipeline,
    )
    from legommenders_tpu_torch.runtime import steps
    from legommenders_tpu_torch.runtime.tester import Tester
    from legommenders_tpu_torch.models.operators.lm_ops import LM_HIDDEN_KEY

    gpu, cpu = _decoder_manager(name, device), _decoder_manager(name, "cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in
                               gpu.model.state_dict().items()})
    before = packed_attention.launches
    res = Tester(gpu).test()
    Tester(cpu).test()
    assert packed_attention.launches > before
    assert all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in res.values())
    for attr in ("item_repr", "user_repr"):
        got = getattr(gpu.cache, attr).float().cpu()
        want = getattr(cpu.cache, attr).float()
        assert torch.isfinite(got).all()
        assert (got - want).abs().max() <= 2e-2 * want.abs().max(), attr

    gpu = _decoder_manager(name, device, tune_from=1)
    cpu = _decoder_manager(name, "cpu", tune_from=1)
    cpu.model.load_state_dict({k: v.cpu() for k, v in
                               gpu.model.state_dict().items()})
    assert gpu.prepare_lm_cache(root=None) and cpu.prepare_lm_cache(root=None)
    got = gpu.contents.columns[LM_HIDDEN_KEY].float().cpu()
    want = cpu.contents.columns[LM_HIDDEN_KEY].float()
    assert (got - want).abs().max() <= 2e-2 * want.abs().max()
    dp = DeviceTrainPipeline(gpu.data, batch_size=16, seed=0, device=device)
    step = dp.make_fused_train_step(gpu.model, gpu.contents.columns,
                                    steps.adam(gpu.model, 1e-3))
    f0 = packed_attention.launches
    b0 = packed_attention_backward.launches
    loss = step(next(dp.epoch_indices()), 0)
    assert torch.isfinite(loss).item()
    assert packed_attention.launches > f0
    assert packed_attention_backward.launches > b0


@pytest.mark.parametrize("cls", ["bert", "llama", "opt"])
@pytest.mark.parametrize("knob", ["fused_qkv", "norm_bf16"])
def test_lm_knobs_on_card_match_cpu(device, cls, knob):
    """A 2-layer slice (D 64) with fused_qkv or norm_bf16 on the card, bf16,
    against the same slice on the CPU (f32 weights, bf16 compute), within
    2e-2 of the largest output: the fused product and the port's own bf16
    norm (which never hands torch's CUDA layer_norm a bf16 input with f32
    weights) run there."""
    from legommenders_tpu_torch.models.lm import layers

    torch.manual_seed(0)
    kw = dict(num_layers=2, dim=64, num_heads=4, dtype=torch.bfloat16,
              lora_r=4, freeze_base=True, attention_pack=-1,
              fused_attention=True, **{knob: True})
    if cls == "bert":
        mod = layers.BertEncoderSlice(embed=False, dropout=0.0, **kw)
    elif cls == "llama":
        mod = layers.LlamaDecoderSlice(num_kv_heads=2, qkv_bias=True,
                                       intermediate_size=96, **kw)
    else:
        mod = layers.OPTDecoderSlice(embed_positions=False, **kw)
    with torch.no_grad():
        for n, p in mod.named_parameters():
            if "lora_B" in n:
                p.normal_(0.0, 0.05)
    x = torch.randn(9, 12, 64)
    mask = torch.ones(9, 12, dtype=torch.int32)
    mask[::2, 7:] = 0
    with torch.no_grad():
        want = mod(x, mask).float()
        got = mod.to(device)(x.to(device), mask.to(device)).float().cpu()
    valid = mask.bool()
    err = (got[valid] - want[valid]).abs().max()
    assert torch.isfinite(got).all()
    assert err <= 2e-2 * want[valid].abs().max(), float(err)


@pytest.mark.parametrize("policy", ["ffn", "dots"])
def test_selective_remat_on_card_matches_full(device, policy):
    """A paged layer-split BERT (2 layers at D 64, tune_from 1, 3 pages) on
    the card at f32: `ffn` and `dots` give `full`'s loss and gradients
    (1e-5 of each tensor's largest) at dropout 0.1 from one step seed; the
    attention forward launches twice a page under each (its output is not
    a matrix product: recomputed)."""
    from legommenders_tpu_torch.data.device_pipeline import (
        DeviceTrainPipeline,
    )
    from legommenders_tpu_torch.data.processors.synthetic import (
        SyntheticProcessor,
    )
    from legommenders_tpu_torch.ops.attention import packed_attention
    from legommenders_tpu_torch.runtime import steps
    from legommenders_tpu_torch.runtime.manager import Manager

    cfg = {"meta": {"item": "Bert", "user": "Ada", "predictor": "Dot"},
           "config": {"use_item_content": True, "hidden_size": 16,
                      "embedding_dim": 64, "item_page_size": 24,
                      "item_config": {
                          "lm_dtype": "f32", "num_hidden_layers": 2,
                          "num_attention_heads": 4, "max_position": 64,
                          "tune_from": 1, "lora_r": 4, "lora_fold": True,
                          "lora_dropout": 0.0,
                          "fused_attention": True, "dropout": 0.1,
                          "inputer_config": {"use_cls_token": True,
                                             "use_sep_token": True,
                                             "compact": True}}}}
    data = SyntheticProcessor(num_items=60, num_users=30, title_len=8,
                              history_len=6, vocab_size=200,
                              inters_per_user=6).as_lego_data()
    m = Manager(model_cfg=cfg, data=data, device=device, seed=0)
    assert m.prepare_lm_cache(root=None)
    dp = DeviceTrainPipeline(data, batch_size=8, neg_count=4, seed=0,
                             device=device)
    batch = dp.assemble(next(dp.epoch_indices(shuffle=False)),
                        torch.Generator(device=device).manual_seed(1))
    out = {}
    for pol in ("full", policy):
        m.model.item_page_remat = pol
        m.model.zero_grad(set_to_none=True)
        packed_attention.launches = 0
        loss = steps.make_loss_fn(m.model, m.contents.columns, True)(
            batch, torch.Generator(device=device).manual_seed(5))
        loss.backward()
        out[pol] = (loss.item(), packed_attention.launches,
                    {n: p.grad.clone() for n, p in m.model.named_parameters()
                     if p.grad is not None})
    assert abs(out[policy][0] - out["full"][0]) <= 1e-6
    assert out[policy][1] == out["full"][1] == 2 * 3
    for n, g in out["full"][2].items():
        scale = max(g.abs().max().item(), 1e-6)
        assert (out[policy][2][n] - g).abs().max().item() <= 1e-5 * scale, n


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pool_at_semantic_code_width_matches_plain(device, dtype):
    """The pool at L 4 (an item's semantic codes) over a few tiles, with
    all-masked items exactly 0."""
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    x, mask, w1, b1, q = _inputs(1001, 4, 64, 256, device, dt)
    mask[::7] = 0
    got = additive_pool(x, mask, w1, b1, q)
    want = additive_pool_reference(x.float(), mask, w1, b1, q)
    err = (got.float() - want).abs().max()
    tol = 1e-5 if dtype == "f32" else 2e-2 * want.abs().max()
    assert err <= tol
    assert (got[::7] == 0).all()
