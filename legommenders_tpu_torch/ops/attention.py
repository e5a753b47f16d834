"""Packed-block multi-head attention with dropout: the plain PyTorch
versions and the wrappers of the hand-written CUDA kernels of
`csrc/packed_attention.cu`.

For each row b and head h (dh = D // num_heads, columns h*dh .. h*dh+dh-1):

    s = (q_h @ k_h^T) / sqrt(dh) + bias[b]    # (T, T), f32
    p = softmax(s)                            # f32, over the keys
    p = keep ? p / (1 - dropout_p) : 0        # attention dropout
    o_h = p.to(v.dtype) @ v_h                 # f32 sums, rounded once

The kernels replace the three Pallas TPU kernels of the JAX package's
ops/pallas_attention.py: the forward `_fwd_kernel`, the backward
`_bwd_kernel` (which recomputes p from q, k and the bias and regenerates
the dropout bits; only q, k, v, the bias and the seed are kept) and
`_bits_kernel`, which gives the keep mask both draw. Their callers are the
LM item encoders, which pack G = 128 // L items into one T = G * L <= 128
sequence with a block-diagonal bias (models/lm/layers.pack_items /
packed_mask_bias).

On the card, bf16 runs the Hopper kernels `attention_fwd_tc` and
`attention_bwd_tc`; f32 runs `attention_fwd_tf32` and `attention_bwd_tf32`
(head widths a multiple of 8 up to 128), which take every product on the
tensor cores in 3xTF32: each f32 operand split into hi = rna_tf32(x) and
lo = rna_tf32(x - hi), lo.hi + hi.lo + hi.hi issued by mma.sync into a fresh
accumulator per k step of 8 and added in f32, with the reference's expf
and IEEE division. At the data sheet's 3xTF32 rate (495 / 3 TFLOP/s)
bert-naml's training page would be bytes-bound (the f32 forward's 262 MB
take 78.2 us at 3.35 TB/s, the backward's 451 MB 134.7 us); on the card
what bounds them is the issue of each product's instructions (mma.sync,
the operand's split, the accumulator's add) in 8 warps an SM. Their
design (one 8-warp CTA per (b, h), a warp per 16 rows, operands and the
bias by cp.async into bank-conflict-free padded rows, accumulators reused
in place as the next product's A operand, the softmax and the dropout on
the fragments, 8-key chunks the bias masks skipped, a backward in two
phases that keeps pd and dS in shared memory where they fit) is in the
source's header. What bounds the bf16 kernels at bert-naml's pages is
not bytes or tensor-core time but each consumer warp's chain of softmax,
Philox draws and epilogue. Their design:
- persistent, one 384-thread CTA per SM walking a b-major share of the
  (b, h) items;
- warpgroup 0 is the producer, cut to 40 registers by setmaxnreg. Its warp 0
  issues TMA loads of Q, K, V (and g) into a two-stage mbarrier ring (one
  stage where two do not fit);
- warpgroups 1 and 2 are consumers at 232 registers, each owning 64 query
  rows. They run every product with wgmma: P and dS are register A
  operands, V, dS^T and pd^T are transposed shared-memory operands;
- the bias is staged in shared memory by one bulk copy, or by cp.async
  where its rows are strided;
- the forward skips the exponentials and the draws of 8-key chunks that
  the bias masks for all 16 rows of a warp (with dropout, rows past T do
  not count);
- outputs leave by TMA stores.
The tensor maps are encoded on the host, and the last 64 are kept, so a
call usually encodes none. `csrc/packed_attention.cu`'s header has the
details.

The dropout bits are Philox4x32-10, a pure function of (seed, b, h, i, j)
(see the source's header); `dropout_bits_reference` computes the same
function in PyTorch, so the CPU and the card draw the same mask from the
same seed. An element is kept iff its bits >= floor(dropout_p * 2^32).
Every entry point takes a `head_offset` (default 0) added to h
in the counter: under tensor parallelism a rank holding heads
[o, o + H_local) of H passes o, and its mask is exactly heads o.. of the
mask one process draws over all H.
The three kernels share one draw; the keep-mask kernel `dropout_mask`,
bound by the draws' wide products, walks the (b, h) items with a
persistent grid, eight draws per thread and unit of work found by shifts
and masks, and writes 8- or 16-byte stores (T a multiple of 8) or stages
each item in shared memory for one bulk copy (other T).

`packed_attention` is a torch.autograd.Function with the JAX signature: it
keeps q, k, v, the bias and the seed for the backward and gives no gradient
to the bias or the seed. A CPU tensor takes the plain versions
(`reference_attention`, `reference_attention_backward`, the PyTorch
Philox); a CUDA tensor launches the kernels; there is no fallback between
the two. `packed_attention.launches`, `packed_attention_backward.launches`
and `dropout_keep_mask.launches` count kernel launches;
`packed_attention.offsets` and `packed_attention_backward.offsets` count
them by head offset ({head_offset: launches}).
"""
import ctypes
import functools
import math

import torch

from legommenders_tpu_torch.ops import build

MAX_T = 128
# head widths of the bf16 (tensor-core) kernels
BF16_HEAD_WIDTHS = (16, 32, 64, 128)
# the f32 (3xTF32 tensor-core) kernels take head widths that are multiples
# of 8 up to this
F32_MAX_HEAD_WIDTH = 128
# the largest dynamic shared memory a block may use on sm_90
MAX_SMEM_BYTES = 232448

_U32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def keep_threshold(dropout_p: float) -> int:
    """keep iff bits >= threshold; P(bits < t) = t / 2^32 = dropout_p
    (ops/pallas_attention.py `_keep_threshold`)."""
    return min(int(dropout_p * 2.0 ** 32), 2 ** 32 - 1)


def _mulhilo(a: int, b: torch.Tensor):
    """(high, low) 32 bits of the 64-bit product of the constant a and the
    uint32 values of b (int64), in 16-bit limbs so nothing overflows."""
    a_hi, a_lo = a >> 16, a & 0xFFFF
    b_hi, b_lo = b >> 16, b & 0xFFFF
    mid = a_hi * b_lo + a_lo * b_hi
    lo = a_lo * b_lo + ((mid & 0xFFFF) << 16)
    hi = a_hi * b_hi + (mid >> 16) + (lo >> 32)
    return hi & _U32, lo & _U32


def _philox4x32_10(c, key):
    """Philox4x32-10 on int64 tensors holding uint32 values."""
    c0, c1, c2, c3 = c
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _U32, (k1 + _PHILOX_W[1]) & _U32
    return c0, c1, c2, c3


def dropout_bits_reference(num_heads: int, B: int, T: int, seed: int,
                           device="cpu", head_offset: int = 0
                           ) -> torch.Tensor:
    """Plain version of the kernels' dropout bits: (B, H, T, T) int64
    holding uint32 values. Element (b, h, i, j) is word
    (i >> 3 & 1) * 2 + (j & 1) of Philox4x32-10 at counter
    (j // 2, i with bit 3 cleared, head_offset + h, b) and key (seed, 0)."""
    ar = functools.partial(torch.arange, dtype=torch.int64, device=device)
    b = ar(B)[:, None, None, None]
    h = ar(num_heads)[None, :, None, None] + int(head_offset)
    i = ar(T)[None, None, :, None]
    j = ar(T)[None, None, None, :]
    shape = (B, num_heads, T, T)
    ctr = [t.expand(shape) for t in (j >> 1, i & ~8, h, b)]
    r = _philox4x32_10(ctr, (int(seed) & _U32, 0))
    w = (((i >> 3) & 1) * 2 + (j & 1)).expand(shape)
    return torch.where(w == 0, r[0], torch.where(
        w == 1, r[1], torch.where(w == 2, r[2], r[3])))


def reference_attention(num_heads: int, dropout_p: float, q, k, v, bias,
                        keep_mask=None):
    """Plain version of the forward: `reference_attention` of
    ops/pallas_attention.py:306-323. q, k, v (B, T, D), bias (B, T, T)
    additive, keep_mask (B, H, T, T) bool or None -> (B, T, D) in q's
    dtype; scores and softmax in f32, the probabilities rounded to v's
    dtype before the product with v."""
    B, T, D = q.shape
    dh = D // num_heads
    qh = q.float().reshape(B, T, num_heads, dh)
    kh = k.float().reshape(B, T, num_heads, dh)
    vh = v.float().reshape(B, T, num_heads, dh)
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(dh)
    s = s + bias.float()[:, None]
    p = torch.softmax(s, dim=-1)
    if keep_mask is not None:
        p = torch.where(keep_mask, p / (1.0 - dropout_p), 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vh)
    return out.reshape(B, T, D).to(q.dtype)


def reference_attention_backward(num_heads: int, dropout_p: float, q, k, v,
                                 bias, g, keep_mask=None):
    """Plain version of the backward, step by step as `_bwd_kernel` of
    ops/pallas_attention.py:84-134, with its rounding points: pd is rounded
    to g's dtype before dV, g to v's dtype before dP, and ds * 1/sqrt(dh)
    to q's dtype before dQ and dK. Returns (dq, dk, dv) in q's dtype."""
    B, T, D = q.shape
    H = num_heads
    dh = D // H
    inv_sqrt = 1.0 / math.sqrt(dh)
    qh, kh, vh, gh = (t.reshape(B, T, H, dh) for t in (q, k, v, g))
    s = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float()) * inv_sqrt
    s = s + bias.float()[:, None]
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    if keep_mask is not None:
        keep = keep_mask.float() * (1.0 / (1.0 - dropout_p))
        pd = p * keep
    else:
        keep, pd = None, p
    dv = torch.einsum("bhqk,bqhd->bkhd", pd.to(g.dtype).float(), gh.float())
    dpd = torch.einsum("bqhd,bkhd->bhqk", gh.to(v.dtype).float(), vh.float())
    dp = dpd * keep if keep is not None else dpd
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    ds = (ds * inv_sqrt).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kh.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qh.float())
    return tuple(t.reshape(B, T, D).to(q.dtype) for t in (dq, dk, dv))


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = build.library("packed_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ll, u = ctypes.c_longlong, ctypes.c_uint
    lib.packed_attention_forward.argtypes = [p, p, p, p, p, i, i, i, i, f,
                                             ll, ll, i, i, p, u, f, i, i, i,
                                             p]
    lib.packed_attention_forward.restype = i
    lib.packed_attention_backward.argtypes = [p, p, p, p, p, p, p, p, i, i,
                                              i, i, f, ll, ll, i, i, p, u, f,
                                              i, i, i, p]
    lib.packed_attention_backward.restype = i
    lib.packed_attention_keep_mask.argtypes = [p, p, i, i, i, u, i, i, p]
    lib.packed_attention_keep_mask.restype = i
    lib.packed_attention_smem_bytes.argtypes = [i, i, i, i]
    lib.packed_attention_smem_bytes.restype = ctypes.c_size_t
    lib.packed_attention_prepare.argtypes = [i]
    lib.packed_attention_prepare.restype = i
    lib.packed_attention_error_string.argtypes = [i]
    lib.packed_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib, err: int, what: str):
    if err:
        msg = lib.packed_attention_error_string(err).decode()
        raise RuntimeError(f"packed_attention {what} failed: {msg} "
                           f"(cudaError {err})")


@functools.lru_cache(maxsize=None)
def _prepare(device: int):
    """Sets the kernels' shared-memory attributes on `device`, once."""
    lib = _kernel_lib()
    _check(lib, lib.packed_attention_prepare(device), "prepare")


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else 0


def _check_seed(seed, device, dropout_p: float):
    if dropout_p <= 0.0:
        return
    if seed is None:
        raise ValueError("packed_attention: dropout_p > 0 needs a seed")
    if seed.dtype != torch.int32 or seed.numel() != 1:
        raise TypeError(f"packed_attention: seed must be one int32, got "
                        f"{seed.dtype} {tuple(seed.shape)}")
    if seed.device != device:
        raise ValueError(f"packed_attention: seed on {seed.device}, q on "
                         f"{device}")


def _check_cuda(num_heads: int, q, k, v, bias, g=None, backward=False):
    """Validates CUDA inputs; returns (dh, bf16, shared-memory bytes)."""
    if q.dim() != 3:
        raise ValueError(f"packed_attention: q must be (B, T, D), got "
                         f"{tuple(q.shape)}")
    B, T, D = q.shape
    if T > MAX_T:
        raise ValueError(f"packed_attention: T={T} > {MAX_T}")
    if D % num_heads:
        raise ValueError(f"packed_attention: D={D} is not a multiple of "
                         f"num_heads={num_heads}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"packed_attention: q dtype {q.dtype} is not f32/bf16")
    named = [("k", k, (B, T, D)), ("v", v, (B, T, D)),
             ("bias", bias, (B, T, T))]
    if g is not None:
        named.append(("g", g, (B, T, D)))
    for name, t, want in named:
        if tuple(t.shape) != want:
            raise ValueError(f"packed_attention: {name} shape "
                             f"{tuple(t.shape)} != {want}")
        if t.device != q.device:
            raise ValueError(f"packed_attention: {name} on {t.device}, q on "
                             f"{q.device}")
    same = [k, v] + ([g] if g is not None else [])
    if any(t.dtype != q.dtype for t in same):
        raise TypeError(f"packed_attention: q/k/v dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype} differ")
    if bias.dtype not in (q.dtype, torch.float32):
        raise TypeError(f"packed_attention: bias dtype {bias.dtype} is neither "
                        f"q's ({q.dtype}) nor f32")
    if not all(t.is_contiguous() for t in [q] + same):
        raise ValueError("packed_attention: q, k and v must be contiguous")
    if T > 1 and bias.stride(2) != 1:
        raise ValueError("packed_attention: bias must be contiguous in its "
                         "last dimension")
    if any(t.data_ptr() % 16 for t in [q] + same):
        raise ValueError("packed_attention: q, k and v must be 16-byte "
                         "aligned")
    dh, bf16 = D // num_heads, q.dtype == torch.bfloat16
    if bf16 and dh not in BF16_HEAD_WIDTHS:
        raise ValueError(f"packed_attention: bf16 takes head widths "
                         f"{BF16_HEAD_WIDTHS}, got {dh}")
    if not bf16 and (dh % 8 or not 0 < dh <= F32_MAX_HEAD_WIDTH):
        raise ValueError(f"packed_attention: f32 takes head widths that are "
                         f"multiples of 8 up to {F32_MAX_HEAD_WIDTH}, got "
                         f"{dh}")
    smem = _kernel_lib().packed_attention_smem_bytes(T, dh, int(bf16),
                                                     int(backward))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"packed_attention: T={T} dh={dh} need {smem} B of "
                         f"shared memory, more than {MAX_SMEM_BYTES}")
    return dh, bf16


def _drop_args(dropout_p: float, seed):
    """(seed pointer, threshold, keep scale, on) for the C entry points."""
    if dropout_p <= 0.0:
        return None, 0, 1.0, 0
    return (seed.data_ptr(), keep_threshold(dropout_p),
            1.0 / (1.0 - dropout_p), 1)


def dropout_keep_mask(num_heads: int, dropout_p: float, B: int, T: int, seed,
                      device=None, head_offset: int = 0) -> torch.Tensor:
    """The (B, num_heads, T, T) bool keep mask that the forward and the
    backward draw for `seed` ((1,) int32) at dropout_p, of heads
    head_offset .. head_offset + num_heads - 1. On the CPU the PyTorch
    Philox; on the card the mask kernel (the counterpart of
    ops/pallas_attention.py `dropout_keep_mask`)."""
    device = torch.device(device) if device is not None else seed.device
    thresh = keep_threshold(dropout_p)
    if device.type == "cpu":
        bits = dropout_bits_reference(num_heads, B, T,
                                      int(seed.reshape(-1)[0]),
                                      head_offset=head_offset)
        return bits >= thresh
    if device.type != "cuda":
        raise ValueError(f"dropout_keep_mask: unsupported device {device}")
    if seed.device != device or seed.dtype != torch.int32:
        raise ValueError(f"dropout_keep_mask: seed must be int32 on {device}")
    out = torch.empty((B, num_heads, T, T), dtype=torch.bool, device=device)
    if B == 0 or T == 0:
        return out
    lib = _kernel_lib()
    dev = _device_index(seed)
    _prepare(dev)
    with build.launch_range("dropout_keep_mask"):
        _check(lib, lib.packed_attention_keep_mask(
            seed.data_ptr(), out.data_ptr(), B, T, num_heads, thresh,
            int(head_offset), dev,
            torch.cuda.current_stream(device).cuda_stream),
            "keep-mask launch")
    dropout_keep_mask.launches += 1
    return out


dropout_keep_mask.launches = 0


def _count_offset(fn, head_offset: int):
    """One launch of `fn`'s kernel at `head_offset`."""
    fn.offsets[int(head_offset)] = fn.offsets.get(int(head_offset), 0) + 1


def _forward(num_heads: int, dropout_p: float, q, k, v, bias, seed,
             head_offset: int = 0):
    if q.device.type == "cpu":
        keep = (dropout_keep_mask(num_heads, dropout_p, q.shape[0],
                                  q.shape[1], seed, head_offset=head_offset)
                if dropout_p > 0.0 else None)
        return reference_attention(num_heads, dropout_p, q, k, v, bias, keep)
    if q.device.type != "cuda":
        raise ValueError(f"packed_attention: unsupported device {q.device}")
    dh, bf16 = _check_cuda(num_heads, q, k, v, bias)
    _check_seed(seed, q.device, dropout_p)
    B, T, _ = q.shape
    out = torch.empty_like(q)
    if B == 0 or T == 0:
        return out
    lib = _kernel_lib()
    dev = _device_index(q)
    _prepare(dev)
    with build.launch_range("packed_attention"):
        _check(lib, lib.packed_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), B, T, num_heads, dh, 1.0 / math.sqrt(dh),
            bias.stride(0), bias.stride(1), int(bf16),
            int(bias.dtype == torch.bfloat16), *_drop_args(dropout_p, seed),
            int(head_offset), dev,
            torch.cuda.current_stream(q.device).cuda_stream),
            "kernel launch")
    packed_attention.launches += 1
    _count_offset(packed_attention, head_offset)
    return out


def packed_attention_backward(num_heads: int, dropout_p: float, q, k, v,
                              bias, seed, g, head_offset: int = 0):
    """(dq, dk, dv) of `packed_attention` for the output gradient g
    (B, T, D): the plain backward on the CPU (with the mask the seed
    draws), the backward kernel on the card."""
    if q.device.type == "cpu":
        keep = (dropout_keep_mask(num_heads, dropout_p, q.shape[0],
                                  q.shape[1], seed, head_offset=head_offset)
                if dropout_p > 0.0 else None)
        return reference_attention_backward(num_heads, dropout_p, q, k, v,
                                            bias, g, keep)
    if q.device.type != "cuda":
        raise ValueError(f"packed_attention: unsupported device {q.device}")
    g = g.contiguous()
    dh, bf16 = _check_cuda(num_heads, q, k, v, bias, g, backward=True)
    _check_seed(seed, q.device, dropout_p)
    B, T, _ = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    if B == 0 or T == 0:
        return dq, dk, dv
    lib = _kernel_lib()
    dev = _device_index(q)
    _prepare(dev)
    with build.launch_range("packed_attention_backward"):
        _check(lib, lib.packed_attention_backward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, T,
            num_heads, dh, 1.0 / math.sqrt(dh), bias.stride(0),
            bias.stride(1), int(bf16), int(bias.dtype == torch.bfloat16),
            *_drop_args(dropout_p, seed), int(head_offset), dev,
            torch.cuda.current_stream(q.device).cuda_stream),
            "backward kernel launch")
    packed_attention_backward.launches += 1
    _count_offset(packed_attention_backward, head_offset)
    return dq, dk, dv


packed_attention_backward.launches = 0
packed_attention_backward.offsets = {}


class _PackedAttention(torch.autograd.Function):
    """Keeps q, k, v, the bias and the seed (as `_vjp_fwd` does); the
    backward regenerates the dropout bits from the seed."""

    @staticmethod
    def forward(ctx, num_heads, dropout_p, q, k, v, bias, seed, head_offset):
        ctx.num_heads, ctx.dropout_p = num_heads, dropout_p
        ctx.head_offset = head_offset
        ctx.save_for_backward(q, k, v, bias, seed)
        return _forward(num_heads, dropout_p, q, k, v, bias, seed,
                        head_offset)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, seed = ctx.saved_tensors
        dq, dk, dv = packed_attention_backward(
            ctx.num_heads, ctx.dropout_p, q, k, v, bias, seed, g,
            ctx.head_offset)
        return None, None, dq, dk, dv, None, None, None


def packed_attention(num_heads: int, dropout_p: float, q, k, v, bias,
                     seed=None, head_offset: int = 0):
    """q, k, v (B, T, D) f32 or bf16 with D = num_heads * dh, T <= 128 and
    dh in BF16_HEAD_WIDTHS (bf16) or a multiple of 8 up to
    F32_MAX_HEAD_WIDTH (f32); bias (B, T, T) additive, in q's dtype
    or f32 (its last dimension contiguous; broadcast views with stride 0
    are read as they are); `seed` the (1,) int32 dropout seed on q's
    device, needed when dropout_p > 0 and unused otherwise; `head_offset`
    the index of q's first head among the heads of a tensor sharded by
    heads (the dropout bits are those heads').
    Returns (B, T, D) in q's dtype; differentiable in q, k and v.

    CPU tensors take the plain versions. CUDA tensors launch the kernels.
    Raises on a tensor that is on neither device, and on shapes, dtypes,
    layouts or devices the kernels do not take."""
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"packed_attention: dropout_p={dropout_p} is not in "
                         f"[0, 1)")
    if dropout_p > 0.0 and seed is None:
        raise ValueError("packed_attention: dropout_p > 0 needs a seed")
    return _PackedAttention.apply(num_heads, float(dropout_p), q, k, v, bias,
                                  seed, int(head_offset))


packed_attention.launches = 0
packed_attention.offsets = {}
