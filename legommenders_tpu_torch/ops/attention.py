"""Packed-block multi-head attention: the plain PyTorch version and the
wrapper of the hand-written CUDA kernel `csrc/packed_attention.cu`.

For each row b and head h (dh = D // num_heads, columns h*dh .. h*dh+dh-1):

    s = (q_h @ k_h^T) / sqrt(dh) + bias[b]    # (T, T), f32
    p = softmax(s)                            # f32, over the keys
    o_h = p.to(v.dtype) @ v_h                 # f32 sums, rounded once

The kernel replaces the Pallas TPU kernel of the JAX package
(ops/pallas_attention.py `_fwd_kernel`, launched by `_call_fwd`). Its
callers are the LM item encoders, which pack G = 128 // L items into one
T = G * L <= 128 sequence with a block-diagonal bias
(models/lm/layers.pack_items / packed_mask_bias).

`packed_attention` takes a CPU tensor through `reference_attention` and a
CUDA tensor through the kernel; there is no fallback between the two. Its
`launches` attribute counts kernel launches. Eval mode only: attention
dropout (`dropout_p > 0`) and the backward come with LM training, and a
call that would need either raises.
"""
import ctypes
import functools
import math

import torch

from legommenders_tpu_torch.ops import build

MAX_T = 128
# head widths of the bf16 (tensor-core) kernel
BF16_HEAD_WIDTHS = (16, 32, 64, 128)
# the largest dynamic shared memory a block may use on sm_90
MAX_SMEM_BYTES = 232448


def reference_attention(num_heads: int, q, k, v, bias):
    """Plain version: `reference_attention` of ops/pallas_attention.py:306-323
    at dropout 0. q, k, v (B, T, D), bias (B, T, T) additive -> (B, T, D)
    in q's dtype; scores and softmax in f32, the probabilities rounded to
    v's dtype before the product with v."""
    B, T, D = q.shape
    dh = D // num_heads
    qh = q.float().reshape(B, T, num_heads, dh)
    kh = k.float().reshape(B, T, num_heads, dh)
    vh = v.float().reshape(B, T, num_heads, dh)
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(dh)
    s = s + bias.float()[:, None]
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vh)
    return out.reshape(B, T, D).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = build.library("packed_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ll = ctypes.c_longlong
    lib.packed_attention_forward.argtypes = [p, p, p, p, p, i, i, i, i, f,
                                             ll, ll, i, i, i, p]
    lib.packed_attention_forward.restype = i
    lib.packed_attention_smem_bytes.argtypes = [i, i, i]
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


def packed_attention(num_heads: int, dropout_p: float, q, k, v, bias,
                     seed=None):
    """q, k, v (B, T, D) f32 or bf16 with D = num_heads * dh, T <= 128 and,
    in bf16, dh in BF16_HEAD_WIDTHS; bias (B, T, T) additive, in q's dtype
    or f32 (its last dimension contiguous; broadcast views with stride 0
    are read as they are);
    `seed` is the JAX signature's dropout seed, unused at dropout 0.
    Returns (B, T, D) in q's dtype.

    CPU tensors take the plain version. CUDA tensors launch the kernel.
    Raises on `dropout_p > 0`, on a tensor that is on neither device, on
    shapes, dtypes, layouts or devices the kernel does not take, and on
    inputs that require grad while grad mode is on."""
    if dropout_p > 0.0:
        raise NotImplementedError(
            "packed_attention: attention dropout (dropout_p > 0) comes with "
            "the LM training slice; eval mode runs at dropout_p = 0")
    if q.device.type == "cpu":
        return reference_attention(num_heads, q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"packed_attention: unsupported device {q.device}")
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
    for name, t, want in (("k", k, (B, T, D)), ("v", v, (B, T, D)),
                          ("bias", bias, (B, T, T))):
        if tuple(t.shape) != want:
            raise ValueError(f"packed_attention: {name} shape "
                             f"{tuple(t.shape)} != {want}")
        if t.device != q.device:
            raise ValueError(f"packed_attention: {name} on {t.device}, q on "
                             f"{q.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"packed_attention: q/k/v dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype} differ")
    if bias.dtype not in (q.dtype, torch.float32):
        raise TypeError(f"packed_attention: bias dtype {bias.dtype} is neither "
                        f"q's ({q.dtype}) nor f32")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("packed_attention: q, k and v must be contiguous")
    if T > 1 and bias.stride(2) != 1:
        raise ValueError("packed_attention: bias must be contiguous in its "
                         "last dimension")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("packed_attention: q, k and v must be 16-byte "
                         "aligned")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, bias)):
        raise RuntimeError("packed_attention: the CUDA kernel has no backward "
                           "yet; call it under torch.no_grad()")
    dh, bf16 = D // num_heads, q.dtype == torch.bfloat16
    if bf16 and dh not in BF16_HEAD_WIDTHS:
        raise ValueError(f"packed_attention: bf16 takes head widths "
                         f"{BF16_HEAD_WIDTHS}, got {dh}")
    lib = _kernel_lib()
    smem = lib.packed_attention_smem_bytes(T, dh, int(bf16))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"packed_attention: T={T} dh={dh} need {smem} B of "
                         f"shared memory, more than {MAX_SMEM_BYTES}")
    out = torch.empty_like(q)
    if B == 0 or T == 0:
        return out
    dev = q.device.index if q.device.index is not None else 0
    _prepare(dev)
    _check(lib, lib.packed_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        out.data_ptr(), B, T, num_heads, dh, 1.0 / math.sqrt(dh),
        bias.stride(0), bias.stride(1), int(bf16),
        int(bias.dtype == torch.bfloat16), dev,
        torch.cuda.current_stream(q.device).cuda_stream), "kernel launch")
    packed_attention.launches += 1
    return out


packed_attention.launches = 0
