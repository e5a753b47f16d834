"""Additive-attention pooling: the plain PyTorch version and the wrapper of
the hand-written CUDA kernel `csrc/additive_pool.cu`.

    h = tanh(x @ w1 + b1)          # (N, L, H)
    s = h @ w2                     # (N, L)
    a = masked_softmax(s, mask)    # (N, L)
    out = sum_l a[:, l] * x[:, l]  # (N, D)

The kernel replaces the Pallas TPU kernel of the JAX package
(ops/pallas_additive.py `_kernel`, launched by `_forward_pallas`). In the
JAX package that kernel is opt-in and the default path is `_forward_jnp`;
in the port the CUDA kernel is the path on the card.

`additive_pool` takes a CPU tensor through `additive_pool_reference` and a
CUDA tensor through the kernel; there is no fallback between the two. Its
`launches` attribute counts kernel launches. There is no backward yet: on
the card a call that would need one raises.
"""
import ctypes
import functools

import torch

from legommenders_tpu_torch.ops import build
from legommenders_tpu_torch.ops.core import masked_softmax

# the largest dynamic shared memory a block may use on sm_90
MAX_SMEM_BYTES = 232448

# (L, D, H, x is bf16, device index) -> persistent grid of the kernel
_grids = {}


def additive_pool_reference(x, mask, w1, b1, w2):
    """Plain version: `_forward_jnp` of ops/pallas_additive.py:83-87,
    computed in f32 from the given values; returns x's dtype.

    x (N, L, D), mask (N, L), w1 (D, H), b1 (H,), w2 (H,) -> (N, D)."""
    xf = x.float()
    h = torch.tanh(torch.einsum("nld,dh->nlh", xf, w1.float()) + b1.float())
    s = torch.einsum("nlh,h->nl", h, w2.float())
    a = masked_softmax(s, mask.float())
    return torch.einsum("nl,nld->nd", a, xf).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = build.library("additive_pool")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.additive_pool_forward.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                          i, p]
    lib.additive_pool_forward.restype = i
    lib.additive_pool_prepare.argtypes = [i, i, i, i, i,
                                          ctypes.POINTER(ctypes.c_int)]
    lib.additive_pool_prepare.restype = i
    lib.additive_pool_smem_bytes.argtypes = [i, i, i]
    lib.additive_pool_smem_bytes.restype = ctypes.c_size_t
    lib.additive_pool_error_string.argtypes = [i]
    lib.additive_pool_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib, err: int, what: str):
    if err:
        msg = lib.additive_pool_error_string(err).decode()
        raise RuntimeError(f"additive_pool {what} failed: {msg} "
                           f"(cudaError {err})")


def _grid(lib, L: int, D: int, H: int, bf16: bool, device: int) -> int:
    """The kernel's persistent grid at these widths, prepared on first use."""
    key = (L, D, H, bf16, device)
    if key not in _grids:
        smem = lib.additive_pool_smem_bytes(L, D, H)
        if smem > MAX_SMEM_BYTES:
            raise ValueError(f"additive_pool: L={L} D={D} H={H} need {smem} "
                             f"B of shared memory, more than {MAX_SMEM_BYTES}")
        blocks = ctypes.c_int(0)
        _check(lib, lib.additive_pool_prepare(L, D, H, int(bf16), device,
                                              ctypes.byref(blocks)), "prepare")
        _grids[key] = blocks.value
    return _grids[key]


def additive_pool(x, mask, w1, b1, w2):
    """x (N, L, D) f32 or bf16, mask (N, L), w1 (D, H), b1 (H,), w2 (H,)
    -> (N, D) in x's dtype, f32 accumulation.

    CPU tensors take the plain version. CUDA tensors launch the kernel; the
    weights and mask are passed to it as f32. Raises on a tensor that is on
    neither, on shapes, dtypes or layouts the kernel does not take, and on
    inputs that require grad while grad mode is on."""
    if x.device.type == "cpu":
        return additive_pool_reference(x, mask, w1, b1, w2)
    if x.device.type != "cuda":
        raise ValueError(f"additive_pool: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"additive_pool: x must be (N, L, D), got {tuple(x.shape)}")
    N, L, D = x.shape
    H = w1.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"additive_pool: x dtype {x.dtype} is not f32/bf16")
    if not x.is_contiguous():
        raise ValueError("additive_pool: x must be contiguous")
    shapes = {"mask": (mask, (N, L)), "w1": (w1, (D, H)), "b1": (b1, (H,)),
              "w2": (w2, (H,))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"additive_pool: {name} shape {tuple(t.shape)} "
                             f"!= {want}")
        if t.device != x.device:
            raise ValueError(f"additive_pool: {name} on {t.device}, x on "
                             f"{x.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w1, b1, w2)):
        raise RuntimeError("additive_pool: the CUDA kernel has no backward "
                           "yet; call it under torch.no_grad()")
    if D % 4:
        raise ValueError(f"additive_pool: D={D} is not a multiple of 4")
    lib = _kernel_lib()
    bf16, dev = x.dtype == torch.bfloat16, x.device.index or 0
    blocks = _grid(lib, L, D, H, bf16, dev)
    out = torch.empty((N, D), dtype=x.dtype, device=x.device)
    if N == 0:
        return out
    # no-ops for f32 contiguous inputs (what AdditiveAttention passes)
    maskf = mask.float().contiguous()
    w1f, b1f, w2f = (t.float().contiguous() for t in (w1, b1, w2))
    _check(lib, lib.additive_pool_forward(
        x.data_ptr(), maskf.data_ptr(), w1f.data_ptr(), b1f.data_ptr(),
        w2f.data_ptr(), out.data_ptr(), N, L, D, H, int(bf16), blocks, dev,
        torch.cuda.current_stream(x.device).cuda_stream), "kernel launch")
    additive_pool.launches += 1
    return out


additive_pool.launches = 0
