"""Additive-attention pooling: the plain PyTorch version and the wrapper of
the hand-written CUDA kernel `csrc/additive_pool.cu`.

    h = tanh(x @ w1 + b1)          # (N, L, H)
    s = h @ w2                     # (N, L)
    a = masked_softmax(s, mask)    # (N, L)
    out = sum_l a[:, l] * x[:, l]  # (N, D)

The kernels replace the Pallas TPU kernel of the JAX package
(ops/pallas_additive.py `_kernel`, launched by `_forward_pallas`). In the
JAX package that kernel is opt-in and the default path is `_forward_jnp`;
in the port the CUDA kernels are the path on the card. `pool_kernel` says
which of the three takes a call: `additive_pool_tc` (bf16 x on the tensor
cores, whole items per 128-row tile: every item and click pool the models
run), `additive_pool_long` (any x with L > 128: the flattened histories of
the flatten user operators; positions streamed through shared memory with
an online softmax) or `additive_pool_kernel` (the CUDA cores: f32 x, and
every other shape the tensor-core kernel does not take). The choice is by
dtype and shape only; a build or launch error of any raises.

`additive_pool` is a torch.autograd.Function. Its forward takes a CPU
tensor through `additive_pool_reference` and a CUDA tensor through a
kernel; there is no fallback between the two. Its `launches` attribute
counts kernel launches. Its backward is `additive_pool_backward_reference`,
plain PyTorch on either device: the port of the JAX package's recompute
backward (`_bwd` of ops/pallas_additive.py:117-133), which is jnp code and
not a Pallas kernel there either. Only the inputs are kept between the two.
"""
import ctypes
import functools

import torch

from legommenders_tpu_torch.ops import build
from legommenders_tpu_torch.ops.core import masked_softmax

# the largest dynamic shared memory a block may use on sm_90
MAX_SMEM_BYTES = 232448

TC_KERNEL, SIMT_KERNEL = "additive_pool_tc", "additive_pool_kernel"
LONG_KERNEL = "additive_pool_long"
# the tensor-core kernel's widths: x rows of 64 bf16 (one 128-byte swizzled
# row), H in 64-column wgmma groups, items packed whole into 128-row tiles
TC_D, TC_H_STEP, TC_MAX_H, TC_TILE_ROWS = 64, 64, 256, 128

# (kernel, L, D, H, x is bf16, device index) -> persistent grid of a kernel
_grids = {}


def pool_kernel(dtype: torch.dtype, L: int, D: int, H: int):
    """The kernel that pools x of this dtype and these widths on the card,
    and the items one of its tiles holds: (LONG_KERNEL, 1) for L > 128, of
    either dtype; (TC_KERNEL, G = 128 // L) for bf16 x with D = 64, H a
    multiple of 64 up to 256 and L <= 128; (SIMT_KERNEL, 1) otherwise (f32
    x, whose 1e-5 gate neither the tensor cores nor the fast tanh meet, and
    every other width)."""
    if L > TC_TILE_ROWS:
        return LONG_KERNEL, 1
    if (dtype == torch.bfloat16 and D == TC_D and 1 <= L <= TC_TILE_ROWS
            and H % TC_H_STEP == 0 and TC_H_STEP <= H <= TC_MAX_H):
        return TC_KERNEL, TC_TILE_ROWS // L
    return SIMT_KERNEL, 1


def additive_pool_reference(x, mask, w1, b1, w2):
    """Plain version: `_forward_jnp` of ops/pallas_additive.py:83-87,
    computed in f32 from the given values; returns x's dtype.

    x (N, L, D), mask (N, L), w1 (D, H), b1 (H,), w2 (H,) -> (N, D)."""
    xf = x.float()
    h = torch.tanh(torch.einsum("nld,dh->nlh", xf, w1.float()) + b1.float())
    s = torch.einsum("nlh,h->nl", h, w2.float())
    a = masked_softmax(s, mask.float())
    return torch.einsum("nl,nld->nd", a, xf).to(x.dtype)


def additive_pool_backward_reference(x, mask, w1, b1, w2, g):
    """The recompute backward `_bwd` of ops/pallas_additive.py:117-133, in
    f32 from the given values: (dx, dw1, db1, dw2), each in the dtype of
    its input."""
    xf, w1f, b1f, w2f, gf = (t.float() for t in (x, w1, b1, w2, g))
    h = torch.tanh(torch.einsum("nld,dh->nlh", xf, w1f) + b1f)
    s = torch.einsum("nlh,h->nl", h, w2f)
    a = masked_softmax(s, mask.float())
    da = torch.einsum("nd,nld->nl", gf, xf)
    dx = a[..., None] * gf[:, None, :]
    ds = a * (da - (a * da).sum(dim=-1, keepdim=True))
    dpre = ds[..., None] * w2f * (1.0 - h * h)          # tanh'
    dw2 = torch.einsum("nlh,nl->h", h, ds)
    dw1 = torch.einsum("nld,nlh->dh", xf, dpre)
    db1 = dpre.sum(dim=(0, 1))
    dx = dx + torch.einsum("nlh,dh->nld", dpre, w1f)
    return (dx.to(x.dtype), dw1.to(w1.dtype), db1.to(b1.dtype),
            dw2.to(w2.dtype))


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
    lib.additive_pool_tc_forward.argtypes = [p, p, p, p, p, p, i, i, i, i,
                                             i, i, p]
    lib.additive_pool_tc_forward.restype = i
    lib.additive_pool_tc_prepare.argtypes = [i, i,
                                             ctypes.POINTER(ctypes.c_int)]
    lib.additive_pool_tc_prepare.restype = i
    lib.additive_pool_smem_bytes.argtypes = [i, i, i]
    lib.additive_pool_smem_bytes.restype = ctypes.c_size_t
    lib.additive_pool_long_forward.argtypes = (
        lib.additive_pool_forward.argtypes)
    lib.additive_pool_long_forward.restype = i
    lib.additive_pool_long_prepare.argtypes = [i, i, i, i,
                                               ctypes.POINTER(ctypes.c_int)]
    lib.additive_pool_long_prepare.restype = i
    lib.additive_pool_long_smem_bytes.argtypes = [i, i]
    lib.additive_pool_long_smem_bytes.restype = ctypes.c_size_t
    lib.additive_pool_error_string.argtypes = [i]
    lib.additive_pool_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib, err: int, what: str):
    if err:
        msg = lib.additive_pool_error_string(err).decode()
        raise RuntimeError(f"additive_pool {what} failed: {msg} "
                           f"(cudaError {err})")


def _grid(lib, kernel: str, L: int, D: int, H: int, bf16: bool,
          device: int) -> int:
    """A kernel's persistent grid at these widths, prepared on first use."""
    key = (kernel, L, D, H, bf16, device)
    if key not in _grids:
        blocks = ctypes.c_int(0)
        if kernel == TC_KERNEL:
            err = lib.additive_pool_tc_prepare(H, device, ctypes.byref(blocks))
        else:
            long = kernel == LONG_KERNEL
            smem = (lib.additive_pool_long_smem_bytes(D, H) if long
                    else lib.additive_pool_smem_bytes(L, D, H))
            if smem > MAX_SMEM_BYTES:
                raise ValueError(f"additive_pool: L={L} D={D} H={H} need "
                                 f"{smem} B of shared memory, more than "
                                 f"{MAX_SMEM_BYTES}")
            if long:
                err = lib.additive_pool_long_prepare(D, H, int(bf16), device,
                                                     ctypes.byref(blocks))
            else:
                err = lib.additive_pool_prepare(L, D, H, int(bf16), device,
                                                ctypes.byref(blocks))
        _check(lib, err, "prepare")
        _grids[key] = blocks.value
    return _grids[key]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a fresh copy where t does not start on the 16 bytes TMA
    needs (a view that starts mid-row)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _forward(x, mask, w1, b1, w2):
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
    if D % 4:
        raise ValueError(f"additive_pool: D={D} is not a multiple of 4")
    lib = _kernel_lib()
    bf16, dev = x.dtype == torch.bfloat16, x.device.index or 0
    kernel, G = pool_kernel(x.dtype, L, D, H)
    blocks = _grid(lib, kernel, L, D, H, bf16, dev)
    out = torch.empty((N, D), dtype=x.dtype, device=x.device)
    if N == 0:
        return out
    # no-ops for f32 contiguous inputs (what AdditiveAttention passes)
    maskf = mask.float().contiguous()
    w1f, b1f, w2f = (t.float().contiguous() for t in (w1, b1, w2))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with build.launch_range("additive_pool"):
        if kernel == TC_KERNEL:
            # held in names until the launch is enqueued: a copy freed
            # earlier could hand its memory to the next one
            xa, maska, w1a = _aligned(x), _aligned(maskf), _aligned(w1f)
            err = lib.additive_pool_tc_forward(
                xa.data_ptr(), maska.data_ptr(), w1a.data_ptr(),
                b1f.data_ptr(), w2f.data_ptr(), out.data_ptr(), N, L, H, G,
                blocks, dev, stream)
        else:
            launch = (lib.additive_pool_long_forward if kernel == LONG_KERNEL
                      else lib.additive_pool_forward)
            err = launch(
                x.data_ptr(), maskf.data_ptr(), w1f.data_ptr(),
                b1f.data_ptr(), w2f.data_ptr(), out.data_ptr(), N, L, D, H,
                int(bf16), blocks, dev, stream)
    _check(lib, err, "kernel launch")
    additive_pool.launches += 1
    return out


class _AdditivePool(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, mask, w1, b1, w2):
        ctx.save_for_backward(x, mask, w1, b1, w2)
        return _forward(x, mask, w1, b1, w2)

    @staticmethod
    def backward(ctx, g):
        x, mask, w1, b1, w2 = ctx.saved_tensors
        dx, dw1, db1, dw2 = additive_pool_backward_reference(
            x, mask, w1, b1, w2, g)
        return dx, None, dw1, db1, dw2


def additive_pool(x, mask, w1, b1, w2):
    """x (N, L, D) f32 or bf16, mask (N, L), w1 (D, H), b1 (H,), w2 (H,)
    -> (N, D) in x's dtype, f32 accumulation; differentiable in x, w1, b1
    and w2.

    CPU tensors take the plain version. CUDA tensors launch the kernel
    `pool_kernel` names; the weights and mask are passed to it as f32. The
    tensor-core kernel rounds W1 to bf16 once: exact for AdditiveAttention,
    whose W1 holds bf16 values at the bf16 policy, and at most 2^-9 of each
    weight for an f32 W1, inside the bf16 tolerance. Raises on a tensor
    that is on neither device, and on shapes, dtypes or layouts the kernels
    do not take."""
    return _AdditivePool.apply(x, mask, w1, b1, w2)


additive_pool.launches = 0
