"""Additive-attention pooling: the plain PyTorch version and the wrapper of
the hand-written CUDA kernel `csrc/additive_pool.cu`.

    h = tanh(x @ w1 + b1)          # (N, L, H)
    s = h @ w2                     # (N, L)
    a = masked_softmax(s, mask)    # (N, L)
    out = sum_l a[:, l] * x[:, l]  # (N, D)

The kernels replace the Pallas TPU kernel of the JAX package
(ops/pallas_additive.py `_kernel`, launched by `_forward_pallas`). In the
JAX package that kernel is opt-in and the default path is `_forward_jnp`;
in the port the CUDA kernels are the path on the card, all three scoring
on the tensor cores. `pool_kernel` says which takes a call:
`additive_pool_tc` (bf16 x at D 64, H a multiple of 64 up to 256, whole
items per 128-row tile on wgmma: every item and click pool the models run;
bound by the N*L*H tanh, then the bytes), `additive_pool_long` (any x with
L > 128: the flattened histories of the flatten user operators; tiles of
128 positions, an item spread over several CTAs where the items alone do
not fill the card and combined in the same launch; bound by the bytes) or
`additive_pool_kernel` (f32 x, and every other width: whole items per
tile; at f32 bound by the products). The last two score on mma.sync, bf16
or f32 as 3xTF32 (csrc/additive_pool.cu says how). The choice is by dtype
and shape only; a build or launch error of any raises.

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
from legommenders_tpu_torch.utils import spans

# the largest dynamic shared memory a block may use on sm_90
MAX_SMEM_BYTES = 232448

TC_KERNEL, SIMT_KERNEL = "additive_pool_tc", "additive_pool_kernel"
LONG_KERNEL = "additive_pool_long"
# the tensor-core kernel's widths: x rows of 64 bf16 (one 128-byte swizzled
# row), H in 64-column wgmma groups, items packed whole into 128-row tiles
TC_D, TC_H_STEP, TC_MAX_H, TC_TILE_ROWS = 64, 64, 256, 128

# (kernel, L, D, H, x is bf16, device index) -> the launch's plan: the
# persistent grid, and for the tile kernels the tile rows R, the ring's
# stages S and the items a tile G (csrc/additive_pool.cu `plan_of`)
_grids = {}
# device -> the long kernel's per-item tickets (int32, zeroed once; each
# launch leaves them 0), grown to the largest N seen. Launches on one
# stream at a time share them, as the port's pools run.
_tickets = {}


def pool_kernel(dtype: torch.dtype, L: int, D: int, H: int):
    """The kernel that pools x of this dtype and these widths on the card,
    and the items one of its tiles holds: (LONG_KERNEL, 1) for L > 128, of
    either dtype; (TC_KERNEL, G = 128 // L) for bf16 x with D = 64, H a
    multiple of 64 up to 256 and L <= 128; (SIMT_KERNEL, 1) otherwise (f32
    x, whose 1e-5 gate wgmma's bf16 products and the fast tanh do not
    meet, and every other width; that kernel packs G = R // L items a tile
    itself)."""
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
    lib.additive_pool_forward.argtypes = [p, p, p, p, p, p] + [i] * 10 + [p]
    lib.additive_pool_forward.restype = i
    lib.additive_pool_long_forward.argtypes = [p] * 8 + [i] * 10 + [p]
    lib.additive_pool_long_forward.restype = i
    lib.additive_pool_long_split.argtypes = [i, i, i, i]
    lib.additive_pool_long_split.restype = i
    lib.additive_pool_prepare.argtypes = [i, i, i, i, i, i,
                                          ctypes.POINTER(ctypes.c_int)]
    lib.additive_pool_prepare.restype = i
    lib.additive_pool_smem_bytes.argtypes = [i, i, i, i, i]
    lib.additive_pool_smem_bytes.restype = ctypes.c_size_t
    lib.additive_pool_tc_forward.argtypes = [p, p, p, p, p, p, i, i, i, i,
                                             i, i, p]
    lib.additive_pool_tc_forward.restype = i
    lib.additive_pool_tc_prepare.argtypes = [i, i,
                                             ctypes.POINTER(ctypes.c_int)]
    lib.additive_pool_tc_prepare.restype = i
    lib.additive_pool_error_string.argtypes = [i]
    lib.additive_pool_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib, err: int, what: str):
    if err:
        msg = lib.additive_pool_error_string(err).decode()
        raise RuntimeError(f"additive_pool {what} failed: {msg} "
                           f"(cudaError {err})")


def _grid(lib, kernel: str, L: int, D: int, H: int, bf16: bool,
          device: int) -> tuple:
    """A kernel's plan at these widths, prepared on first use: (persistent
    grid,) for the tensor-core kernel, (grid, R, S, G) for the tile
    kernels."""
    key = (kernel, L, D, H, bf16, device)
    if key not in _grids:
        if kernel == TC_KERNEL:
            blocks = ctypes.c_int(0)
            err = lib.additive_pool_tc_prepare(H, device, ctypes.byref(blocks))
            plan = (blocks.value,)
        else:
            long = int(kernel == LONG_KERNEL)
            smem = lib.additive_pool_smem_bytes(long, L, D, H, int(bf16))
            if smem > MAX_SMEM_BYTES:
                raise ValueError(f"additive_pool: L={L} D={D} H={H} need "
                                 f"{smem} B of shared memory, more than "
                                 f"{MAX_SMEM_BYTES}")
            cfg = (ctypes.c_int * 4)()
            err = lib.additive_pool_prepare(long, L, D, H, int(bf16), device,
                                            cfg)
            plan = tuple(cfg)
        _check(lib, err, "prepare")
        _grids[key] = plan
    return _grids[key]


def _tickets_for(N: int, device: torch.device) -> torch.Tensor:
    """At least N zeroed int32 tickets on `device` for the long kernel,
    allocated (zeroed) only when a larger N comes: every launch leaves its
    tickets 0 again, so the pool's launch needs no memset."""
    t = _tickets.get(device)
    if t is None or t.numel() < N:
        t = _tickets[device] = torch.zeros(max(N, 1024), dtype=torch.int32,
                                           device=device)
    return t


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a fresh copy where t does not start on the 16 bytes that TMA
    and the 16-byte copies need (a view that starts mid-row)."""
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
    plan = _grid(lib, kernel, L, D, H, bf16, dev)
    out = torch.empty((N, D), dtype=x.dtype, device=x.device)
    if N == 0:
        return out
    # no-ops for f32 contiguous inputs (what AdditiveAttention passes)
    maskf = mask.float().contiguous()
    w1f, b1f, w2f = (t.float().contiguous() for t in (w1, b1, w2))
    if kernel == LONG_KERNEL:
        blocks, R, S, _ = plan
        # the CTAs an item is spread over, and where more than one, their
        # shares' partials (m, sum, acc[D]) and the items' tickets
        c = lib.additive_pool_long_split(N, L, R, blocks)
        part = tickets = None
        if c > 1:
            part = torch.empty(N * c * (D + 2), dtype=torch.float32,
                               device=x.device)
            tickets = _tickets_for(N, x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with build.launch_range("additive_pool"):
        # held in names until the launch is enqueued: a copy freed earlier
        # could hand its memory to the next one
        xa, maska = _aligned(x), _aligned(maskf)
        if kernel == TC_KERNEL:
            w1a = _aligned(w1f)
            err = lib.additive_pool_tc_forward(
                xa.data_ptr(), maska.data_ptr(), w1a.data_ptr(),
                b1f.data_ptr(), w2f.data_ptr(), out.data_ptr(), N, L, H, G,
                plan[0], dev, stream)
        elif kernel == LONG_KERNEL:
            err = lib.additive_pool_long_forward(
                xa.data_ptr(), maska.data_ptr(), w1f.data_ptr(),
                b1f.data_ptr(), w2f.data_ptr(), out.data_ptr(),
                part.data_ptr() if c > 1 else None,
                tickets.data_ptr() if c > 1 else None, N, L, D, H,
                int(bf16), blocks, R, S, c, dev, stream)
        else:
            blocks, R, S, G = plan
            err = lib.additive_pool_forward(
                xa.data_ptr(), maska.data_ptr(), w1f.data_ptr(),
                b1f.data_ptr(), w2f.data_ptr(), out.data_ptr(), N, L, D, H,
                int(bf16), blocks, R, S, G, dev, stream)
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
        with spans.span("lego.pool.backward"):
            dx, dw1, db1, dw2 = additive_pool_backward_reference(
                x, mask, w1, b1, w2, g)
        return dx, None, dw1, db1, dw2


def additive_pool(x, mask, w1, b1, w2):
    """x (N, L, D) f32 or bf16, mask (N, L), w1 (D, H), b1 (H,), w2 (H,)
    -> (N, D) in x's dtype, f32 accumulation; differentiable in x, w1, b1
    and w2.

    CPU tensors take the plain version. CUDA tensors launch the kernel
    `pool_kernel` names; the weights and mask are passed to it as f32.
    `additive_pool_tc` rounds W1 to bf16 once: exact for
    AdditiveAttention, whose W1 holds bf16 values at the bf16 policy, and
    at most 2^-9 of each weight for an f32 W1, inside the bf16 tolerance.
    The other two keep 16 bits of W1 for bf16 x and score f32 x in 3xTF32,
    within the f32 tolerance. Raises on a tensor that is on neither
    device, and on shapes, dtypes or layouts the kernels do not take."""
    return _AdditivePool.apply(x, mask, w1, b1, w2)


additive_pool.launches = 0
