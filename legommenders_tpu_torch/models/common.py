"""Shared blocks: AdditiveAttention, MultiHeadSelfAttention,
FrozenableLayerNorm, the CTR building blocks (StatelessBatchNorm, Dice,
get_activation, MLPLayer, LRLayer), dropout, dense and flax-equivalent
initialisers.

AdditiveAttention mirrors the JAX package's models/common.py:16-66.
Parameters keep the JAX names and layouts: proj_kernel (D, H), proj_bias
(H,), query (H, 1). MultiHeadSelfAttention is JAX common.py:69-168 (plain
einsums there too, no Pallas kernel); its submodules keep flax's names.
Both take `sequence_parallel`: under an ambient sp mesh
(parallel/mesh.sequence_parallel) their input is this sp rank's positions
of a sequence sharded over sp (the operator shards it,
parallel/mesh.scatter_seq) and they run JAX's sequence-parallel branches
(ops/sp_additive.py; ops/sp_attention.py or ops/ring_attention.py by
`sp_impl`) with the local path's parameters.

The CTR blocks are JAX common.py:171-266 (plain Dense layers and jnp
there too). They keep flax's rounding points at bf16: a Dense casts its
input and weights to the compute dtype; a batch norm's statistics are
taken in f32 and rounded to the input's dtype; an f32 parameter that JAX
applies uncast (a batch norm's scale, Dice's alpha) promotes the result
to f32, as jnp's promotion does.

Dropout draws from an explicit torch.Generator handed down with the
forward (`rng`), never from torch's global generator; `rng=None` is eval
mode, as `training=False` is in JAX.
"""
import math
from typing import Optional, Sequence

import torch
from torch import nn

from torch.nn import functional as F

from legommenders_tpu_torch.ops.additive import additive_pool
from legommenders_tpu_torch.ops.core import masked_softmax
from legommenders_tpu_torch.ops.ring_attention import ring_attention
from legommenders_tpu_torch.ops.sp_additive import sp_additive_attention
from legommenders_tpu_torch.ops.sp_attention import ulysses_attention
from legommenders_tpu_torch.parallel.mesh import (
    get_sp_mesh, global_var_mean, split_mesh,
)

# flax's lecun_normal draws from a normal truncated at two standard
# deviations, rescaled so that the variance stays 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def glorot_normal_(t: torch.Tensor,
                   generator: Optional[torch.Generator] = None):
    """flax's xavier_normal (jax glorot_normal): a normal truncated at two
    standard deviations with variance 2 / (fan_in + fan_out), the fans of
    the last two axes times the product of the leading ones."""
    receptive = math.prod(t.shape[:-2])
    fan_in, fan_out = t.shape[-2] * receptive, t.shape[-1] * receptive
    std = math.sqrt(2.0 / (fan_in + fan_out)) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def reset_linear(layer: nn.Module, generator: Optional[torch.Generator]):
    """flax Dense/Conv defaults: lecun_normal kernel, zero bias. The fan-in
    of a Linear (out, in) or Conv1d (out, in, k) weight is in * k."""
    lecun_normal_(layer.weight, layer.weight[0].numel(), generator)
    if layer.bias is not None:
        with torch.no_grad():
            layer.bias.zero_()


def reset_children(module: nn.Module,
                   generator: Optional[torch.Generator] = None):
    """Draw every direct submodule anew: a Linear by flax's Dense defaults,
    any other by its own reset_parameters."""
    for mod in module.children():
        if isinstance(mod, nn.Linear):
            reset_linear(mod, generator)
        else:
            mod.reset_parameters(generator)


def dense(layer: nn.Linear, x: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """flax's Dense(dtype=...): x and the kernel cast to dtype, the bias
    added in dtype."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def einsum(eq: str, *ts: torch.Tensor) -> torch.Tensor:
    """torch.einsum in the operands' promoted dtype: jnp.einsum promotes
    (bf16 with an f32 parameter gives f32), torch's refuses mixed
    dtypes."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return torch.einsum(eq, *(t.to(dt) for t in ts))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax's nn.gelu(approximate=False): the exact erf form."""
    return F.gelu(x, approximate="none")


def dropout(x: torch.Tensor, p: float,
            rng: Optional[torch.Generator]) -> torch.Tensor:
    """flax's nn.Dropout: each element kept with probability 1 - p (a
    uniform draw below 1 - p) and divided by 1 - p, else 0. Identity when
    `rng` is None (eval) or p is 0."""
    if rng is None or p <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=rng, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def seq_dropout(x: torch.Tensor, p: float, rng: Optional[torch.Generator],
                sp=None) -> torch.Tensor:
    """`dropout` of this sp rank's positions (dim 1) of a sequence sharded
    over the axis `sp`: the whole sequence's noise is drawn and the rank's
    positions kept, so that every sp width draws what one process draws
    (None: `dropout`)."""
    if sp is None or rng is None or p <= 0.0:
        return dropout(x, p, rng)
    B, l = x.shape[:2]
    full = (B, l * sp.size) + tuple(x.shape[2:])
    keep = (torch.rand(full, generator=rng, device=x.device)
            .narrow(1, sp.index * l, l) < 1.0 - p)
    return torch.where(keep, x / (1.0 - p),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def sp_axis(sequence_parallel: bool):
    """The ambient sp mesh's sp axis when `sequence_parallel` is asked
    and such a mesh is active; else None (the local path)."""
    mesh = get_sp_mesh() if sequence_parallel else None
    return None if mesh is None else mesh.sp_axis


def cached_casts(module: nn.Module, params, make):
    """`make()`, the compute-dtype copies of `params`, made once per state
    of the parameters while no gradient can reach them (grad off, or every
    parameter frozen: a served model's weights, or a frozen base, do not
    change between pages) and kept on `module`; made anew when a parameter
    is replaced or written in place (its data pointer or version counter
    moves) or `module.dtype` changes; every call while a gradient can reach
    them. The kept casts are made outside inference mode: a training
    forward after an evaluation (which runs in inference mode) saves a
    frozen weight's cast for its backward, and autograd refuses to save an
    inference tensor. A cast that is a view of a parameter (a cast to its
    own dtype of a slice) is kept as a copy: a view whose base the
    optimizer then writes in place cannot be copied or pickled with the
    module."""
    if torch.is_grad_enabled() and any(p.requires_grad for p in params):
        return make()
    key = (module.dtype,) + tuple((p.data_ptr(), p._version) for p in params)
    cache = getattr(module, "_cast_cache", None)
    if cache is None or cache[0] != key:
        with torch.inference_mode(False), torch.no_grad():
            made = tuple(t.clone() if t._base is not None else t
                         for t in make())
        module._cast_cache = cache = (key, made)
    return cache[1]



def drop_cached_casts(module: nn.Module):
    """Free the casts `cached_casts` keeps on `module` and its children
    (a slice that nothing runs any more)."""
    for mod in module.modules():
        mod.__dict__.pop("_cast_cache", None)

class AdditiveAttention(nn.Module):
    """exp-softmax additive pooling (..., L, D) -> (..., D), through the
    CUDA kernel on the card and the plain version on the CPU."""

    def __init__(self, input_dim: int, hidden_size: int = 256,
                 dtype: torch.dtype = torch.float32,
                 sequence_parallel: bool = False):
        super().__init__()
        self.dtype = dtype
        self.sequence_parallel = sequence_parallel
        self.proj_kernel = nn.Parameter(torch.empty(input_dim, hidden_size))
        self.proj_bias = nn.Parameter(torch.zeros(hidden_size))
        self.query = nn.Parameter(torch.empty(hidden_size, 1))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        D, H = self.proj_kernel.shape
        lecun_normal_(self.proj_kernel, D, generator)
        lecun_normal_(self.query, H, generator)
        with torch.no_grad():
            self.proj_bias.zero_()

    def pool_weights(self):
        """proj_kernel, proj_bias and query[:, 0] cast to the compute dtype,
        as the JAX module casts them, and held as f32 (the kernel's weight
        type; the values are those of the cast); see `cached_casts`."""
        params = (self.proj_kernel, self.proj_bias, self.query)
        return cached_casts(self, params, lambda: tuple(
            p.to(self.dtype).float().contiguous()
            for p in (self.proj_kernel, self.proj_bias, self.query[:, 0])))

    def forward(self, inputs: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        lead, (L, D) = inputs.shape[:-2], inputs.shape[-2:]
        x = inputs.reshape(-1, L, D)
        if mask is None:
            m = torch.ones(x.shape[:2], dtype=torch.float32, device=x.device)
        else:
            m = mask.reshape(-1, L).float()
        axis = sp_axis(self.sequence_parallel)
        if axis is not None:
            # JAX common.py:46-61: the scores in the compute dtype, the
            # two-psum pool (the fused pool is bypassed)
            dt = self.dtype
            xx = x.to(dt)
            scores = torch.tanh(xx @ self.proj_kernel.to(dt)
                                + self.proj_bias.to(dt))
            scores = scores @ self.query[:, 0].to(dt)
            out = sp_additive_attention(xx, scores, m, axis)
            return out.reshape(*lead, D)
        out = additive_pool(x.to(self.dtype).contiguous(), m,
                            *self.pool_weights())
        return out.reshape(*lead, D)


class FrozenableLayerNorm(nn.Module):
    """LayerNorm with f32 statistics. Parameters `weight` and `bias` (the
    JAX `scale` and `bias`). By default the normalisation runs in f32 and
    the result is cast to `dtype`; with `bf16_apply` (and a `dtype` other
    than f32) only the statistics are f32 and the rest runs in `dtype`.
    `freeze` freezes both parameters."""

    def __init__(self, dim: int, epsilon: float = 1e-12,
                 bf16_apply: bool = False, freeze: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.epsilon = epsilon
        self.bf16_apply = bf16_apply
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim), requires_grad=not freeze)
        self.bias = nn.Parameter(torch.zeros(dim), requires_grad=not freeze)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor,
                bf16_apply: Optional[bool] = None) -> torch.Tensor:
        """`bf16_apply`: this call's, in place of the module's."""
        bf16 = self.bf16_apply if bf16_apply is None else bf16_apply
        if bf16 and self.dtype != torch.float32:
            var, mean = torch.var_mean(x.float(), dim=-1, keepdim=True,
                                       correction=0)
            inv = torch.rsqrt(var + self.epsilon).to(self.dtype)
            y = (x.to(self.dtype) - mean.to(self.dtype)) * inv
            return y * self.weight.to(self.dtype) + self.bias.to(self.dtype)
        # f32 in and out: torch's CUDA layer_norm refuses a bf16 x with f32
        # weights
        return F.layer_norm(x.float(), x.shape[-1:], self.weight, self.bias,
                            self.epsilon).to(self.dtype)


class MultiHeadSelfAttention(nn.Module):
    """Self-attention with a key-padding mask, (..., L, D_in) -> (..., L, D)
    (JAX common.py:69-168: NRMS's AttentionOperator, the Transformer
    layers). Submodules `q`, `k`, `v` (biases iff `out_proj`), `out` (with
    `out_proj`), `res` (a residual projection where D != D_in) and
    `LayerNorm_0` (with `layer_norm`, eps 1e-5), as flax names them. The
    attention probabilities take dropout from the caller's generator `rng`
    (None: eval)."""

    def __init__(self, input_dim: int, num_heads: int = 8,
                 attention_dim: Optional[int] = None, dropout: float = 0.0,
                 use_residual: bool = False, use_scale: bool = True,
                 layer_norm: bool = False, relu_out: bool = False,
                 out_proj: bool = True, sequence_parallel: bool = False,
                 sp_impl: str = "ulysses",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if sp_impl not in ("ulysses", "ring"):
            raise ValueError(f"sp_impl {sp_impl!r}: 'ulysses' or 'ring'")
        self.sequence_parallel, self.sp_impl = sequence_parallel, sp_impl
        D = attention_dim or input_dim
        if D % num_heads:
            raise ValueError(f"attention_dim {D} % heads {num_heads} != 0")
        self.input_dim, self.dim, self.num_heads = input_dim, D, num_heads
        self.dropout, self.use_scale = dropout, use_scale
        self.use_residual, self.relu_out = use_residual, relu_out
        self.dtype = dtype
        self.q = nn.Linear(input_dim, D, bias=out_proj)
        self.k = nn.Linear(input_dim, D, bias=out_proj)
        self.v = nn.Linear(input_dim, D, bias=out_proj)
        self.out = nn.Linear(D, D) if out_proj else None
        self.res = (nn.Linear(input_dim, D, bias=False)
                    if use_residual and input_dim != D else None)
        self.LayerNorm_0 = (FrozenableLayerNorm(D, 1e-5, dtype=dtype)
                            if layer_norm else None)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for layer in (self.q, self.k, self.v, self.out, self.res):
            if layer is not None:
                reset_linear(layer, generator)
        if self.LayerNorm_0 is not None:
            self.LayerNorm_0.reset_parameters(generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        axis = sp_axis(self.sequence_parallel and x.dim() == 3)
        if axis is not None:
            out = self._sequence_parallel(x, mask, axis)
        else:
            out = self._local(x, mask, rng)
        if self.out is not None:
            out = dense(self.out, out, self.dtype)
        if self.use_residual:
            out = out + (x if self.res is None
                         else dense(self.res, x, self.dtype))
        if self.LayerNorm_0 is not None:
            out = self.LayerNorm_0(out)
        if self.relu_out:
            out = torch.relu(out)
        return out

    def _sequence_parallel(self, x, mask, axis) -> torch.Tensor:
        """JAX common.py:107-137: this rank's positions through Ulysses or
        ring attention (scaled, no attention dropout)."""
        assert self.use_scale and self.dropout == 0.0, \
            "sp path: scaled attention, no attention dropout"
        q, k, v = (dense(layer, x, self.dtype)
                   for layer in (self.q, self.k, self.v))
        m = (mask if mask is not None else
             torch.ones(x.shape[:2], dtype=torch.int32, device=x.device))
        impl = ring_attention if self.sp_impl == "ring" else ulysses_attention
        return impl(q, k, v, m, axis, num_heads=self.num_heads)

    def _local(self, x, mask, rng) -> torch.Tensor:
        H, D = self.num_heads, self.dim
        d = D // H
        lead = x.shape[:-1]
        q, k, v = (dense(layer, x, self.dtype).reshape(*lead, H, d)
                   for layer in (self.q, self.k, self.v))
        scores = torch.einsum("...qhd,...khd->...hqk", q, k)
        if self.use_scale:
            scores = scores / torch.tensor(float(d), dtype=scores.dtype).sqrt()
        if mask is not None:
            # broadcast over the heads and queries, not expanded: at a
            # flattened history's L 1,023 an expanded mask is a (B, 8, L, L)
            # tensor of its own
            attn = masked_softmax(scores, mask[..., None, None, :])
        else:
            attn = torch.softmax(scores, dim=-1)
        attn = dropout(attn, self.dropout, rng)
        return torch.einsum("...hqk,...khd->...qhd", attn, v).reshape(
            *lead, D)


class StatelessBatchNorm(nn.Module):
    """Batch normalization by the current batch's statistics over every
    axis but the last, at training and at evaluation alike (JAX
    common.py:171-194): no running averages, the population variance.
    Parameters `weight` and `bias` (flax's `scale` and `bias`), each where
    its flag is on, applied in f32 as JAX applies them. Inside a dp train
    step or evaluation page whose rows are split over ranks
    (`parallel.mesh.split_batch`) the statistics are the whole batch's,
    as JAX's over a dp-sharded batch are."""

    def __init__(self, dim: int, use_scale: bool = True,
                 use_bias: bool = True, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim)) if use_scale else None
        self.bias = nn.Parameter(torch.zeros(dim)) if use_bias else None

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            if self.weight is not None:
                self.weight.fill_(1.0)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axes = tuple(range(x.ndim - 1))
        if split_mesh() is not None:
            var, mean = global_var_mean(x.float(), axes)
        else:
            var, mean = torch.var_mean(x.float(), dim=axes, keepdim=True,
                                       correction=0)
        y = (x - mean.to(x.dtype)) * torch.rsqrt(var.to(x.dtype) + self.eps)
        if self.weight is not None:
            y = y * self.weight
        if self.bias is not None:
            y = y + self.bias
        return y


class Dice(nn.Module):
    """Dice activation (JAX common.py:197-208): p = sigmoid of the batch
    norm (eps 1e-9, no scale or bias), p x + (1 - p) alpha x; parameter
    `alpha` (dim,)."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm = StatelessBatchNorm(dim, use_scale=False, use_bias=False,
                                       eps=1e-9, dtype=dtype)
        self.alpha = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.alpha.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = torch.sigmoid(self.norm(x))
        return p * x + (1.0 - p) * self.alpha * x


_ACTIVATIONS = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    # the exact erf form (FuxiCTR's nn.GELU())
    "gelu": gelu,
    "identity": lambda x: x,
    "none": lambda x: x,
}


def get_activation(name: Optional[str]):
    """JAX common.py:211-221: relu (the default), tanh, sigmoid, gelu (exact
    erf), identity / none."""
    return _ACTIVATIONS[(name or "relu").lower()]


class MLPLayer(nn.Module):
    """The configurable MLP (JAX common.py:224-256): per hidden width a
    Dense `dense_<i>`, a StatelessBatchNorm `StatelessBatchNorm_<i>` (with
    `batch_norm`), the activation or a Dice `dice_<i>` (with `use_dice`)
    and dropout; then `dense_out` (with `output_dim`) and the output
    activation. `out_dim` is the width it returns."""

    def __init__(self, input_dim: int, hidden_units: Sequence[int] = (),
                 output_dim: Optional[int] = None, activation: str = "relu",
                 dropout: float = 0.0, batch_norm: bool = False,
                 use_bias: bool = True,
                 output_activation: Optional[str] = None,
                 use_dice: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_units = tuple(int(w) for w in hidden_units)
        self.act = get_activation(activation)
        self.out_act = (get_activation(output_activation)
                        if output_activation else None)
        self.dropout = dropout
        self.batch_norm, self.use_dice = batch_norm, use_dice
        self.dtype = dtype
        width = input_dim
        for i, w in enumerate(self.hidden_units):
            self.add_module(f"dense_{i}", nn.Linear(width, w, bias=use_bias))
            if batch_norm:
                self.add_module(f"StatelessBatchNorm_{i}",
                                StatelessBatchNorm(w, dtype=dtype))
            if use_dice:
                self.add_module(f"dice_{i}", Dice(w, dtype))
            width = w
        self.dense_out = (nn.Linear(width, output_dim, bias=use_bias)
                          if output_dim is not None else None)
        self.out_dim = width if output_dim is None else output_dim
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_children(self, generator)

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(len(self.hidden_units)):
            x = dense(getattr(self, f"dense_{i}"), x, self.dtype)
            if self.batch_norm:
                x = getattr(self, f"StatelessBatchNorm_{i}")(x)
            x = getattr(self, f"dice_{i}")(x) if self.use_dice else self.act(x)
            x = dropout(x, self.dropout, rng)
        if self.dense_out is not None:
            x = dense(self.dense_out, x, self.dtype)
            if self.out_act is not None:
                x = self.out_act(x)
        return x


class LRLayer(nn.Module):
    """Logistic-regression sum (JAX common.py:259-266): Dense_0 to one
    value, squeezed."""

    def __init__(self, input_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Dense_0 = nn.Linear(input_dim, 1)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_linear(self.Dense_0, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(self.Dense_0, x, self.dtype).squeeze(-1)
