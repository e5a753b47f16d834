"""Shared blocks: AdditiveAttention, MultiHeadSelfAttention,
FrozenableLayerNorm, dropout, dense and flax-equivalent initialisers.

AdditiveAttention mirrors the JAX package's models/common.py:16-66 without
its sequence-parallel branch. Parameters keep the JAX names and layouts:
proj_kernel (D, H), proj_bias (H,), query (H, 1). MultiHeadSelfAttention
is the local path of JAX common.py:69-168 (plain einsums there too, no
Pallas kernel); its submodules keep flax's names.

Dropout draws from an explicit torch.Generator handed down with the
forward (`rng`), never from torch's global generator; `rng=None` is eval
mode, as `training=False` is in JAX.
"""
import math
from typing import Optional

import torch
from torch import nn

from torch.nn import functional as F

from legommenders_tpu_torch.ops.additive import additive_pool
from legommenders_tpu_torch.ops.core import masked_softmax

SEQUENCE_PARALLEL = ("sequence_parallel is a multi-device path, not ported "
                     "yet (ROADMAP.md, queue 1, item 8)")

# flax's lecun_normal draws from a normal truncated at two standard
# deviations, rescaled so that the variance stays 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
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


def dense(layer: nn.Linear, x: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """flax's Dense(dtype=...): x and the kernel cast to dtype, the bias
    added in dtype."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


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


def cached_casts(module: nn.Module, params, make):
    """`make()`, the compute-dtype copies of `params`, made once per state
    of the parameters while no gradient can reach them (grad off, or every
    parameter frozen: a served model's weights, or a frozen base, do not
    change between pages) and kept on `module`; made anew when a parameter
    is replaced or written in place (its data pointer or version counter
    moves) or `module.dtype` changes; every call while a gradient can reach
    them. A cast that is a view of a parameter (a cast to its own dtype of
    a slice) is kept as a copy: a view made in inference mode whose base
    the optimizer then writes in place cannot be copied or pickled with
    the module."""
    if torch.is_grad_enabled() and any(p.requires_grad for p in params):
        return make()
    key = (module.dtype,) + tuple((p.data_ptr(), p._version) for p in params)
    cache = getattr(module, "_cast_cache", None)
    if cache is None or cache[0] != key:
        made = tuple(t.clone() if t._base is not None else t for t in make())
        module._cast_cache = cache = (key, made)
    return cache[1]


class AdditiveAttention(nn.Module):
    """exp-softmax additive pooling (..., L, D) -> (..., D), through the
    CUDA kernel on the card and the plain version on the CPU."""

    def __init__(self, input_dim: int, hidden_size: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bf16_apply and self.dtype != torch.float32:
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
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if sequence_parallel:
            raise NotImplementedError(
                f"MultiHeadSelfAttention: {SEQUENCE_PARALLEL}")
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
        H, D = self.num_heads, self.dim
        d = D // H
        lead = x.shape[:-1]
        q, k, v = (dense(layer, x, self.dtype).reshape(*lead, H, d)
                   for layer in (self.q, self.k, self.v))
        scores = torch.einsum("...qhd,...khd->...hqk", q, k)
        if self.use_scale:
            scores = scores / torch.tensor(float(d), dtype=scores.dtype).sqrt()
        if mask is not None:
            key_mask = mask[..., None, None, :].expand(scores.shape)
            attn = masked_softmax(scores, key_mask)
        else:
            attn = torch.softmax(scores, dim=-1)
        attn = dropout(attn, self.dropout, rng)
        out = torch.einsum("...hqk,...khd->...qhd", attn, v).reshape(*lead, D)
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
