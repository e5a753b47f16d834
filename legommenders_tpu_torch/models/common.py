"""Shared blocks: AdditiveAttention, dropout and flax-equivalent
initialisers.

AdditiveAttention mirrors the JAX package's models/common.py:16-66 without
its sequence-parallel branch. Parameters keep the JAX names and layouts:
proj_kernel (D, H), proj_bias (H,), query (H, 1).

Dropout draws from an explicit torch.Generator handed down with the
forward (`rng`), never from torch's global generator; `rng=None` is eval
mode, as `training=False` is in JAX.
"""
import math
from typing import Optional

import torch
from torch import nn

from legommenders_tpu_torch.ops.additive import additive_pool

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
    with torch.no_grad():
        layer.bias.zero_()


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
