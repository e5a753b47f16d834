"""FinalMLP — two MLP streams fused by a bilinear InteractionAggregation.

The port of the JAX package's models/predictors/finalmlp.py (reference
final_mlp_predictor.py:81-146). Names are flax's: `mlp1`, `mlp2`,
`InteractionAggregation_0` with `w_x`, `w_y` (Dense) and `w_xy`
(H, hx, hy * output_dim).
"""
from typing import Sequence

import torch
from torch import nn

from legommenders_tpu_torch.models.common import (
    MLPLayer, dense, einsum, glorot_normal_, reset_children, reset_linear,
)
from legommenders_tpu_torch.models.predictors.base import BasePredictor
from legommenders_tpu_torch.utils.registry import PREDICTORS


class InteractionAggregation(nn.Module):
    """w_x x + w_y y + the sum over H heads of x_h^T W_h y_h."""

    def __init__(self, x_dim: int, y_dim: int, num_heads: int = 1,
                 output_dim: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        if x_dim % num_heads or y_dim % num_heads:
            raise ValueError(f"InteractionAggregation: widths {x_dim}, "
                             f"{y_dim} % heads {num_heads} != 0")
        self.num_heads, self.output_dim, self.dtype = (num_heads, output_dim,
                                                       dtype)
        self.hx, self.hy = x_dim // num_heads, y_dim // num_heads
        self.w_x = nn.Linear(x_dim, output_dim)
        self.w_y = nn.Linear(y_dim, output_dim)
        self.w_xy = nn.Parameter(torch.empty(num_heads, self.hx,
                                             self.hy * output_dim))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        reset_linear(self.w_x, generator)
        reset_linear(self.w_y, generator)
        glorot_normal_(self.w_xy, generator)

    def forward(self, x, y):
        H, O = self.num_heads, self.output_dim
        out = dense(self.w_x, x, self.dtype) + dense(self.w_y, y, self.dtype)
        head_x = x.reshape(*x.shape[:-1], H, self.hx)
        head_y = y.reshape(*y.shape[:-1], H, self.hy)
        # bilinear per head: x_h^T W_h y_h
        xw = einsum("...hx,hxz->...hz", head_x, self.w_xy)
        xw = xw.reshape(*x.shape[:-1], H, O, self.hy)
        xy = einsum("...hoy,...hy->...ho", xw, head_y)
        return out + xy.sum(dim=-2)


@PREDICTORS.register
class FinalMLPPredictor(BasePredictor):

    def __init__(self, hidden_size: int = 64, input_dim: int = 64,
                 mlp1_hidden_units: Sequence[int] = (1000, 1000, 1000),
                 mlp1_hidden_activations: str = "relu",
                 mlp1_dropout: float = 0.0, mlp1_batch_norm: bool = False,
                 mlp2_hidden_units: Sequence[int] = (1000, 1000, 1000),
                 mlp2_hidden_activations: str = "relu",
                 mlp2_dropout: float = 0.0, mlp2_batch_norm: bool = False,
                 num_heads: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__(hidden_size, dtype)
        D = 2 * input_dim
        self.mlp1 = MLPLayer(D, mlp1_hidden_units, None,
                             mlp1_hidden_activations, mlp1_dropout,
                             mlp1_batch_norm, dtype=dtype)
        self.mlp2 = MLPLayer(D, mlp2_hidden_units, None,
                             mlp2_hidden_activations, mlp2_dropout,
                             mlp2_batch_norm, dtype=dtype)
        self.InteractionAggregation_0 = InteractionAggregation(
            self.mlp1.out_dim, self.mlp2.out_dim, num_heads, 1, dtype)

    def reset_parameters(self, generator=None):
        reset_children(self, generator)

    def score_pair(self, user, item, rng=None):
        x = torch.cat([user, item], dim=-1)
        return self.InteractionAggregation_0(
            self.mlp1(x, rng), self.mlp2(x, rng)).squeeze(-1)
