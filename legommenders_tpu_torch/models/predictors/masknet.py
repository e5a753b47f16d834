"""MaskNet — instance-guided mask blocks, serial or parallel.

The port of the JAX package's models/predictors/masknet.py (reference
mask_net_predictor.py:61-192). Names are flax's: `norm_u` / `norm_i`
(the embedding LayerNorms), `block_<i>`, then `fc` (serial) or the MLP
`dnn` (parallel). Inside a MaskBlock flax numbers its Dense layers in the
order they are constructed: `Dense_1` (embeddings -> mid), `Dense_0`
(mid -> hidden_dim), `Dense_2` (hidden_dim -> output_dim, no bias), and
`LayerNorm_0` (eps 1e-5).
"""
from typing import Optional, Sequence

import torch
from torch import nn

from legommenders_tpu_torch.models.common import (
    FrozenableLayerNorm, MLPLayer, dense, dropout, get_activation,
    reset_children,
)
from legommenders_tpu_torch.models.predictors.base import BasePredictor
from legommenders_tpu_torch.utils.registry import PREDICTORS


class MaskBlock(nn.Module):
    """Dense_2(mask(embeddings) * hidden) -> LayerNorm -> activation ->
    dropout, mask = Dense_0(relu(Dense_1(embeddings)))."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 activation: str = "relu", reduction_ratio: float = 1.0,
                 dropout: float = 0.0, layer_norm: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = int(hidden_dim * reduction_ratio)
        self.act = get_activation(activation)
        self.dropout, self.dtype = dropout, dtype
        self.Dense_1 = nn.Linear(input_dim, mid)
        self.Dense_0 = nn.Linear(mid, hidden_dim)
        self.Dense_2 = nn.Linear(hidden_dim, output_dim, bias=False)
        self.LayerNorm_0 = (FrozenableLayerNorm(output_dim, 1e-5, dtype=dtype)
                            if layer_norm else None)

    def reset_parameters(self, generator=None):
        reset_children(self, generator)

    def forward(self, embeddings, hidden, rng=None):
        mask = dense(self.Dense_0, torch.relu(
            dense(self.Dense_1, embeddings, self.dtype)), self.dtype)
        x = dense(self.Dense_2, mask * hidden, self.dtype)
        if self.LayerNorm_0 is not None:
            x = self.LayerNorm_0(x)
        return dropout(self.act(x), self.dropout, rng)


@PREDICTORS.register
class MaskNetPredictor(BasePredictor):

    def __init__(self, hidden_size: int = 64, input_dim: int = 64,
                 hidden_units: Sequence[int] = (64, 64),
                 activations: str = "relu",
                 output_activation: Optional[str] = None,
                 dropout: float = 0.0, layer_norm: bool = True,
                 embed_layer_norm: bool = True, reduction_ratio: float = 1.0,
                 num_blocks: int = 1, block_dim: int = 64,
                 sequential_mode: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__(hidden_size, dtype)
        self.sequential_mode = sequential_mode
        self.out_act = (get_activation(output_activation)
                        if output_activation else None)
        D = 2 * input_dim
        self.norm_u = self.norm_i = None
        if embed_layer_norm:
            self.norm_u = FrozenableLayerNorm(input_dim, 1e-5, dtype=dtype)
            self.norm_i = FrozenableLayerNorm(input_dim, 1e-5, dtype=dtype)
        block = dict(activation=activations, reduction_ratio=reduction_ratio,
                     dropout=dropout, layer_norm=layer_norm, dtype=dtype)
        self.fc = self.dnn = None
        if sequential_mode:
            widths = [D] + [int(w) for w in hidden_units]
            self.num_blocks = len(widths) - 1
            for i in range(self.num_blocks):
                self.add_module(f"block_{i}", MaskBlock(
                    D, widths[i], widths[i + 1], **block))
            self.fc = nn.Linear(widths[-1], 1)
        else:
            self.num_blocks = num_blocks
            for i in range(num_blocks):
                self.add_module(f"block_{i}",
                                MaskBlock(D, D, block_dim, **block))
            self.dnn = MLPLayer(num_blocks * block_dim, hidden_units, 1,
                                activations, dropout,
                                output_activation=output_activation,
                                dtype=dtype)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        reset_children(self, generator)

    def score_pair(self, user, item, rng=None):
        x = torch.cat([user, item], dim=-1)
        hidden = x
        if self.norm_u is not None:
            hidden = torch.cat([self.norm_u(user), self.norm_i(item)], dim=-1)
        blocks = [getattr(self, f"block_{i}") for i in range(self.num_blocks)]
        if self.sequential_mode:
            out = hidden
            for blk in blocks:
                out = blk(x, out, rng)
            out = dense(self.fc, out, self.dtype)
            if self.out_act is not None:
                out = self.out_act(out)
            return out.squeeze(-1)
        concat = torch.cat([blk(x, hidden, rng) for blk in blocks], dim=-1)
        return self.dnn(concat, rng).squeeze(-1)
