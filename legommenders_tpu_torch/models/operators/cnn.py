"""CNNOperator — the NAML item encoder.

The port of the JAX package's models/operators/cnn.py:18-46 (reference
model/operators/cnn_operator.py:25-67): per-column Conv1d 'same' + ReLU +
mask + dropout, a Linear for length-1 columns, concatenation on the
sequence axis, then additive attention. Tensors stay (N, L, D) at the
module boundary; only the convolution runs in PyTorch's (N, C, L) layout.
The dropout draws from the forward's generator `rng` (None: eval).
"""
from typing import Optional

import torch
from torch import nn

from legommenders_tpu_torch.models.common import (
    AdditiveAttention, dropout, reset_linear,
)
from legommenders_tpu_torch.models.operators.base import BaseOperator
from legommenders_tpu_torch.utils.registry import OPERATORS


@OPERATORS.register
class CNNOperator(BaseOperator):

    def __init__(self, hidden_size: int = 64, input_dim: int = 64,
                 kernel_size: int = 3, dropout: float = 0.1,
                 additive_hidden_size: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__(hidden_size, input_dim, dtype)
        self.kernel_size = kernel_size
        self.cnn = nn.Conv1d(input_dim, hidden_size, kernel_size)
        self.linear = nn.Linear(input_dim, hidden_size)
        self.dropout = dropout
        self.attention = AdditiveAttention(hidden_size, additive_hidden_size,
                                           dtype)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        reset_linear(self.cnn, generator)
        reset_linear(self.linear, generator)
        self.attention.reset_parameters(generator)

    def _conv_same(self, emb: torch.Tensor) -> torch.Tensor:
        # flax 'SAME': (k-1)//2 zeros on the left, k//2 on the right
        k = self.kernel_size
        x = nn.functional.pad(emb.to(self.dtype).transpose(1, 2),
                              ((k - 1) // 2, k // 2))
        y = nn.functional.conv1d(x, self.cnn.weight.to(self.dtype),
                                 self.cnn.bias.to(self.dtype))
        return y.transpose(1, 2)

    def forward(self, embeddings: dict, mask: dict,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        outs, out_masks = [], []
        for col, emb in embeddings.items():
            m = mask[col]
            if emb.shape[-2] > 1:
                x = torch.relu(self._conv_same(emb))
                x = x * m[..., None].to(x.dtype)
                x = dropout(x, self.dropout, rng)
            else:
                x = nn.functional.linear(emb.to(self.dtype),
                                         self.linear.weight.to(self.dtype),
                                         self.linear.bias.to(self.dtype))
            outs.append(x)
            out_masks.append(m)
        seq = torch.cat(outs, dim=-2)
        seq_mask = torch.cat(out_masks, dim=-1)
        return self.attention(seq, seq_mask)
