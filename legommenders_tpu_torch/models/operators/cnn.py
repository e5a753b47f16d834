"""CNNOperator / CNNCatOperator — the NAML and LSTUR item encoders.

The port of the JAX package's models/operators/cnn.py:18-82 (reference
model/operators/cnn_operator.py:25-67 and cnn_cat_operator.py):
  * CNNOperator: per-column Conv1d 'same' + ReLU + mask + dropout, a
    Linear for length-1 columns, concatenation on the sequence axis, then
    additive attention;
  * CNNCatOperator: per column a conv (`cnn_<col>`) or, for a length-1
    column, a Linear (`linear_<col>`), then its own additive attention
    (`att_<col>`); the pooled columns concatenated on the feature axis
    (output_dim = hidden x num_cols). Its blocks are built from the item
    columns LegoConfig passes (`cols`).
Tensors stay (N, L, D) at the module boundary; only the convolution runs
in PyTorch's (N, C, L) layout. The dropout draws from the forward's
generator `rng` (None: eval).
"""
from typing import Optional

import torch
from torch import nn

from legommenders_tpu_torch.models.common import (
    AdditiveAttention, dense, dropout, reset_linear,
)
from legommenders_tpu_torch.models.inputers.simple import SimpleInputer
from legommenders_tpu_torch.models.operators.base import BaseOperator
from legommenders_tpu_torch.utils.registry import OPERATORS


def conv_same(conv: nn.Conv1d, emb: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """flax's nn.Conv(padding='SAME') over (N, L, D): (k-1)//2 zeros on the
    left, k//2 on the right; x and the kernel cast to dtype."""
    k = conv.kernel_size[0]
    x = nn.functional.pad(emb.to(dtype).transpose(1, 2),
                          ((k - 1) // 2, k // 2))
    y = nn.functional.conv1d(x, conv.weight.to(dtype), conv.bias.to(dtype))
    return y.transpose(1, 2)


@OPERATORS.register
class CNNOperator(BaseOperator):
    inputer_class = SimpleInputer

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

    def forward(self, embeddings: dict, mask: dict,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        outs, out_masks = [], []
        for col, emb in embeddings.items():
            m = mask[col]
            if emb.shape[-2] > 1:
                x = torch.relu(conv_same(self.cnn, emb, self.dtype))
                x = x * m[..., None].to(x.dtype)
                x = dropout(x, self.dropout, rng)
            else:
                x = dense(self.linear, emb, self.dtype)
            outs.append(x)
            out_masks.append(m)
        seq = torch.cat(outs, dim=-2)
        seq_mask = torch.cat(out_masks, dim=-1)
        return self.attention(seq, seq_mask)


@OPERATORS.register
class CNNCatOperator(BaseOperator):
    inputer_class = SimpleInputer

    def __init__(self, hidden_size: int = 64, input_dim: int = 64,
                 kernel_size: int = 3, dropout: float = 0.1,
                 additive_hidden_size: int = 256, num_cols: int = 1,
                 cols=(), dtype: torch.dtype = torch.float32):
        super().__init__(hidden_size, input_dim, dtype)
        if not cols or len(cols) != num_cols:
            raise ValueError(
                f"CNNCatOperator builds a block per item column: it needs "
                f"`cols` (LegoConfig passes them), got {len(cols)} for "
                f"num_cols={num_cols}")
        self.num_cols = num_cols
        self.dropout = dropout
        self.col_lens = {col: int(L) for col, _, L in cols}
        for col, L in self.col_lens.items():
            if L > 1:
                self.add_module(f"cnn_{col}", nn.Conv1d(
                    input_dim, hidden_size, kernel_size))
            else:
                self.add_module(f"linear_{col}",
                                nn.Linear(input_dim, hidden_size))
            self.add_module(f"att_{col}", AdditiveAttention(
                hidden_size, additive_hidden_size, dtype))
        self.reset_parameters()

    @property
    def output_dim(self) -> int:
        return self.hidden_size * self.num_cols

    def reset_parameters(self, generator=None):
        for col, L in self.col_lens.items():
            reset_linear(self._modules[f"{'cnn' if L > 1 else 'linear'}_"
                                       f"{col}"], generator)
            self._modules[f"att_{col}"].reset_parameters(generator)

    def forward(self, embeddings: dict, mask: dict,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        outs = []
        for col, emb in embeddings.items():
            m = mask[col]
            if emb.shape[-2] > 1:
                x = torch.relu(conv_same(self._modules[f"cnn_{col}"], emb,
                                         self.dtype))
                x = x * m[..., None].to(x.dtype)
                x = dropout(x, self.dropout, rng)
            else:
                x = dense(self._modules[f"linear_{col}"], emb, self.dtype)
            outs.append(self._modules[f"att_{col}"](x, m))
        return torch.cat(outs, dim=-1)
