"""AttentionOperator — the NRMS item and user encoder.

The port of the JAX package's models/operators/attention.py:14-30
(reference attention_operator.py:24-59): multi-head self-attention over
the sequence (dropout on the probabilities), a Linear to the hidden size,
then the additive-attention pool. Submodules keep flax's names
(`MultiHeadSelfAttention_0`, `Dense_0`; the pool is `attention`, as the
bridge names flax's `AdditiveAttention_0`).
"""
from typing import Optional

import torch
from torch import nn

from legommenders_tpu_torch.models.common import (
    AdditiveAttention, MultiHeadSelfAttention, dense, reset_linear,
)
from legommenders_tpu_torch.models.inputers.concat import ConcatInputer
from legommenders_tpu_torch.models.operators.base import BaseOperator
from legommenders_tpu_torch.utils.registry import OPERATORS


@OPERATORS.register
class AttentionOperator(BaseOperator):
    inputer_class = ConcatInputer

    def __init__(self, hidden_size: int = 64, input_dim: int = 64,
                 num_attention_heads: int = 8, attention_dropout: float = 0.1,
                 additive_hidden_size: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__(hidden_size, input_dim, dtype)
        self.MultiHeadSelfAttention_0 = MultiHeadSelfAttention(
            input_dim, num_attention_heads, dropout=attention_dropout,
            use_scale=True, dtype=dtype)
        self.Dense_0 = nn.Linear(input_dim, hidden_size)
        self.attention = AdditiveAttention(hidden_size, additive_hidden_size,
                                           dtype)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        self.MultiHeadSelfAttention_0.reset_parameters(generator)
        reset_linear(self.Dense_0, generator)
        self.attention.reset_parameters(generator)

    def forward(self, embeddings: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        out = self.MultiHeadSelfAttention_0(embeddings, mask, rng)
        out = dense(self.Dense_0, out, self.dtype)
        return self.attention(out, mask)
