"""AdaOperator — additive attention pooling only.

The port of the JAX package's models/operators/ada.py (reference
model/operators/ada_operator.py:18-38; the default user operator of
NAML). Output dim == input dim.
"""
import torch

from legommenders_tpu_torch.models.common import AdditiveAttention
from legommenders_tpu_torch.models.operators.base import BaseOperator
from legommenders_tpu_torch.utils.registry import OPERATORS


@OPERATORS.register
class AdaOperator(BaseOperator):

    def __init__(self, hidden_size: int = 64, input_dim: int = 64,
                 additive_hidden_size: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__(hidden_size, input_dim, dtype)
        self.attention = AdditiveAttention(input_dim, additive_hidden_size,
                                           dtype)

    @property
    def output_dim(self) -> int:
        return self.input_dim

    def reset_parameters(self, generator=None):
        self.attention.reset_parameters(generator)

    def forward(self, embeddings, mask=None, rng=None):
        return self.attention(embeddings, mask)
