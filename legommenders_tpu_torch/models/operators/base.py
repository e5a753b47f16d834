"""Operator base — item/user encoders.

The port of the JAX package's models/operators/base.py (reference
model/operators/base_operator.py:22-73): the class-level `inputer_class`,
`allow_caching` (the representation may be precomputed for fast eval) and
`flatten_mode` flags; an item operator reads its columns through
ConcatInputer unless it names another (JAX base.py:29). Each operator is
an nn.Module
    forward(embeddings, mask) -> (N, output_dim)
where `embeddings` is (N, L, D), or a dict col -> (N, L_c, D) for
SimpleInputer-style operators.
"""
import torch
from torch import nn

from legommenders_tpu_torch.models.inputers.concat import ConcatInputer


class BaseOperator(nn.Module):
    inputer_class = ConcatInputer
    allow_caching: bool = True
    flatten_mode: bool = False

    def __init__(self, hidden_size: int = 64, input_dim: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_size = hidden_size
        self.input_dim = input_dim
        self.dtype = dtype

    @property
    def output_dim(self) -> int:
        return self.hidden_size

    def output_levels(self, cols) -> int:
        """Vectors an item's output holds: 1, or the rows of a stack."""
        return 1

    def reset_parameters(self, generator=None):
        raise NotImplementedError
