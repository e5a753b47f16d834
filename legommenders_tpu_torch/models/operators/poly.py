"""PolyAttentionOperator — the MINER user encoder (poly context codes).

The port of the JAX package's models/operators/poly.py:14-39 (reference
poly_attention_operator.py:20-62): a bias-free tanh projection of the
clicks (`Dense_0`) scored against learned context codes
(`context_codes`, (K, C')), a softmax over the clicks per code, and the
code-weighted sums of the clicks: (B, K, D). As in the reference, masked
scores are set to 1e-30, not -inf, before a plain softmax: masked clicks
keep weight. `allow_caching = False`: the user repr is a matrix, so the
Manager evaluates MINER by full forwards. Dtypes promote as in JAX (the
codes are f32, so the scores and the output are f32).
"""
from typing import Optional

import torch
from torch import nn

from legommenders_tpu_torch.models.common import dense, reset_linear
from legommenders_tpu_torch.models.operators.base import BaseOperator
from legommenders_tpu_torch.utils.registry import OPERATORS


@OPERATORS.register
class PolyAttentionOperator(BaseOperator):
    allow_caching = False

    def __init__(self, hidden_size: int = 64, input_dim: int = 64,
                 num_context_codes: int = 32, context_code_dim: int = 200,
                 dtype: torch.dtype = torch.float32):
        super().__init__(hidden_size, input_dim, dtype)
        self.Dense_0 = nn.Linear(input_dim, context_code_dim, bias=False)
        self.context_codes = nn.Parameter(
            torch.empty(num_context_codes, context_code_dim))
        self.reset_parameters()

    @property
    def output_dim(self) -> int:
        return self.input_dim

    def reset_parameters(self, generator=None):
        reset_linear(self.Dense_0, generator)
        nn.init.xavier_uniform_(self.context_codes, generator=generator)

    def forward(self, embeddings: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        proj = torch.tanh(dense(self.Dense_0, embeddings, self.dtype))
        weights = torch.einsum("blc,kc->bkl", proj.float(),
                               self.context_codes)
        if mask is not None:
            weights = torch.where(mask[:, None, :] > 0, weights,
                                  torch.full_like(weights, 1e-30))
        weights = torch.softmax(weights, dim=-1)
        return torch.einsum("bkl,bld->bkd", weights, embeddings.float())
