"""The semantic-ID user operators.

The port of the JAX package's models/operators/semantic.py (reference
semantic_operator.py:32-85):
  * SemanticOperator: a user-only flatten-mode operator over the
    history's code embeddings (B, S, C, D). For level i < min(C,
    num_semantic_layers) its own clone of the base user operator
    (`base_<i>`) encodes the running sum of the code embeddings of levels
    0..i under the click mask; the levels' outputs are stacked (B, n, D')
    and pooled by additive attention (`pool`, the pool kernel at L = n),
    or returned as the stack with `return_stack` (PolyPredictor reads
    it; no `pool` then);
  * SCMixOperator: the user's own codes (B, C, D) passed through, for
    SemanticMixPredictor (JAX completes the reference's wiring so).
Neither may be cached: the user side reads the batch, not click vectors.
"""
from typing import Optional

import torch

from legommenders_tpu_torch.models.common import AdditiveAttention
from legommenders_tpu_torch.models.inputers.semantic import (
    SemanticInputer, SemanticMixInputer,
)
from legommenders_tpu_torch.models.operators.base import BaseOperator
from legommenders_tpu_torch.utils.registry import OPERATORS


@OPERATORS.register
class SCMixOperator(BaseOperator):
    inputer_class = SemanticMixInputer
    flatten_mode = True
    user_only = True
    allow_caching = False

    @property
    def output_dim(self) -> int:
        return self.input_dim

    def reset_parameters(self, generator=None):
        pass

    def forward(self, embeddings, mask=None, rng=None):
        return embeddings


@OPERATORS.register
class SemanticOperator(BaseOperator):
    inputer_class = SemanticInputer
    flatten_mode = True
    user_only = True
    allow_caching = False

    def __init__(self, hidden_size: int = 64, input_dim: int = 64,
                 base_operator: str = "Ada",
                 base_operator_config: Optional[dict] = None,
                 num_semantic_layers: int = 4,
                 additive_hidden_size: int = 256, return_stack: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__(hidden_size, input_dim, dtype)
        from legommenders_tpu_torch.models.lego_config import init_fields

        cls = OPERATORS[base_operator]
        known = init_fields(cls)
        cfg = {k: v for k, v in (base_operator_config or {}).items()
               if k in known}
        cfg.setdefault("hidden_size", hidden_size)
        cfg.setdefault("input_dim", input_dim)
        self.num_semantic_layers = num_semantic_layers
        self.return_stack = return_stack
        for i in range(num_semantic_layers):
            self.add_module(f"base_{i}", cls(dtype=dtype, **cfg))
        # a stack is returned unpooled: no pool (JAX creates none)
        self.pool = (None if return_stack else AdditiveAttention(
            self.base_0.output_dim, additive_hidden_size, dtype))

    @property
    def output_dim(self) -> int:
        return self.input_dim

    def reset_parameters(self, generator=None):
        for i in range(self.num_semantic_layers):
            getattr(self, f"base_{i}").reset_parameters(generator)
        if self.pool is not None:
            self.pool.reset_parameters(generator)

    def forward(self, embeddings: torch.Tensor, mask=None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """embeddings (B, S, C, D), mask (B, S) -> (B, D') or (B, n, D')."""
        n = min(embeddings.shape[2], self.num_semantic_layers)
        increment = torch.zeros_like(embeddings[:, :, 0])
        outs = []
        for i in range(n):
            increment = increment + embeddings[:, :, i]
            outs.append(getattr(self, f"base_{i}")(increment, mask, rng=rng))
        stack = torch.stack(outs, dim=1)
        return stack if self.return_stack else self.pool(stack)
