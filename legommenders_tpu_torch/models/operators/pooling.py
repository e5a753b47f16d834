"""PoolingOperator, the null operators and the single-column identity.

The port of the JAX package's models/operators/pooling.py:22-86
(reference pooling_operator.py:23-61: a masked mean or max per column,
then the mean, max or concatenation across columns; null_operator.py:
12-25: the pass-through dict DIN reads; single_column_operator.py) and
SCFlattenOperator, the single-column identity in flatten mode (JAX
:89-91). None has parameters.
"""
from typing import Dict, Optional, Union

import torch

from legommenders_tpu_torch.models.inputers.concat import ConcatInputer
from legommenders_tpu_torch.models.inputers.simple import SimpleInputer
from legommenders_tpu_torch.models.inputers.single_column import (
    SingleColumnInputer,
)
from legommenders_tpu_torch.models.operators.base import BaseOperator
from legommenders_tpu_torch.ops.core import masked_max
from legommenders_tpu_torch.utils.registry import OPERATORS

Embeddings = Union[torch.Tensor, Dict[str, torch.Tensor]]


class _Parameterless(BaseOperator):
    """Output width = input width; nothing to draw."""

    @property
    def output_dim(self) -> int:
        return self.input_dim

    def reset_parameters(self, generator=None):
        pass


@OPERATORS.register
class PoolingOperator(_Parameterless):
    inputer_class = SimpleInputer

    def __init__(self, hidden_size: int = 64, input_dim: int = 64,
                 flatten: bool = False, max_pooling: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__(hidden_size, input_dim, dtype)
        self.flatten = flatten
        self.max_pooling = max_pooling

    def forward(self, embeddings: Embeddings, mask=None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        if not isinstance(embeddings, dict):
            embeddings, mask = {"temp": embeddings}, {"temp": mask}
        pooled = []
        for col, emb in embeddings.items():
            m = mask[col].to(emb.dtype)
            if self.max_pooling:
                pooled.append(masked_max(emb, m))
            else:
                s = torch.einsum("...l,...ld->...d", m, emb)
                pooled.append(s / (m.sum(dim=-1, keepdim=True) + 1e-8))
        if self.flatten:
            return torch.cat(pooled, dim=-1)
        stack = torch.stack(pooled, dim=-2)
        if self.max_pooling:
            return stack.amax(dim=-2)
        return stack.mean(dim=-2)


@OPERATORS.register
class NullSimpleOperator(_Parameterless):
    """Pass-through returning {embedding, mask} (DIN's user side)."""
    inputer_class = SimpleInputer
    allow_caching = False

    def forward(self, embeddings: Embeddings, mask=None,
                rng: Optional[torch.Generator] = None) -> dict:
        return {"embedding": embeddings, "mask": mask}


@OPERATORS.register
class NullConcatOperator(NullSimpleOperator):
    inputer_class = ConcatInputer


@OPERATORS.register
class SCSimpleOperator(_Parameterless):
    """Single-column identity (reference single_column_operator.py): an
    (N, 1, D) input loses its length axis."""
    inputer_class = SingleColumnInputer

    def output_levels(self, cols) -> int:
        """A column of L > 1 tokens stays a stack of L vectors."""
        return max(1, int(cols[0][2]))

    def forward(self, embeddings: torch.Tensor, mask=None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        if embeddings.ndim == 3 and embeddings.shape[-2] == 1:
            return embeddings[..., 0, :]
        return embeddings


@OPERATORS.register
class SCFlattenOperator(SCSimpleOperator):
    """SCSimple in flatten mode, never cached (JAX pooling.py:89-91)."""
    flatten_mode = True
    allow_caching = False
