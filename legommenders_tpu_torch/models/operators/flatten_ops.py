"""Flatten-mode user operators (BST style).

The port of the JAX package's FlattenTransformerOperator
(models/operators/transformer.py:84-91) and FlattenFastformerOperator
(models/operators/flatten_ops.py:14-18; reference
model/operators/flatten_{transformer,fastformer}_operator.py): their
parents' architectures over the FlattenSeqInputer sequence of a user's
whole click history. User-only, never cached (`allow_caching` False:
evaluation runs full forwards). The sequence reads a learned position per
token, so it may be no longer than the operator's position table
(`max_position_embeddings`: 1,024 for the Transformer, 512 for
Fastformer); a longer one raises, naming the limit, where JAX fails on
the shapes. Their user pools run over the whole flattened sequence (the
long-sequence pool kernel, ops/additive.py).
"""
from typing import Optional

import torch

from legommenders_tpu_torch.models.inputers.flatten import FlattenSeqInputer
from legommenders_tpu_torch.models.operators.fastformer import (
    FastformerOperator,
)
from legommenders_tpu_torch.models.operators.transformer import (
    TransformerOperator,
)
from legommenders_tpu_torch.utils.registry import OPERATORS


class _Flatten:
    flatten_mode = True
    user_only = True
    allow_caching = False
    inputer_class = FlattenSeqInputer

    def forward(self, embeddings: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        L, limit = embeddings.shape[1], self.position_embeddings.shape[0]
        if L > limit:
            raise ValueError(
                f"{type(self).__name__}: the flattened history is {L} tokens "
                f"long, more than its {limit} positions "
                f"(max_position_embeddings); cut the history in the data "
                f"config's user column")
        return super().forward(embeddings, mask, rng)


@OPERATORS.register
class FlattenTransformerOperator(_Flatten, TransformerOperator):
    pass


@OPERATORS.register
class FlattenFastformerOperator(_Flatten, FastformerOperator):
    pass
