"""TransformerOperator — a randomly initialised BERT-style encoder (the
MINER item encoder).

The port of the JAX package's models/operators/transformer.py:21-84
(reference transformer_operator.py:22-61): learned positions + LayerNorm,
N post-LN layers (MultiHeadSelfAttention with dropout on the
probabilities, dropout, residual LayerNorm; an FFN of 4 x hidden_size with
exact-erf gelu, dropout, residual LayerNorm; eps 1e-12) at input_dim, a
Linear to the hidden size and the additive-attention pool (H = hidden).
Submodules keep flax's names (`position_embeddings`, `LayerNorm_0`,
`layer_<i>` {`attn` {q, k, v, out}, `LayerNorm_0`, `Dense_0`, `Dense_1`,
`LayerNorm_1`}, `Dense_0`; the pool is `attention`, as the bridge names
flax's `AdditiveAttention_0`). FlattenTransformerOperator (flatten mode)
is in models/operators/flatten_ops.py.

`sequence_parallel` (JAX transformer.py:34, 56-81): the layers' attention
dropout is 0 (with or without an sp mesh, as in JAX), and under an
ambient sp mesh the operator keeps this sp rank's positions of the
sequence end to end (its L / sp positions of the embeddings, the mask and
the position table): every layer's attention runs over the sp group
(`sp_impl`: "ulysses" or "ring"), the hidden dropout draws the whole
sequence's noise and keeps the rank's positions, and the pool is the
two-psum pool. Every parameter's gradient is then partial on each sp rank
(`sp_partial_parameters`: summed over sp by the step).
"""
from typing import Optional

import torch
from torch import nn

from legommenders_tpu_torch.models.common import (
    AdditiveAttention, FrozenableLayerNorm, MultiHeadSelfAttention, dense,
    gelu, reset_linear, seq_dropout, sp_axis,
)
from legommenders_tpu_torch.ops.sp_attention import check_sequence
from legommenders_tpu_torch.parallel.mesh import scatter_seq
from legommenders_tpu_torch.models.inputers.concat import ConcatInputer
from legommenders_tpu_torch.models.operators.base import BaseOperator
from legommenders_tpu_torch.utils.registry import OPERATORS


class TransformerLayer(nn.Module):

    def __init__(self, dim: int, num_heads: int = 8,
                 intermediate_size: int = 256, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32,
                 sequence_parallel: bool = False, sp_impl: str = "ulysses"):
        super().__init__()
        self.dropout, self.dtype = dropout, dtype
        self.attn = MultiHeadSelfAttention(
            dim, num_heads, dropout=0.0 if sequence_parallel else dropout,
            use_scale=True, sequence_parallel=sequence_parallel,
            sp_impl=sp_impl, dtype=dtype)
        self.LayerNorm_0 = FrozenableLayerNorm(dim, 1e-12, dtype=dtype)
        self.Dense_0 = nn.Linear(dim, intermediate_size)
        self.Dense_1 = nn.Linear(intermediate_size, dim)
        self.LayerNorm_1 = FrozenableLayerNorm(dim, 1e-12, dtype=dtype)

    def reset_parameters(self, generator=None):
        self.attn.reset_parameters(generator)
        reset_linear(self.Dense_0, generator)
        reset_linear(self.Dense_1, generator)
        self.LayerNorm_0.reset_parameters(generator)
        self.LayerNorm_1.reset_parameters(generator)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                rng: Optional[torch.Generator] = None,
                sp=None) -> torch.Tensor:
        """`sp`: the sp axis whose rank's positions x holds (None: the
        whole sequence)."""
        attn = seq_dropout(self.attn(x, mask, rng), self.dropout, rng, sp)
        x = self.LayerNorm_0(x + attn)
        ff = gelu(dense(self.Dense_0, x, self.dtype))
        ff = seq_dropout(dense(self.Dense_1, ff, self.dtype), self.dropout,
                         rng, sp)
        return self.LayerNorm_1(x + ff)


@OPERATORS.register
class TransformerOperator(BaseOperator):
    inputer_class = ConcatInputer

    def __init__(self, hidden_size: int = 64, input_dim: int = 64,
                 num_attention_heads: int = 8, attention_dropout: float = 0.1,
                 num_hidden_layers: int = 3,
                 max_position_embeddings: int = 1024,
                 sequence_parallel: bool = False, sp_impl: str = "ulysses",
                 dtype: torch.dtype = torch.float32):
        super().__init__(hidden_size, input_dim, dtype)
        self.sequence_parallel = sequence_parallel
        self.num_hidden_layers = int(num_hidden_layers)
        self.position_embeddings = nn.Parameter(
            torch.empty(max_position_embeddings, input_dim))
        self.LayerNorm_0 = FrozenableLayerNorm(input_dim, 1e-12, dtype=dtype)
        for i in range(self.num_hidden_layers):
            self.add_module(f"layer_{i}", TransformerLayer(
                input_dim, num_attention_heads, hidden_size * 4,
                attention_dropout, dtype, sequence_parallel, sp_impl))
        self.Dense_0 = nn.Linear(input_dim, hidden_size)
        self.attention = AdditiveAttention(hidden_size, hidden_size, dtype,
                                           sequence_parallel)
        self.reset_parameters()

    def layers(self):
        return [self._modules[f"layer_{i}"]
                for i in range(self.num_hidden_layers)]

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.position_embeddings.normal_(0.0, 0.02, generator=generator)
        self.LayerNorm_0.reset_parameters(generator)
        for layer in self.layers():
            layer.reset_parameters(generator)
        reset_linear(self.Dense_0, generator)
        self.attention.reset_parameters(generator)

    def forward(self, embeddings: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        B, L, _ = embeddings.shape
        if mask is None:
            mask = torch.ones(B, L, dtype=torch.int32,
                              device=embeddings.device)
        positions = self.position_embeddings[None, :L, :]
        sp = sp_axis(self.sequence_parallel)
        if sp is not None:
            check_sequence(L, sp)
            embeddings = scatter_seq(embeddings, sp)
            mask = mask.chunk(sp.size, dim=1)[sp.index]
            positions = positions.chunk(sp.size, dim=1)[sp.index]
        x = self.LayerNorm_0(embeddings.float() + positions)
        for layer in self.layers():
            x = layer(x, mask, rng, sp)
        return self.attention(dense(self.Dense_0, x, self.dtype), mask)

    def sp_partial_parameters(self):
        """Under sp each rank's positions give part of every parameter's
        gradient."""
        return list(self.parameters()) if self.sequence_parallel else []

