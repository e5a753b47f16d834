"""FastformerOperator — the Fastformer item and user encoder.

The port of the JAX package's models/operators/fastformer.py:17-115
(reference model/common/fastformer.py:6-227 wired by
fastformer_operator.py:24-49): learned positions + LayerNorm + dropout,
N Fastformer layers (per-head additive pooling of the queries, then of the
query-mixed keys, a `transform` Linear and a residual; a BERT FFN with
exact-erf gelu; post-LN residuals, eps 1e-12), the additive-attention
pooler (H = D) and a Linear to the hidden size. The padding mask enters the
two softmaxes as an additive -10000. Submodules keep flax's names:
`position_embeddings`, `LayerNorm_0`, `layer_<i>` ({`FastSelfAttention_0`
{`query`, `key`, `query_att`, `key_att`, `transform`}, `self_out`,
`LayerNorm_0`, `intermediate`, `output`, `LayerNorm_1`}), `pooler`,
`proj`. Dtypes promote as in JAX: the -10000 bias is f32, so the softmaxes
and the pooled query and key run in f32, the Linear layers in the compute
dtype. Dropout draws from the forward's generator (None: eval).

`sequence_parallel` (JAX fastformer.py:84-86, 113): only the pooler is
sequence-parallel. Under an ambient sp mesh the mixing layers run over the
whole sequence on every sp rank (the same draws as one process: their
gradients are whole), and the pooler takes this rank's positions of their
output through the two-psum pool; the pooler's gradient is then partial
on each sp rank (`sp_partial_parameters`).
"""
from typing import Optional

import torch
from torch import nn

from legommenders_tpu_torch.models.common import (
    AdditiveAttention, FrozenableLayerNorm, dense, dropout, gelu,
    reset_linear, sp_axis,
)
from legommenders_tpu_torch.ops.sp_attention import check_sequence
from legommenders_tpu_torch.parallel.mesh import scatter_seq
from legommenders_tpu_torch.models.inputers.concat import ConcatInputer
from legommenders_tpu_torch.models.operators.base import BaseOperator
from legommenders_tpu_torch.utils.registry import OPERATORS


class FastSelfAttention(nn.Module):

    def __init__(self, dim: int, num_heads: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.query_att = nn.Linear(dim, num_heads)
        self.key_att = nn.Linear(dim, num_heads)
        self.transform = nn.Linear(dim, dim)

    def reset_parameters(self, generator=None):
        for layer in (self.query, self.key, self.query_att, self.key_att,
                      self.transform):
            reset_linear(layer, generator)

    def forward(self, x: torch.Tensor,
                neg_mask_bias: torch.Tensor) -> torch.Tensor:
        """x (B, L, D); neg_mask_bias (B, 1, L) f32, -10000 at padding."""
        B, L, D = x.shape
        H = self.num_heads
        d = D // H
        q = dense(self.query, x, self.dtype)
        k = dense(self.key, x, self.dtype)
        # the global query: a softmax over L of one score per head
        q_score = dense(self.query_att, q, self.dtype) / (d ** 0.5)
        q_w = torch.softmax(q_score.transpose(1, 2) + neg_mask_bias, dim=-1)
        q_heads = q.reshape(B, L, H, d).transpose(1, 2)             # B,H,L,d
        pooled_q = torch.einsum("bhl,bhld->bhd", q_w, q_heads.to(q_w.dtype))
        mixed_qk = k * pooled_q.reshape(B, 1, D)             # head-major
        k_score = dense(self.key_att, mixed_qk, self.dtype) / (d ** 0.5)
        k_w = torch.softmax(k_score.transpose(1, 2) + neg_mask_bias, dim=-1)
        k_heads = mixed_qk.reshape(B, L, H, d).transpose(1, 2)
        pooled_k = torch.einsum("bhl,bhld->bhd", k_w, k_heads.to(k_w.dtype))
        weighted = pooled_k[:, :, None, :] * q_heads                # B,H,L,d
        weighted = weighted.transpose(1, 2).reshape(B, L, D)
        return dense(self.transform, weighted, self.dtype) + q


class FastformerLayer(nn.Module):

    def __init__(self, dim: int, num_heads: int = 8, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout, self.dtype = dropout, dtype
        self.FastSelfAttention_0 = FastSelfAttention(dim, num_heads, dtype)
        self.self_out = nn.Linear(dim, dim)
        self.LayerNorm_0 = FrozenableLayerNorm(dim, 1e-12, dtype=dtype)
        self.intermediate = nn.Linear(dim, 4 * dim)
        self.output = nn.Linear(4 * dim, dim)
        self.LayerNorm_1 = FrozenableLayerNorm(dim, 1e-12, dtype=dtype)

    def reset_parameters(self, generator=None):
        self.FastSelfAttention_0.reset_parameters(generator)
        for layer in (self.self_out, self.intermediate, self.output):
            reset_linear(layer, generator)
        self.LayerNorm_0.reset_parameters(generator)
        self.LayerNorm_1.reset_parameters(generator)

    def forward(self, x: torch.Tensor, neg_mask_bias: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        attn = self.FastSelfAttention_0(x, neg_mask_bias)
        attn = dense(self.self_out, attn, self.dtype)
        attn = dropout(attn, self.dropout, rng)
        attn = self.LayerNorm_0(attn + x)
        inter = gelu(dense(self.intermediate, attn, self.dtype))
        out = dense(self.output, inter, self.dtype)
        out = dropout(out, self.dropout, rng)
        return self.LayerNorm_1(out + attn)


@OPERATORS.register
class FastformerOperator(BaseOperator):
    inputer_class = ConcatInputer

    def __init__(self, hidden_size: int = 64, input_dim: int = 64,
                 num_hidden_layers: int = 3, num_attention_heads: int = 8,
                 hidden_dropout_prob: float = 0.1,
                 max_position_embeddings: int = 512,
                 sequence_parallel: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__(hidden_size, input_dim, dtype)
        self.sequence_parallel = sequence_parallel
        self.num_hidden_layers = int(num_hidden_layers)
        self.hidden_dropout_prob = hidden_dropout_prob
        self.position_embeddings = nn.Parameter(
            torch.empty(max_position_embeddings, input_dim))
        self.LayerNorm_0 = FrozenableLayerNorm(input_dim, 1e-12, dtype=dtype)
        for i in range(self.num_hidden_layers):
            self.add_module(f"layer_{i}", FastformerLayer(
                input_dim, num_attention_heads, hidden_dropout_prob, dtype))
        self.pooler = AdditiveAttention(input_dim, input_dim, dtype,
                                        sequence_parallel)
        self.proj = nn.Linear(input_dim, hidden_size)
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
        self.pooler.reset_parameters(generator)
        reset_linear(self.proj, generator)

    def forward(self, embeddings: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        B, L, _ = embeddings.shape
        if mask is None:
            mask = torch.ones(B, L, device=embeddings.device)
        mask = mask.float()
        neg_bias = ((1.0 - mask) * -10000.0)[:, None, :]
        x = embeddings.float() + self.position_embeddings[None, :L, :]
        x = self.LayerNorm_0(x)
        x = dropout(x, self.hidden_dropout_prob, rng)
        for layer in self.layers():
            x = layer(x, neg_bias, rng)
        sp = sp_axis(self.sequence_parallel)
        if sp is not None:
            check_sequence(L, sp)
            x = scatter_seq(x, sp)
            mask = mask.chunk(sp.size, dim=1)[sp.index]
        return dense(self.proj, self.pooler(x, mask), self.dtype)

    def sp_partial_parameters(self):
        """Under sp each rank's positions give part of the pooler's
        gradient."""
        return (list(self.pooler.parameters()) if self.sequence_parallel
                else [])
