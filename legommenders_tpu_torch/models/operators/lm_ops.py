"""LM content-encoder operators (ONCE family), full-LM mode.

The port of the JAX package's models/operators/lm_ops.py:40-200 (reference
model/operators/once_operator.py:41-236 and bert_operator.py): the inputer
supplies word embeddings (the LM's own word-embedding table is dropped),
the whole encoder slice runs over them, then Linear(input_dim -> hidden)
and the AdditiveAttention pool. With `use_lora` the query/value
projections carry a LoRA delta.

Layer-split mode (`tune_from`), the training-only knobs and the
Llama/OPT/GLM families are not ported yet; asking for them raises.
"""
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from legommenders_tpu_torch.models.common import AdditiveAttention, reset_linear
from legommenders_tpu_torch.models.inputers.concat import ConcatInputer
from legommenders_tpu_torch.models.lm.layers import (
    BertEncoderSlice, LlamaDecoderSlice, OPTDecoderSlice,
)
from legommenders_tpu_torch.models.operators.base import BaseOperator
from legommenders_tpu_torch.utils.registry import OPERATORS


class LMOperator(BaseOperator):
    """Abstract LM content encoder. The encoder slice is the submodule `lm`,
    the head `linear` and `pool`, as in the JAX parameter tree.

    `gelu_approximate` (tanh gelu instead of the exact erf) and
    `attention_pack` (items per attention call, -1 auto: 128 // L) are the
    BERT slice's. `lora_dropout` and `dropout_reuse` act only in training
    and are checked as in JAX; the other dropout knobs are not taken."""

    inputer_class = ConcatInputer
    hf_family = ""
    num_layers_default = 12
    num_heads_default = 12

    def __init__(self, hidden_size: int = 64, input_dim: int = 768,
                 tune_from: Optional[int] = None, use_lora: bool = True,
                 lora_r: int = 32, lora_alpha: int = 16,
                 lora_dropout: float = 0.1, additive_hidden_size: int = 256,
                 num_hidden_layers: Optional[int] = None,
                 num_attention_heads: Optional[int] = None,
                 max_position: int = 512,
                 lm_dtype: torch.dtype = torch.float32,
                 pipeline_stages: int = 0, fused_attention: bool = False,
                 fused_qkv: bool = False, lora_fold: bool = False,
                 norm_bf16: bool = False, dropout_reuse: bool = False,
                 gelu_approximate: bool = False, attention_pack: int = -1,
                 dtype: torch.dtype = torch.float32):
        super().__init__(hidden_size, input_dim, dtype)
        if tune_from:
            raise NotImplementedError(
                "layer-split mode (tune_from) is not ported yet (ROADMAP.md, "
                "queue 1, slice 3: LM training)")
        if lora_fold and use_lora and lora_dropout != 0.0:
            raise ValueError("lora_fold requires lora_dropout: 0 in "
                             "item_config")
        if dropout_reuse and self.hf_family in ("llama", "glm"):
            raise ValueError(
                "dropout_reuse applies to BERT/OPT slices only — the "
                "Llama/GLM decoder has no hidden-dropout sites to share")
        self.num_hidden_layers = num_hidden_layers or self.num_layers_default
        self.num_attention_heads = (num_attention_heads
                                    or self.num_heads_default)
        self.lm_dtype = lm_dtype
        lora = (dict(lora_r=lora_r, lora_alpha=lora_alpha,
                     lora_dropout=lora_dropout) if use_lora
                else dict(lora_r=0))
        self.lm = self.make_slice(
            max_position=max_position, fused_attention=fused_attention,
            fused_qkv=fused_qkv, lora_fold=lora_fold, norm_bf16=norm_bf16,
            pipeline_stages=pipeline_stages,
            gelu_approximate=gelu_approximate, attention_pack=attention_pack,
            **lora)
        self.linear = nn.Linear(input_dim, hidden_size)
        self.pool = AdditiveAttention(hidden_size, additive_hidden_size,
                                      dtype)
        self.reset_parameters()

    def make_slice(self, **kw) -> nn.Module:
        raise NotImplementedError

    def reset_parameters(self, generator=None):
        self.lm.reset_parameters(generator)
        reset_linear(self.linear, generator)
        self.pool.reset_parameters(generator)

    def forward(self, embeddings: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        """embeddings (B, L, input_dim) from the inputer, mask (B, L)."""
        x = self.lm(embeddings, mask).float()
        x = F.linear(x.to(self.dtype), self.linear.weight.to(self.dtype),
                     self.linear.bias.to(self.dtype))
        return self.pool(x, mask)


@OPERATORS.register
class BertOperator(LMOperator):
    hf_family = "bert"

    def make_slice(self, **kw):
        return BertEncoderSlice(
            self.num_hidden_layers, self.input_dim,
            num_heads=self.num_attention_heads, dtype=self.lm_dtype, **kw)


@OPERATORS.register
class BertBaseOperator(BertOperator):
    pass


@OPERATORS.register
class BertLargeOperator(BertOperator):
    num_layers_default = 24
    num_heads_default = 16


@OPERATORS.register
class LlamaOperator(LMOperator):
    hf_family = "llama"

    def make_slice(self, **kw):
        return LlamaDecoderSlice()


@OPERATORS.register
class GLMOperator(LlamaOperator):
    hf_family = "glm"


@OPERATORS.register
class OPTOperator(LMOperator):
    hf_family = "opt"

    def make_slice(self, **kw):
        return OPTDecoderSlice()
