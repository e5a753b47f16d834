"""LM content-encoder operators (ONCE family).

The port of the JAX package's models/operators/lm_ops.py:40-200 (reference
model/operators/once_operator.py:41-236 and bert_operator.py):
  * full-LM mode (`tune_from` unset): the inputer supplies word embeddings
    (the LM's own word-embedding table is dropped) and the whole encoder
    slice `lm` runs over them;
  * layer-split mode (`tune_from = k`): the frozen lower slice `lm_lower`
    (layers 0..k-1, embedding stage included) runs once over every item
    (`encode_lower`, runtime/lm_cache.py) and the upper slice `lm` (layers
    k..N-1) runs at train time over the cached hidden states, which the
    item contents carry under LM_HIDDEN_KEY / LM_MASK_KEY;
  * with `use_lora` the trainable slice's query/value projections carry a
    LoRA delta and its base weights are frozen;
  * head: Linear(input_dim -> hidden) + the AdditiveAttention pool.
The lower slice also takes the fused attention kernel (the JAX lower slice
runs XLA's attention: the same f32-softmax math at f32). The Llama/OPT/GLM
families are not ported yet; asking for them raises.
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

LM_HIDDEN_KEY = "__lm_hidden__"
LM_MASK_KEY = "__lm_mask__"


class LMOperator(BaseOperator):
    """Abstract LM content encoder. The encoder slice is the submodule `lm`,
    the head `linear` and `pool`, as in the JAX parameter tree.

    `gelu_approximate` (tanh gelu instead of the exact erf) and
    `attention_pack` (items per attention call, -1 auto: 128 // L) are the
    BERT slice's. `dropout` (hidden), `attn_dropout` (attention
    probabilities; None: `dropout`), `lora_dropout` and `dropout_reuse`
    act only in training."""

    inputer_class = ConcatInputer
    hf_family = ""
    num_layers_default = 12
    num_heads_default = 12

    def __init__(self, hidden_size: int = 64, input_dim: int = 768,
                 tune_from: Optional[int] = None, use_lora: bool = True,
                 lora_r: int = 32, lora_alpha: int = 16,
                 lora_dropout: float = 0.1, dropout: float = 0.1,
                 attn_dropout: Optional[float] = None,
                 additive_hidden_size: int = 256,
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
        self.tune_from = tune_from
        self.use_lora = use_lora
        self.lora = dict(lora_r=lora_r, lora_alpha=lora_alpha,
                         lora_dropout=lora_dropout)
        self.gelu_approximate = gelu_approximate
        self.fused_qkv = fused_qkv
        common = dict(max_position=max_position, dropout=dropout,
                      attn_dropout=attn_dropout, fused_attention=fused_attention,
                      fused_qkv=fused_qkv, norm_bf16=norm_bf16,
                      gelu_approximate=gelu_approximate,
                      attention_pack=attention_pack)
        start = self.resolved_tune_from
        self.lm = self.make_slice(
            start, self.num_hidden_layers - start, lora_fold=lora_fold,
            pipeline_stages=pipeline_stages, dropout_reuse=dropout_reuse,
            **common, **self._lora_kwargs(trainable=True))
        if start > 0:
            self.lm_lower = self.make_slice(
                0, start, **common, **self._lora_kwargs(trainable=False))
            self.lm_lower.requires_grad_(False)
        self.linear = nn.Linear(input_dim, hidden_size)
        self.pool = AdditiveAttention(hidden_size, additive_hidden_size,
                                      dtype)
        self.reset_parameters()

    @property
    def use_lm_cache(self) -> bool:
        return bool(self.tune_from)

    @property
    def resolved_tune_from(self) -> int:
        if self.tune_from is None:
            return 0
        t = int(self.tune_from)
        return t if t >= 0 else self.num_hidden_layers + t

    @property
    def transformer_key(self) -> str:
        """The operator's name in cache paths (JAX lm_ops.py:99-101)."""
        return self.__class__.__name__.replace("Operator", "").lower()

    def _lora_kwargs(self, trainable: bool) -> dict:
        if self.use_lora and trainable:
            return dict(**self.lora, freeze_base=True)
        return dict(lora_r=0, freeze_base=False)

    def make_slice(self, start: int, num_layers: int, **kw) -> nn.Module:
        raise NotImplementedError

    def reset_parameters(self, generator=None):
        self.lm.reset_parameters(generator)
        if self.resolved_tune_from > 0:
            self.lm_lower.reset_parameters(generator)
        reset_linear(self.linear, generator)
        self.pool.reset_parameters(generator)

    def forward(self, embeddings: torch.Tensor, mask: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """embeddings (B, L, input_dim): the inputer's word embeddings
        (full-LM mode) or the cached lower-slice hidden states (layer-split
        mode); mask (B, L); `rng` the dropout generator (None: eval)."""
        x = self.lm(embeddings, mask, rng).float()
        x = F.linear(x.to(self.dtype), self.linear.weight.to(self.dtype),
                     self.linear.bias.to(self.dtype))
        return self.pool(x, mask)

    def encode_lower(self, embeddings: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
        """Layers 0..tune_from-1 over the inputer's embeddings, at dropout
        0 (the offline split of the cache build)."""
        if self.resolved_tune_from <= 0:
            raise ValueError("encode_lower requires tune_from")
        return self.lm_lower(embeddings, mask)

    def get_pretrained_parameter_names(self):
        """The dual-LR signal (JAX lm_ops.py:164-166; reference
        once_operator.py:153-154): parameters under `lm` train at
        item_lr."""
        return ["lm"]


@OPERATORS.register
class BertOperator(LMOperator):
    hf_family = "bert"

    def make_slice(self, start, num_layers, **kw):
        return BertEncoderSlice(
            num_layers, self.input_dim, num_heads=self.num_attention_heads,
            start=start, embed=start == 0, dtype=self.lm_dtype, **kw)


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

    def make_slice(self, start, num_layers, **kw):
        return LlamaDecoderSlice()


@OPERATORS.register
class GLMOperator(LlamaOperator):
    hf_family = "glm"


@OPERATORS.register
class OPTOperator(LMOperator):
    hf_family = "opt"

    def make_slice(self, start, num_layers, **kw):
        return OPTDecoderSlice()
