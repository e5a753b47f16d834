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
The families: BERT (BertBase, BertLarge), Llama (Llama1, Llama2, Llama3:
rope theta 5e5), GLM (GLM, GLM4TH9B: grouped-query attention over 2 kv
heads, qkv biases, GLM's partial interleaved rotary) and OPT (OPTBase,
OPTLarge), each at the JAX package's defaults (JAX lm_ops.py:168-304); the
decoders compute in bf16 unless `lm_dtype` says otherwise. The lower slice
also takes the fused attention kernel (the JAX lower slice runs XLA's
attention: the same f32-softmax math at f32). The IISAN operators over
these families are in models/operators/iisan.py.
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
    act only in training. `max_position` and `lm_dtype` left None take
    the family's defaults."""

    inputer_class = ConcatInputer
    hf_family = ""
    num_layers_default = 12
    num_heads_default = 12
    max_position_default = 512
    lm_dtype_default = torch.float32

    def __init__(self, hidden_size: int = 64, input_dim: int = 768,
                 tune_from: Optional[int] = None, use_lora: bool = True,
                 lora_r: int = 32, lora_alpha: int = 16,
                 lora_dropout: float = 0.1, dropout: float = 0.1,
                 attn_dropout: Optional[float] = None,
                 additive_hidden_size: int = 256,
                 num_hidden_layers: Optional[int] = None,
                 num_attention_heads: Optional[int] = None,
                 max_position: Optional[int] = None,
                 lm_dtype: Optional[torch.dtype] = None,
                 pipeline_stages: int = 0, pipeline_microbatches: int = 0,
                 fused_attention: bool = False,
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
        self.lm_dtype = lm_dtype or self.lm_dtype_default
        self.tune_from = tune_from
        self.use_lora = use_lora
        self.lora = dict(lora_r=lora_r, lora_alpha=lora_alpha,
                         lora_dropout=lora_dropout)
        self.gelu_approximate = gelu_approximate
        self.fused_qkv = fused_qkv
        common = dict(max_position=max_position or self.max_position_default,
                      dropout=dropout,
                      attn_dropout=attn_dropout, fused_attention=fused_attention,
                      fused_qkv=fused_qkv, norm_bf16=norm_bf16,
                      gelu_approximate=gelu_approximate,
                      attention_pack=attention_pack)
        self.build(common, lora_fold=lora_fold,
                   pipeline_stages=pipeline_stages,
                   pipeline_microbatches=pipeline_microbatches,
                   dropout_reuse=dropout_reuse,
                   additive_hidden_size=additive_hidden_size)
        self.reset_parameters()

    def build(self, common: dict, lora_fold: bool, pipeline_stages: int,
              pipeline_microbatches: int, dropout_reuse: bool,
              additive_hidden_size: int):
        """The slices and the head (JAX `setup`); `common`: the slices'
        shared options. Only the trainable slice takes the pipeline knobs:
        the lower slice runs once over the catalog, serial (JAX
        lm_ops.py:120-135)."""
        start = self.resolved_tune_from
        self.lm = self.make_slice(
            start, self.num_hidden_layers - start, trainable=True,
            lora_fold=lora_fold, pipeline_stages=pipeline_stages,
            pipeline_microbatches=pipeline_microbatches,
            dropout_reuse=dropout_reuse, **common,
            **self._lora_kwargs(trainable=True))
        if start > 0:
            self.lm_lower = self.make_slice(
                0, start, trainable=False, **common,
                **self._lora_kwargs(trainable=False))
            self.lm_lower.requires_grad_(False)
        self.linear = nn.Linear(self.input_dim, self.hidden_size)
        self.pool = AdditiveAttention(self.hidden_size, additive_hidden_size,
                                      self.dtype)

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

    def make_slice(self, start: int, num_layers: int, trainable: bool,
                   **kw) -> nn.Module:
        """Layers [start, start + num_layers); `trainable`: the slice
        trained at run time (the whole LM in full-LM mode)."""
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

    def make_slice(self, start, num_layers, trainable, **kw):
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


_NOT_BERT = ("max_position", "attn_dropout", "gelu_approximate")


@OPERATORS.register
class LlamaOperator(LMOperator):
    """Llama decoders (JAX lm_ops.py:205-232): 32 layers of 32 heads, bf16,
    `num_kv_heads` (None: every head its own), `intermediate_size` (None:
    int(8 D / 3)), `rope_theta`, and GLM's geometry knobs `qkv_bias`,
    `rotary_fraction` and `rotary_interleaved`. The trainable slice ends
    with the final RMSNorm."""

    hf_family = "llama"
    num_layers_default = 32
    num_heads_default = 32
    lm_dtype_default = torch.bfloat16

    def __init__(self, num_kv_heads: Optional[int] = None,
                 intermediate_size: Optional[int] = None,
                 rope_theta: float = 10000.0, qkv_bias: bool = False,
                 rotary_fraction: float = 1.0,
                 rotary_interleaved: bool = False, **kw):
        # plain attributes, set before the slices are built
        self.num_kv_heads = num_kv_heads
        self.intermediate_size = intermediate_size
        self.rope_theta = rope_theta
        self.qkv_bias = qkv_bias
        self.rotary_fraction = rotary_fraction
        self.rotary_interleaved = rotary_interleaved
        super().__init__(**kw)

    def make_slice(self, start, num_layers, trainable, **kw):
        for k in _NOT_BERT + ("dropout", "dropout_reuse"):
            kw.pop(k, None)
        return LlamaDecoderSlice(
            num_layers, self.input_dim, num_heads=self.num_attention_heads,
            num_kv_heads=self.num_kv_heads,
            intermediate_size=self.intermediate_size, start=start,
            final_norm=trainable, rope_theta=self.rope_theta,
            qkv_bias=self.qkv_bias, rotary_fraction=self.rotary_fraction,
            rotary_interleaved=self.rotary_interleaved, dtype=self.lm_dtype,
            **kw)


@OPERATORS.register
class Llama1Operator(LlamaOperator):
    pass


@OPERATORS.register
class Llama2Operator(LlamaOperator):
    pass


@OPERATORS.register
class Llama3Operator(LlamaOperator):
    def __init__(self, rope_theta: float = 500000.0, **kw):
        super().__init__(rope_theta=rope_theta, **kw)


@OPERATORS.register
class GLMOperator(LlamaOperator):
    """ChatGLM2/3 and GLM-4 geometry (JAX lm_ops.py:283-304): 28 layers,
    2 kv heads, qkv biases, the partial interleaved rotary over the first
    half of each head, SwiGLU of 13,696."""

    hf_family = "glm"
    num_layers_default = 28

    def __init__(self, num_kv_heads: Optional[int] = 2,
                 intermediate_size: Optional[int] = 13696,
                 qkv_bias: bool = True, rotary_fraction: float = 0.5,
                 rotary_interleaved: bool = True, **kw):
        super().__init__(num_kv_heads=num_kv_heads,
                         intermediate_size=intermediate_size,
                         qkv_bias=qkv_bias, rotary_fraction=rotary_fraction,
                         rotary_interleaved=rotary_interleaved, **kw)


@OPERATORS.register
class GLM4TH9BOperator(GLMOperator):
    num_layers_default = 40


@OPERATORS.register
class OPTOperator(LMOperator):
    """OPT decoders (JAX lm_ops.py:250-281): 12 layers of 12 heads, bf16,
    `ffn_dim` (None: 4 D), learned positions up to `max_position` 2,048,
    the hidden dropout `dropout` (the kernel's attention takes none). The
    trainable slice ends with the final LayerNorm."""

    hf_family = "opt"
    max_position_default = 2048
    lm_dtype_default = torch.bfloat16

    def __init__(self, ffn_dim: Optional[int] = None, **kw):
        self.ffn_dim = ffn_dim
        super().__init__(**kw)

    def make_slice(self, start, num_layers, trainable, **kw):
        for k in _NOT_BERT[1:]:
            kw.pop(k)
        return OPTDecoderSlice(
            num_layers, self.input_dim, num_heads=self.num_attention_heads,
            ffn_dim=self.ffn_dim, start=start, embed_positions=start == 0,
            final_norm=trainable, dtype=self.lm_dtype, **kw)


@OPERATORS.register
class OPTBaseOperator(OPTOperator):
    pass


@OPERATORS.register
class OPTLargeOperator(OPTOperator):
    num_layers_default = 24
    num_heads_default = 16

