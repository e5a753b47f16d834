"""BERT encoder slice in eval mode.

The port of the BERT part of the JAX package's models/lm/layers.py:33-618:
LoRADense, FrozenableLayerNorm, attention packing (pack_group_size,
pack_items, packed_mask_bias), BertSelfAttention, BertLayer and
BertEncoderSlice, which applies BERT's embedding stage (position +
token-type embeddings + LayerNorm) to the inputer's word embeddings and
then its layers (full-LM mode: the JAX slice at start 0).

bf16 rounds where the JAX package rounds: a dense layer casts x and its
kernel (with the LoRA delta folded in f32) to `dtype` before the product
and adds the bias in `dtype`; a LayerNorm takes its statistics in f32 and
returns `dtype`; attention packs G = 128 // L items into one block-diagonal
call of `ops/attention.packed_attention` when `fused`.

Eval mode only: the dropout sites and SharedBitsDropout are training
pieces and are not ported. `fused_qkv`, `pipeline_stages`,
`collect_pooled` and the Llama/OPT/GLM slices raise NotImplementedError.
"""
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from legommenders_tpu_torch.models.common import cached_casts, lecun_normal_
from legommenders_tpu_torch.ops.attention import MAX_T, packed_attention

LM_KNOBS = "not ported yet (ROADMAP.md, queue 1, 'LM knobs')"


class LoRADense(nn.Module):
    """y = x @ (W + (B A) * alpha / r)^T + b, computed in `dtype`.

    Parameters: weight (F, D), bias (F,), and with lora_r > 0 lora_A
    (r, D) and lora_B (F, r): the JAX kernel (D, F), lora_A (D, r) and
    lora_B (r, F) transposed. With `lora_fold` the delta is added to W in
    f32 before the cast; otherwise it is a second, low-rank product
    (x A^T) B^T in `dtype`, as in JAX."""

    def __init__(self, in_features: int, features: int, lora_r: int = 0,
                 lora_alpha: int = 16, lora_dropout: float = 0.0,
                 lora_fold: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.lora_r = lora_r
        self.lora_alpha = lora_alpha
        self.fold = lora_fold and lora_r > 0
        if self.fold and lora_dropout != 0.0:
            raise ValueError("lora_fold requires lora_dropout == 0")
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features))
        if lora_r > 0:
            self.lora_A = nn.Parameter(torch.empty(lora_r, in_features))
            self.lora_B = nn.Parameter(torch.zeros(features, lora_r))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        lecun_normal_(self.weight, self.weight.shape[1], generator)
        with torch.no_grad():
            self.bias.zero_()
            if self.lora_r > 0:
                self.lora_A.normal_(0.0, 0.02, generator=generator)
                self.lora_B.zero_()

    def weights(self):
        """(kernel (F, D), bias) in `dtype`, the LoRA delta folded in."""
        def make():
            w = self.weight
            if self.fold:
                w = w + (self.lora_B @ self.lora_A) * (
                    self.lora_alpha / self.lora_r)
            return w.to(self.dtype), self.bias.to(self.dtype)
        return cached_casts(self, list(self.parameters()), make)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weights()
        xd = x.to(self.dtype)
        y = xd @ w.t() + b
        if self.lora_r > 0 and not self.fold:
            a, bb = self.lora_A.to(self.dtype), self.lora_B.to(self.dtype)
            y = y + ((xd @ a.t()) @ bb.t()) * (self.lora_alpha / self.lora_r)
        return y


class FrozenableLayerNorm(nn.Module):
    """LayerNorm with f32 statistics. Parameters `weight` and `bias` (the
    JAX `scale` and `bias`). By default the normalisation runs in f32 and
    the result is cast to `dtype`; with `bf16_apply` (and a `dtype` other
    than f32) only the statistics are f32 and the rest runs in `dtype`."""

    def __init__(self, dim: int, epsilon: float = 1e-12,
                 bf16_apply: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.epsilon = epsilon
        self.bf16_apply = bf16_apply
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bf16_apply and self.dtype != torch.float32:
            var, mean = torch.var_mean(x.float(), dim=-1, keepdim=True,
                                       correction=0)
            inv = torch.rsqrt(var + self.epsilon).to(self.dtype)
            y = (x.to(self.dtype) - mean.to(self.dtype)) * inv
            return y * self.weight.to(self.dtype) + self.bias.to(self.dtype)
        # f32 in and out: torch's CUDA layer_norm refuses a bf16 x with f32
        # weights
        return F.layer_norm(x.float(), x.shape[-1:], self.weight, self.bias,
                            self.epsilon).to(self.dtype)


def pack_group_size(L: int, requested: int) -> int:
    """The attention-pack group size: `requested` < 0 = auto (as many
    L-token items as fit 128 tokens), 0/1 = off."""
    if requested < 0:
        return max(1, 128 // max(L, 1))
    return max(1, requested)


def pack_items(x: torch.Tensor, mask: torch.Tensor, group: int):
    """(B, L, D) -> (ceil(B/G), G*L, D): G items share one attention call.
    Pad items get one valid token, so no softmax row is fully masked.
    Returns (x, mask, number of pad items)."""
    B, L = mask.shape
    pad = (-B) % group
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        pad_mask = mask.new_zeros((pad, L))
        pad_mask[:, 0] = 1
        mask = torch.cat([mask, pad_mask])
    Bp = x.shape[0] // group
    return (x.reshape(Bp, group * L, x.shape[-1]),
            mask.reshape(Bp, group * L), pad)


def packed_mask_bias(mask_p: torch.Tensor, L: int,
                     dtype: torch.dtype) -> torch.Tensor:
    """Block-diagonal attention bias (Bp, 1, G*L, G*L) in `dtype`: token i
    may attend j only within the same L-token block and j valid;
    disallowed pairs get `finfo(dtype).min`. (The JAX package's `causal`
    form serves the decoder slices, which are not ported.)"""
    blk = torch.arange(mask_p.shape[1], device=mask_p.device) // L
    same = blk[:, None] == blk[None, :]
    allowed = same[None, None] & mask_p.bool()[:, None, None, :]
    zero = torch.zeros((), dtype=dtype, device=mask_p.device)
    neg = torch.full((), torch.finfo(dtype).min, dtype=dtype,
                     device=mask_p.device)
    return torch.where(allowed, zero, neg)


class BertSelfAttention(nn.Module):
    """q/k/v projections (LoRA on query and value), the attention core and
    the output projection. `fused` sends the core to `packed_attention`
    (T <= 128); otherwise scores, softmax and the product run in `dtype`
    as plain tensor code, as the JAX package leaves them to XLA."""

    def __init__(self, dim: int, num_heads: int, lora_r: int = 0,
                 lora_alpha: int = 16, lora_dropout: float = 0.0,
                 fused: bool = False, fused_qkv: bool = False,
                 lora_fold: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        if fused_qkv:
            raise NotImplementedError(f"fused_qkv is {LM_KNOBS}")
        self.num_heads = num_heads
        self.fused = fused
        self.dtype = dtype
        lora = dict(lora_r=lora_r, lora_alpha=lora_alpha,
                    lora_dropout=lora_dropout, lora_fold=lora_fold,
                    dtype=dtype)
        self.query = LoRADense(dim, dim, **lora)
        self.key = LoRADense(dim, dim, dtype=dtype)
        self.value = LoRADense(dim, dim, **lora)
        self.output = LoRADense(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor):
        """x (B, L, D); mask_bias (B, 1, 1|L, L) additive, in `dtype`."""
        B, L, D = x.shape
        H = self.num_heads
        d = D // H
        q, k, v = self.query(x), self.key(x), self.value(x)
        if self.fused and L <= MAX_T:
            bias3 = mask_bias[:, 0].expand(B, L, L)
            out = packed_attention(H, 0.0, q, k, v, bias3)
        else:
            q, k, v = (t.reshape(B, L, H, d) for t in (q, k, v))
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.sqrt(
                torch.tensor(d, dtype=self.dtype))
            attn = torch.softmax(scores + mask_bias, dim=-1)
            out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, L, D)
        return self.output(out)


class BertLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, lora_r: int = 0,
                 lora_alpha: int = 16, lora_dropout: float = 0.0,
                 gelu_approximate: bool = False,
                 fused_attention: bool = False, fused_qkv: bool = False,
                 lora_fold: bool = False, norm_bf16: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.gelu = "tanh" if gelu_approximate else "none"
        self.attention = BertSelfAttention(
            dim, num_heads, lora_r, lora_alpha, lora_dropout,
            fused=fused_attention, fused_qkv=fused_qkv, lora_fold=lora_fold,
            dtype=dtype)
        norm = dict(epsilon=1e-12, bf16_apply=norm_bf16, dtype=dtype)
        self.attention_norm = FrozenableLayerNorm(dim, **norm)
        self.intermediate = LoRADense(dim, 4 * dim, dtype=dtype)
        self.ffn_output = LoRADense(4 * dim, dim, dtype=dtype)
        self.output_norm = FrozenableLayerNorm(dim, **norm)

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor):
        x = self.attention_norm(x + self.attention(x, mask_bias))
        inter = F.gelu(self.intermediate(x), approximate=self.gelu)
        return self.output_norm(x + self.ffn_output(inter))


class BertEncoderSlice(nn.Module):
    """A BERT encoder over the inputer's word embeddings (B, L, dim) with
    mask (B, L): the embedding stage, then layers 0 .. num_layers-1 (the
    JAX slice at start 0 with `embed`). Parameters, under the JAX names:
    `position_embeddings` (max_position, dim), `token_type_embeddings`
    (1, dim), `embeddings_norm` and `layer_{i}`."""

    def __init__(self, num_layers: int, dim: int, num_heads: int = 12,
                 max_position: int = 512, lora_r: int = 0, lora_alpha: int = 16,
                 lora_dropout: float = 0.0, gelu_approximate: bool = False,
                 attention_pack: int = 0, fused_attention: bool = False,
                 fused_qkv: bool = False, lora_fold: bool = False,
                 norm_bf16: bool = False, pipeline_stages: int = 0,
                 collect_pooled: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if pipeline_stages > 1:
            raise NotImplementedError(f"pipeline_stages is {LM_KNOBS}")
        if collect_pooled:
            raise NotImplementedError(f"collect_pooled (IISAN) is {LM_KNOBS}")
        self.num_layers = num_layers
        self.attention_pack = attention_pack
        self.dtype = dtype
        self.position_embeddings = nn.Parameter(torch.empty(max_position, dim))
        self.token_type_embeddings = nn.Parameter(torch.empty(1, dim))
        self.embeddings_norm = FrozenableLayerNorm(
            dim, epsilon=1e-12, bf16_apply=norm_bf16, dtype=dtype)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", BertLayer(
                dim, num_heads, lora_r, lora_alpha, lora_dropout,
                gelu_approximate=gelu_approximate,
                fused_attention=fused_attention, fused_qkv=fused_qkv,
                lora_fold=lora_fold, norm_bf16=norm_bf16, dtype=dtype))
        self.reset_parameters()

    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.num_layers)]

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.position_embeddings.normal_(0.0, 0.02, generator=generator)
            self.token_type_embeddings.normal_(0.0, 0.02, generator=generator)
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, hidden_states: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        B, L, D = hidden_states.shape
        neg = torch.finfo(self.dtype).min
        mask_bias = ((1.0 - mask.to(self.dtype)) * neg)[:, None, None, :]
        # f32 tables: x + extra is f32, as in JAX, until the norm
        extra = (self.position_embeddings[None, :L]
                 + self.token_type_embeddings[None])
        x = hidden_states.to(self.dtype) + extra
        x = self.embeddings_norm(x)
        G = (pack_group_size(L, self.attention_pack)
             if self.attention_pack else 1)
        if G > 1:
            x, mask_p, _ = pack_items(x, mask, G)
            mask_bias = packed_mask_bias(mask_p, L, self.dtype)
        for layer in self.layers():
            x = layer(x, mask_bias)
        if G > 1:
            x = x.reshape(-1, L, D)[:B]
        return x


class LlamaDecoderSlice(nn.Module):
    """Llama / GLM decoder slice (JAX models/lm/layers.py:798)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"the Llama/GLM decoder slice is {LM_KNOBS}")


class OPTDecoderSlice(nn.Module):
    """OPT decoder slice (JAX models/lm/layers.py:972)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"the OPT decoder slice is {LM_KNOBS}")
