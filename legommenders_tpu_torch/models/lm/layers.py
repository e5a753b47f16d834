"""BERT encoder slices, for serving and for training.

The port of the BERT part of the JAX package's models/lm/layers.py:33-618:
LoRADense, FrozenableLayerNorm, SharedBitsDropout, attention packing
(pack_group_size, pack_items, packed_mask_bias), BertSelfAttention,
BertLayer and BertEncoderSlice, which runs layers [start, start +
num_layers) over hidden states; at start 0 with `embed` it first applies
BERT's embedding stage (position + token-type embeddings + LayerNorm +
dropout) to the inputer's word embeddings.

bf16 rounds where the JAX package rounds: a dense layer casts x and its
kernel (with the LoRA delta folded in f32) to `dtype` before the product
and adds the bias in `dtype`; a LayerNorm takes its statistics in f32 and
returns `dtype`; attention packs G = 128 // L items into one block-diagonal
call of `ops/attention.packed_attention` when `fused`.

Training. `freeze_base` freezes the base weights (requires_grad False,
where JAX applies stop_gradient); the LoRA factors stay trainable, their
gradient flowing through the fold. Every dropout site (hidden, attention
probabilities, LoRA input, embedding stage) and the attention kernel's
seed draw from the explicit generator `rng` handed to `forward`; `rng=None`
is eval mode. `fused_qkv`, `pipeline_stages`, `collect_pooled` and the
Llama/OPT/GLM slices raise NotImplementedError.
"""
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from legommenders_tpu_torch.models.common import (  # noqa: F401
    FrozenableLayerNorm, cached_casts, dropout, lecun_normal_,
)
from legommenders_tpu_torch.ops.attention import MAX_T, packed_attention

LM_KNOBS = "not ported yet (ROADMAP.md, queue 1, 'LM knobs')"


class LoRADense(nn.Module):
    """y = x @ (W + (B A) * alpha / r)^T + b, computed in `dtype`.

    Parameters: weight (F, D), bias (F,), and with lora_r > 0 lora_A
    (r, D) and lora_B (F, r): the JAX kernel (D, F), lora_A (D, r) and
    lora_B (r, F) transposed. With `lora_fold` the delta is added to W in
    f32 before the cast; otherwise it is a second, low-rank product
    (dropout(x) A^T) B^T in `dtype`, as in JAX. `freeze_base` freezes W and
    b."""

    def __init__(self, in_features: int, features: int, lora_r: int = 0,
                 lora_alpha: int = 16, lora_dropout: float = 0.0,
                 lora_fold: bool = False, freeze_base: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.lora_r = lora_r
        self.lora_alpha = lora_alpha
        self.lora_dropout = lora_dropout
        self.fold = lora_fold and lora_r > 0
        if self.fold and lora_dropout != 0.0:
            raise ValueError("lora_fold requires lora_dropout == 0")
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features),
                                   requires_grad=not freeze_base)
        self.bias = nn.Parameter(torch.zeros(features),
                                 requires_grad=not freeze_base)
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

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        w, b = self.weights()
        y = x.to(self.dtype) @ w.t() + b
        if self.lora_r > 0 and not self.fold:
            h = dropout(x, self.lora_dropout, rng).to(self.dtype)
            a, bb = self.lora_A.to(self.dtype), self.lora_B.to(self.dtype)
            y = y + ((h @ a.t()) @ bb.t()) * (self.lora_alpha / self.lora_r)
        return y


class SharedBitsDropout:
    """One int32 draw of random bits feeds several dropout sites (JAX
    models/lm/layers.py:135-166): site k keeps an element iff byte k of its
    bits is below t = round((1 - rate) * 256), and scales kept elements by
    256 / t (rounded to the input's dtype), so the expectation stays
    exact. No parameters."""

    def __init__(self, rate: float, num_sites: int = 2):
        self.rate = rate
        self.num_sites = num_sites

    def __call__(self, x: torch.Tensor, site: int,
                 bits: Optional[torch.Tensor],
                 rng: Optional[torch.Generator]):
        """(dropped x, bits): the bits are drawn on the first site that
        needs them and handed to the next."""
        if rng is None or self.rate <= 0.0:
            return x, bits
        if not 0 <= site < min(self.num_sites, 4):
            raise ValueError(f"SharedBitsDropout: site {site} out of range")
        t = max(1, min(256, round((1.0 - self.rate) * 256)))
        if bits is None:
            bits = torch.randint(-2 ** 31, 2 ** 31, x.shape, dtype=torch.int32,
                                 generator=rng, device=x.device)
        keep = ((bits >> (8 * site)) & 0xFF) < t
        scale = torch.tensor(256.0 / t, dtype=x.dtype, device=x.device)
        return torch.where(keep, x * scale,
                           torch.zeros((), dtype=x.dtype,
                                       device=x.device)), bits


def attention_seed(rng: torch.Generator, device) -> torch.Tensor:
    """The (1,) int32 seed of one packed_attention call, drawn from rng on
    the device (no host round trip)."""
    return torch.randint(-2 ** 31, 2 ** 31, (1,), dtype=torch.int32,
                         generator=rng, device=device)


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
    (T <= 128), with the attention dropout `dropout` in the kernel and its
    seed drawn from rng (JAX `_fused_attention`, layers.py:330-349);
    otherwise scores, softmax, dropout and the product run in `dtype` as
    plain tensor code, as the JAX package leaves them to XLA."""

    def __init__(self, dim: int, num_heads: int, lora_r: int = 0,
                 lora_alpha: int = 16, lora_dropout: float = 0.0,
                 freeze_base: bool = False, dropout: float = 0.1,
                 fused: bool = False, fused_qkv: bool = False,
                 lora_fold: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        if fused_qkv:
            raise NotImplementedError(f"fused_qkv is {LM_KNOBS}")
        self.num_heads = num_heads
        self.dropout = dropout
        self.fused = fused
        self.dtype = dtype
        lora = dict(lora_r=lora_r, lora_alpha=lora_alpha,
                    lora_dropout=lora_dropout, lora_fold=lora_fold,
                    freeze_base=freeze_base, dtype=dtype)
        frozen = dict(freeze_base=freeze_base, dtype=dtype)
        self.query = LoRADense(dim, dim, **lora)
        self.key = LoRADense(dim, dim, **frozen)
        self.value = LoRADense(dim, dim, **lora)
        self.output = LoRADense(dim, dim, **frozen)

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor,
                rng: Optional[torch.Generator] = None):
        """x (B, L, D); mask_bias (B, 1, 1|L, L) additive, in `dtype`."""
        B, L, D = x.shape
        H = self.num_heads
        d = D // H
        q, k, v = self.query(x, rng), self.key(x), self.value(x, rng)
        if self.fused and L <= MAX_T:
            bias3 = mask_bias[:, 0].expand(B, L, L)
            p = self.dropout if rng is not None else 0.0
            seed = attention_seed(rng, x.device) if p > 0.0 else None
            out = packed_attention(H, p, q, k, v, bias3, seed)
        else:
            q, k, v = (t.reshape(B, L, H, d) for t in (q, k, v))
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.sqrt(
                torch.tensor(d, dtype=self.dtype))
            attn = torch.softmax(scores + mask_bias, dim=-1)
            attn = dropout(attn, self.dropout, rng)
            out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, L, D)
        return self.output(out)


class BertLayer(nn.Module):
    """Attention, residual + LayerNorm, FFN, residual + LayerNorm, with the
    hidden dropout `dropout` after the attention and after the FFN (one
    SharedBitsDropout draw for both with `dropout_reuse`) and the attention
    dropout `attn_dropout` (None: `dropout`)."""

    def __init__(self, dim: int, num_heads: int, lora_r: int = 0,
                 lora_alpha: int = 16, lora_dropout: float = 0.0,
                 freeze_base: bool = False, dropout: float = 0.1,
                 attn_dropout: Optional[float] = None,
                 gelu_approximate: bool = False,
                 fused_attention: bool = False, fused_qkv: bool = False,
                 lora_fold: bool = False, norm_bf16: bool = False,
                 dropout_reuse: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.gelu = "tanh" if gelu_approximate else "none"
        self.dropout = dropout
        self.shared = SharedBitsDropout(dropout) if dropout_reuse else None
        self.attention = BertSelfAttention(
            dim, num_heads, lora_r, lora_alpha, lora_dropout, freeze_base,
            dropout if attn_dropout is None else attn_dropout,
            fused=fused_attention, fused_qkv=fused_qkv, lora_fold=lora_fold,
            dtype=dtype)
        norm = dict(epsilon=1e-12, bf16_apply=norm_bf16, freeze=freeze_base,
                    dtype=dtype)
        frozen = dict(freeze_base=freeze_base, dtype=dtype)
        self.attention_norm = FrozenableLayerNorm(dim, **norm)
        self.intermediate = LoRADense(dim, 4 * dim, **frozen)
        self.ffn_output = LoRADense(4 * dim, dim, **frozen)
        self.output_norm = FrozenableLayerNorm(dim, **norm)

    def _drop(self, x, site, bits, rng):
        if self.shared is not None:
            return self.shared(x, site, bits, rng)
        return dropout(x, self.dropout, rng), bits

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor,
                rng: Optional[torch.Generator] = None):
        attn, bits = self._drop(self.attention(x, mask_bias, rng), 0, None,
                                rng)
        x = self.attention_norm(x + attn)
        inter = F.gelu(self.intermediate(x), approximate=self.gelu)
        out, _ = self._drop(self.ffn_output(inter), 1, bits, rng)
        return self.output_norm(x + out)


class BertEncoderSlice(nn.Module):
    """Layers [start, start + num_layers) of a BERT encoder over hidden
    states (B, L, dim) with mask (B, L). With start 0 and `embed` the
    embedding stage runs first, over the inputer's word embeddings.
    Parameters, under the JAX names: `position_embeddings` (max_position,
    dim), `token_type_embeddings` (1, dim) and `embeddings_norm` (embedding
    stage only) and `layer_{start + i}`."""

    def __init__(self, num_layers: int, dim: int, num_heads: int = 12,
                 start: int = 0, embed: bool = True,
                 max_position: int = 512, lora_r: int = 0, lora_alpha: int = 16,
                 lora_dropout: float = 0.0, freeze_base: bool = False,
                 dropout: float = 0.1, attn_dropout: Optional[float] = None,
                 gelu_approximate: bool = False,
                 attention_pack: int = 0, fused_attention: bool = False,
                 fused_qkv: bool = False, lora_fold: bool = False,
                 norm_bf16: bool = False, dropout_reuse: bool = False,
                 pipeline_stages: int = 0, collect_pooled: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if pipeline_stages > 1:
            raise NotImplementedError(f"pipeline_stages is {LM_KNOBS}")
        if collect_pooled:
            raise NotImplementedError(f"collect_pooled (IISAN) is {LM_KNOBS}")
        self.num_layers = num_layers
        self.start = start
        self.embed = embed and start == 0
        self.dropout = dropout
        self.attention_pack = attention_pack
        self.dtype = dtype
        if self.embed:
            self.position_embeddings = nn.Parameter(
                torch.empty(max_position, dim), requires_grad=not freeze_base)
            self.token_type_embeddings = nn.Parameter(
                torch.empty(1, dim), requires_grad=not freeze_base)
            self.embeddings_norm = FrozenableLayerNorm(
                dim, epsilon=1e-12, bf16_apply=norm_bf16, freeze=freeze_base,
                dtype=dtype)
        for i in range(start, start + num_layers):
            self.add_module(f"layer_{i}", BertLayer(
                dim, num_heads, lora_r, lora_alpha, lora_dropout, freeze_base,
                dropout, attn_dropout, gelu_approximate=gelu_approximate,
                fused_attention=fused_attention, fused_qkv=fused_qkv,
                lora_fold=lora_fold, norm_bf16=norm_bf16,
                dropout_reuse=dropout_reuse, dtype=dtype))
        self.reset_parameters()

    def layers(self):
        return [getattr(self, f"layer_{i}")
                for i in range(self.start, self.start + self.num_layers)]

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        if self.embed:
            with torch.no_grad():
                self.position_embeddings.normal_(0.0, 0.02,
                                                 generator=generator)
                self.token_type_embeddings.normal_(0.0, 0.02,
                                                   generator=generator)
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, hidden_states: torch.Tensor, mask: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        B, L, D = hidden_states.shape
        neg = torch.finfo(self.dtype).min
        mask_bias = ((1.0 - mask.to(self.dtype)) * neg)[:, None, None, :]
        x = hidden_states.to(self.dtype)
        if self.embed:
            # f32 tables: x + extra is f32, as in JAX, until the norm
            extra = (self.position_embeddings[None, :L]
                     + self.token_type_embeddings[None])
            x = self.embeddings_norm(x + extra)
            x = dropout(x, self.dropout, rng)
        G = (pack_group_size(L, self.attention_pack)
             if self.attention_pack else 1)
        if G > 1:
            x, mask_p, _ = pack_items(x, mask, G)
            mask_bias = packed_mask_bias(mask_p, L, self.dtype)
        for layer in self.layers():
            x = layer(x, mask_bias, rng)
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
