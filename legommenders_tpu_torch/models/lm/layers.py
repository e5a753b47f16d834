"""The LM slices, for serving and for training: BERT's encoder and the
Llama / GLM and OPT decoders.

The port of the JAX package's models/lm/layers.py:33-1067: LoRADense,
FrozenableLayerNorm, SharedBitsDropout, attention packing
(pack_group_size, pack_items, packed_mask_bias), BertSelfAttention,
BertLayer and BertEncoderSlice; RMSNorm, the rotary tables (the full
half-split form and GLM's partial interleaved form), LlamaDecoderLayer and
LlamaDecoderSlice; OPTDecoderLayer and OPTDecoderSlice. A slice runs
layers [start, start + num_layers) over hidden states. BERT's, at start 0
with `embed`, first applies the embedding stage (position + token-type
embeddings + LayerNorm + dropout) to the inputer's word embeddings; OPT's,
at start 0 with `embed_positions`, adds its learned positions (offset 2,
following the count of valid tokens). The decoders are causal; the
trainable slice ends with `final_norm`.

bf16 rounds where the JAX package rounds: a dense layer casts x and its
kernel (with the LoRA delta folded in f32) to `dtype` before the product
and adds the bias in `dtype`; a LayerNorm takes its statistics in f32 and
returns `dtype`; an RMSNorm takes them in f32 and, without `bf16_apply`,
returns the normalised x rounded to `dtype` times its f32 weight, which
is f32 (jnp's promotion), as JAX does; the rotary tables are computed in
f32 and rounded to `dtype`. Attention packs G = 128 // L items into one
block-diagonal (causal for the decoders) call of
`ops/attention.packed_attention` when `fused` and the packed length is at
most 128; the decoders pass it dropout 0, and a grouped-query k and v are
repeated per head (`repeat_interleave`, JAX's `jnp.repeat`) before it.

Training. `freeze_base` freezes the base weights (requires_grad False,
where JAX applies stop_gradient); the LoRA factors (q and v) stay
trainable, their gradient flowing through the fold. Every dropout site
(hidden, attention probabilities, LoRA input, embedding stage) and the
attention kernel's seed draw from the explicit generator `rng` handed to
`forward`; `rng=None` is eval mode.

Pipeline parallelism (JAX `_pipelined_stack`, layers.py:262-327). A slice
with `pipeline_stages` > 1 under an ambient pp mesh
(parallel/mesh.pipeline_parallel) runs its layer stack through GPipe
stages (parallel/pipeline.gpipe): `num_layers / stages` consecutive layers
a stage, stage i on pp rank i, M = `pipeline_microbatches` (0: 2 x
stages) microbatches, the rows padded to a multiple of M x dp and cut
after; the dispatch comes before attention packing (none under pp, as in
JAX) and each stage runs its layers, the attention kernels included, on
each microbatch. Dropout draws from a generator per microbatch and layer,
seeded from M draws of `rng` (JAX keys them per microbatch and layer too:
they differ from the serial stack's draws by construction). The staged
layers' gradients are each pp rank's own stage's (`pp_partial_parameters`:
summed over pp by the step). `collect_pooled` (IISAN) refuses it.

The FFN's second dense layer of every layer (BERT `ffn_output`, Llama
`down_proj`, OPT `fc2`; `LoRADense(ffn_out=True)`) runs through
`remat.ffn_out`, the operator the `ffn` and `dots` page remat policies
keep (the JAX package tags that output `FFN_OUT_TAG`).

`fused_qkv` (JAX `_fused_qkv_proj`, layers.py:196-251): q, k and v come
from one product against the concatenation of the three base weights
(each projection's LoRA delta folded into its block first with
`lora_fold`), then each unfolded LoRA delta is added with its own dropout
draw. The parameters stay those of the three LoRADense modules. Without a
trainable parameter in it the concatenation is kept (`cached_casts`).

Tensor parallelism (JAX's Megatron shardings over mp, mesh.py:221-278;
parallel/mesh.shard_plan and place_model). `shard_tp` on a BertLayer,
LlamaDecoderLayer or OPTDecoderLayer keeps this rank's H / n query heads
(KV / n key/value heads) and FFN columns: q, k, v and the FFN's first
products are column-parallel (output features and biases sharded, their
input through Megatron's f, `copy_to_mp`), the attention output and the
FFN's second product row-parallel (input features sharded; the partial
products summed by g, `reduce_from_mp`, then the whole bias added).
LoRA factors stay whole: a column-parallel product uses its rows of B, a
row-parallel one its columns of A, and both factors' gradients are
partial on each rank. The attention kernel runs on the rank's heads with
`head_offset` = its first head, so its dropout masks are slices of the
mask one process draws; the plain path's attention dropout draws the
whole (B, H, L, L) noise and keeps the rank's heads. Every other draw
(LoRA input, hidden dropout, the kernel's seed) is of a replicated shape,
the same on every mp rank.

IISAN. With `collect_pooled` a slice returns, instead of its last hidden
states, the masked mean of every layer's output over the item's tokens
(after un-packing), (B, num_layers, D), before any `final_norm`; the mask
is cast to `dtype` and the sum and the division are taken there, as JAX
takes them (`LayerMeans`).
"""
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from legommenders_tpu_torch.models.common import (  # noqa: F401
    FrozenableLayerNorm, cached_casts, dropout, lecun_normal_,
)
from legommenders_tpu_torch.models.lm.remat import ffn_out
from legommenders_tpu_torch.ops.attention import MAX_T, packed_attention
from legommenders_tpu_torch.parallel.mesh import (
    copy_to_mp, get_pp_mesh, reduce_from_mp, shard_slice,
)
from legommenders_tpu_torch.parallel.pipeline import gpipe


class _Staged:
    """What the three slices share for `pipeline_stages`."""

    def _set_stages(self, pipeline_stages: int,
                    pipeline_microbatches: int):
        self.pipeline_stages = int(pipeline_stages or 0)
        self.pipeline_microbatches = int(pipeline_microbatches or 0)

    def _pp_mesh(self):
        """The ambient pp mesh when this slice stages its layers."""
        return get_pp_mesh() if self.pipeline_stages > 1 else None

    def pp_partial_parameters(self):
        """The staged layers' parameters: a pp rank computes only its
        stage's gradients."""
        if self.pipeline_stages <= 1:
            return []
        return [p for layer in self.layers() for p in layer.parameters()]

    def _pipelined(self, x: torch.Tensor, mask_bias: torch.Tensor,
                   rng: Optional[torch.Generator], mesh,
                   run_layer) -> torch.Tensor:
        """The layer stack over x (B, L, D) through GPipe stages over the
        mesh's pp axis (JAX layers.py:262-327); run_layer(layer, h, bias,
        generator) runs one layer."""
        if self.collect_pooled:
            raise ValueError("IISAN pooled collection is not supported "
                             "under pipeline_stages")
        axis = mesh.pp_axis
        stages = self.pipeline_stages
        if self.num_layers % stages:
            raise ValueError(f"num_layers {self.num_layers} % "
                             f"pipeline_stages {stages} != 0")
        if axis.size != stages:
            raise ValueError(f"pipeline_stages {stages} != mesh pp "
                             f"{axis.size}")
        per = self.num_layers // stages
        mine = self.layers()[axis.index * per:(axis.index + 1) * per]
        first = self.start + axis.index * per
        M = self.pipeline_microbatches or 2 * stages
        B = x.shape[0]
        pad = (-B) % (M * mesh.dp)
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
            mask_bias = torch.cat(
                [mask_bias, mask_bias.new_zeros((pad,) + mask_bias.shape[1:])])
        seeds = None
        if rng is not None:
            seeds = torch.randint(0, 2 ** 62, (M,), generator=rng,
                                  device=rng.device).tolist()

        def stage(m, h, bias):
            for j, layer in enumerate(mine):
                g = None
                if seeds is not None:
                    g = torch.Generator(device=h.device)
                    g.manual_seed((seeds[m] + 1_000_003 * (first + j))
                                  % 2 ** 63)
                h = run_layer(layer, h, bias, g)
            return h

        return gpipe(stage, x, axis, M, extras=(mask_bias,),
                     rows=mesh.dp_axis)[:B]


class LoRADense(nn.Module):
    """y = x @ (W + (B A) * alpha / r)^T + b, computed in `dtype`.

    Parameters: weight (F, D), bias (F,) unless `use_bias` is False, and
    with lora_r > 0 lora_A (r, D) and lora_B (F, r): the JAX kernel (D, F),
    lora_A (D, r) and lora_B (r, F) transposed. With `lora_fold` the delta
    is added to W in f32 before the cast; otherwise it is a second,
    low-rank product (dropout(x) A^T) B^T in `dtype`, as in JAX.
    `freeze_base` freezes W and b. `ffn_out` (a layer's FFN output, no
    LoRA) runs the product and the bias through `remat.ffn_out`."""

    def __init__(self, in_features: int, features: int, lora_r: int = 0,
                 lora_alpha: int = 16, lora_dropout: float = 0.0,
                 lora_fold: bool = False, freeze_base: bool = False,
                 use_bias: bool = True, ffn_out: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if ffn_out and lora_r > 0:
            raise ValueError("an FFN output layer takes no LoRA")
        self.ffn_out = ffn_out
        self.lora_r = lora_r
        self.lora_alpha = lora_alpha
        self.lora_dropout = lora_dropout
        self.fold = lora_fold and lora_r > 0
        if self.fold and lora_dropout != 0.0:
            raise ValueError("lora_fold requires lora_dropout == 0")
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features),
                                   requires_grad=not freeze_base)
        self.bias = (nn.Parameter(torch.zeros(features),
                                  requires_grad=not freeze_base)
                     if use_bias else None)
        if lora_r > 0:
            self.lora_A = nn.Parameter(torch.empty(lora_r, in_features))
            self.lora_B = nn.Parameter(torch.zeros(features, lora_r))
        # (mode "col" | "row", mp axis, first and last+1 global index of
        # the sharded features) once `shard_tp` ran
        self.tp = None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        lecun_normal_(self.weight, self.weight.shape[1], generator)
        with torch.no_grad():
            if self.bias is not None:
                self.bias.zero_()
            if self.lora_r > 0:
                self.lora_A.normal_(0.0, 0.02, generator=generator)
                self.lora_B.zero_()

    def shard_tp(self, mode: str, axis):
        """Keep this rank's output features ("col": the weight's rows and
        the bias) or input features ("row": the weight's columns)."""
        dim = 0 if mode == "col" else 1
        k = self.weight.shape[dim] // axis.size
        self.weight.data = shard_slice(self.weight.data, dim, axis)
        if mode == "col" and self.bias is not None:
            self.bias.data = shard_slice(self.bias.data, 0, axis)
        self.tp = (mode, axis, axis.index * k, (axis.index + 1) * k)

    def lora_factors(self):
        """(A, B) as this rank applies them: B's rows of its output
        features (col), A's columns of its input features (row)."""
        a, b = self.lora_A, self.lora_B
        if self.tp is not None:
            mode, _, lo, hi = self.tp
            if mode == "col":
                b = b[lo:hi]
            else:
                a = a[:, lo:hi]
        return a, b

    def weights(self):
        """(kernel (F, D), bias or None) in `dtype`, the LoRA delta folded
        in."""
        def make():
            w = self.weight
            if self.fold:
                a, b = self.lora_factors()
                w = w + (b @ a) * (self.lora_alpha / self.lora_r)
            if self.bias is None:
                return (w.to(self.dtype),)
            return w.to(self.dtype), self.bias.to(self.dtype)
        return cached_casts(self, list(self.parameters()), make)

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        w, *b = self.weights()
        row = self.tp is not None and self.tp[0] == "row"
        bias = b[0] if b and not row else None
        if self.ffn_out:
            y = ffn_out(x.to(self.dtype), w, bias)
        else:
            y = x.to(self.dtype) @ w.t()
            if bias is not None:
                y = y + bias
        if self.lora_r > 0 and not self.fold:
            h = dropout(x, self.lora_dropout, rng).to(self.dtype)
            a, bb = (t.to(self.dtype) for t in self.lora_factors())
            y = y + ((h @ a.t()) @ bb.t()) * (self.lora_alpha / self.lora_r)
        if row:
            y = reduce_from_mp(y, self.tp[1])
            if b:
                y = y + b[0]
        return y


def fused_qkv_weights(owner: nn.Module, projs):
    """(kernel (sum F, D), bias or None) in `owner.dtype`: the base weights
    of `projs` (q, k, v) concatenated, each folded LoRA delta added to its
    block in f32 first (JAX `_fused_qkv_proj`); see `cached_casts`."""
    if len({p.bias is not None for p in projs}) != 1:
        raise ValueError("fused_qkv needs use_bias alike on q, k and v")
    params = [t for p in projs for t in p.parameters()
              if p.fold or t is p.weight or t is p.bias]

    def make():
        blocks = []
        for p in projs:
            w = p.weight
            if p.fold:
                a, b = p.lora_factors()
                w = w + (b @ a) * (p.lora_alpha / p.lora_r)
            blocks.append(w)
        w = torch.cat(blocks).to(owner.dtype)
        if projs[0].bias is None:
            return (w,)
        return w, torch.cat([p.bias for p in projs]).to(owner.dtype)
    return cached_casts(owner, params, make)


def fused_qkv(owner: nn.Module, projs, x: torch.Tensor,
              rng: Optional[torch.Generator] = None):
    """[q, k, v] of x through one product against `fused_qkv_weights`,
    then each unfolded LoRA delta, its dropout drawn in q, k, v order as
    the separate projections draw it; each output contiguous."""
    w, *b = fused_qkv_weights(owner, projs)
    y = x.to(owner.dtype) @ w.t()
    if b:
        y = y + b[0]
    outs = list(y.split([p.weight.shape[0] for p in projs], dim=-1))
    for i, p in enumerate(projs):
        if p.lora_r > 0 and not p.fold:
            h = dropout(x, p.lora_dropout, rng).to(p.dtype)
            a, bb = (t.to(p.dtype) for t in p.lora_factors())
            outs[i] = outs[i] + ((h @ a.t()) @ bb.t()) * (p.lora_alpha
                                                          / p.lora_r)
    return [o.contiguous() for o in outs]


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


def heads_dropout(attn: torch.Tensor, p: float,
                  rng: Optional[torch.Generator], num_heads: int,
                  head_offset: int) -> torch.Tensor:
    """`dropout` of attention probabilities (B, H_local, L, L) holding
    heads head_offset.. of num_heads: the whole (B, num_heads, L, L) noise
    is drawn and the rank's heads kept, so the draw is one process's."""
    if rng is None or p <= 0.0 or attn.shape[1] == num_heads:
        return dropout(attn, p, rng)
    B, h, L, M = attn.shape
    keep = torch.rand((B, num_heads, L, M), generator=rng,
                      device=attn.device)[:, head_offset:head_offset + h]
    keep = keep < 1.0 - p
    return torch.where(keep, attn / (1.0 - p),
                       torch.zeros((), dtype=attn.dtype, device=attn.device))


def _tp_heads(axis, heads: int) -> tuple:
    """(local heads, first head) of a rank on `axis` (None: all, 0)."""
    if axis is None:
        return heads, 0
    k = heads // axis.size
    return k, axis.index * k


def pack_group_size(L: int, requested: int) -> int:
    """The attention-pack group size: `requested` < 0 = auto (as many
    L-token items as fit 128 tokens), 0/1 = off."""
    if requested < 0:
        return max(1, 128 // max(L, 1))
    return max(1, requested)


class LayerMeans:
    """The per-layer masked means of a slice with `collect_pooled` (JAX
    layers.py:600-617): each layer's output, un-packed to (B, L, D), times
    the mask in `dtype`, summed over L and divided by max(count, 1)."""

    def __init__(self, mask: torch.Tensor, dtype: torch.dtype):
        self.m = mask.to(dtype)[:, :, None]
        self.denom = self.m.sum(dim=1).clamp_min(1.0)
        self.means = []

    def add(self, x: torch.Tensor, B: int, L: int, packed: bool):
        xi = x.reshape(-1, L, x.shape[-1])[:B] if packed else x
        self.means.append((xi * self.m).sum(dim=1) / self.denom)

    def stacked(self) -> torch.Tensor:
        return torch.stack(self.means, dim=1)


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


def packed_mask_bias(mask_p: torch.Tensor, L: int, dtype: torch.dtype,
                     causal: bool = False) -> torch.Tensor:
    """Block-diagonal attention bias (Bp, 1, G*L, G*L) in `dtype`: token i
    may attend j only within the same L-token block, j valid (and j <= i
    when `causal`); disallowed pairs get `finfo(dtype).min`."""
    pos = torch.arange(mask_p.shape[1], device=mask_p.device)
    blk = pos // L
    same = blk[:, None] == blk[None, :]
    if causal:
        same = same & (pos[:, None] >= pos[None, :])
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
        self.num_heads = num_heads
        self.dropout = dropout
        self.fused = fused
        self.fused_qkv = fused_qkv
        self.dtype = dtype
        lora = dict(lora_r=lora_r, lora_alpha=lora_alpha,
                    lora_dropout=lora_dropout, lora_fold=lora_fold,
                    freeze_base=freeze_base, dtype=dtype)
        frozen = dict(freeze_base=freeze_base, dtype=dtype)
        self.query = LoRADense(dim, dim, **lora)
        self.key = LoRADense(dim, dim, **frozen)
        self.value = LoRADense(dim, dim, **lora)
        self.output = LoRADense(dim, dim, **frozen)
        self.tp = None  # the mp axis once the heads are sharded

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor,
                rng: Optional[torch.Generator] = None):
        """x (B, L, D); mask_bias (B, 1, 1|L, L) additive, in `dtype`."""
        B, L, _ = x.shape
        H, h0 = _tp_heads(self.tp, self.num_heads)
        x = copy_to_mp(x, self.tp)
        if self.fused_qkv:
            q, k, v = fused_qkv(self, (self.query, self.key, self.value), x,
                                rng)
        else:
            q, k, v = self.query(x, rng), self.key(x), self.value(x, rng)
        D = q.shape[-1]
        d = D // H
        if self.fused and L <= MAX_T:
            bias3 = mask_bias[:, 0].expand(B, L, L)
            p = self.dropout if rng is not None else 0.0
            seed = attention_seed(rng, x.device) if p > 0.0 else None
            out = packed_attention(H, p, q, k, v, bias3, seed, head_offset=h0)
        else:
            q, k, v = (t.reshape(B, L, H, d) for t in (q, k, v))
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.sqrt(
                torch.tensor(d, dtype=self.dtype))
            attn = torch.softmax(scores + mask_bias, dim=-1)
            attn = heads_dropout(attn, self.dropout, rng, self.num_heads, h0)
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
        self.ffn_output = LoRADense(4 * dim, dim, ffn_out=True, **frozen)
        self.output_norm = FrozenableLayerNorm(dim, **norm)
        self.ffn_tp = None

    def tp_pairs(self, n: int):
        """The attention's and the FFN's (name, LoRADense) pairs and
        whether each divides over n ranks."""
        a = self.attention
        attn = [("attention.query", a.query), ("attention.key", a.key),
                ("attention.value", a.value), ("attention.output", a.output)]
        ffn = [("intermediate", self.intermediate),
               ("ffn_output", self.ffn_output)]
        return (attn, ffn, a.num_heads % n == 0,
                self.intermediate.weight.shape[0] % n == 0)

    def shard_tp(self, axis, attention: bool, ffn: bool):
        """Megatron TP over `axis` of the attention and / or the FFN."""
        if attention:
            a = self.attention
            for dense in (a.query, a.key, a.value):
                dense.shard_tp("col", axis)
            a.output.shard_tp("row", axis)
            a.tp = axis
        if ffn:
            self.intermediate.shard_tp("col", axis)
            self.ffn_output.shard_tp("row", axis)
            self.ffn_tp = axis

    def _drop(self, x, site, bits, rng):
        if self.shared is not None:
            return self.shared(x, site, bits, rng)
        return dropout(x, self.dropout, rng), bits

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor,
                rng: Optional[torch.Generator] = None):
        attn, bits = self._drop(self.attention(x, mask_bias, rng), 0, None,
                                rng)
        x = self.attention_norm(x + attn)
        inter = F.gelu(self.intermediate(copy_to_mp(x, self.ffn_tp)),
                       approximate=self.gelu)
        out, _ = self._drop(self.ffn_output(inter), 1, bits, rng)
        return self.output_norm(x + out)


class BertEncoderSlice(_Staged, nn.Module):
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
                 pipeline_stages: int = 0, pipeline_microbatches: int = 0,
                 collect_pooled: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.collect_pooled = collect_pooled
        self.num_layers = num_layers
        self.start = start
        self._set_stages(pipeline_stages, pipeline_microbatches)
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
        mesh = self._pp_mesh()
        if mesh is not None:
            return self._pipelined(x, mask_bias, rng, mesh,
                                   lambda layer, h, b, g: layer(h, b, g))
        G = (pack_group_size(L, self.attention_pack)
             if self.attention_pack else 1)
        if G > 1:
            x, mask_p, _ = pack_items(x, mask, G)
            mask_bias = packed_mask_bias(mask_p, L, self.dtype)
        means = LayerMeans(mask, self.dtype) if self.collect_pooled else None
        for layer in self.layers():
            x = layer(x, mask_bias, rng)
            if means is not None:
                means.add(x, B, L, G > 1)
        if means is not None:
            return means.stacked()
        if G > 1:
            x = x.reshape(-1, L, D)[:B]
        return x


# ---------------------------------------------------------------------------
# Llama / GLM (RMSNorm + rotary + SwiGLU, causal)
# ---------------------------------------------------------------------------
class RMSNorm(nn.Module):
    """x * rsqrt(mean(x^2) + eps) * weight with f32 statistics (JAX
    layers.py:624-640). Without `bf16_apply` the normalised x is rounded to
    `dtype` and multiplied by the f32 weight: the result is f32. With it
    (and a `dtype` other than f32) everything after the statistics runs in
    `dtype`. Parameter `weight` (JAX `weight`); `freeze` freezes it."""

    def __init__(self, dim: int, eps: float = 1e-6, freeze: bool = False,
                 bf16_apply: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.bf16_apply = bf16_apply
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim), requires_grad=not freeze)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.fill_(1.0)

    def forward(self, x: torch.Tensor,
                bf16_apply: Optional[bool] = None) -> torch.Tensor:
        """`bf16_apply`: this call's, in place of the module's."""
        bf16 = self.bf16_apply if bf16_apply is None else bf16_apply
        var = x.float().pow(2).mean(dim=-1, keepdim=True)
        if bf16 and self.dtype != torch.float32:
            inv = torch.rsqrt(var + self.eps).to(self.dtype)
            return x.to(self.dtype) * inv * self.weight.to(self.dtype)
        return (x * torch.rsqrt(var + self.eps)).to(self.dtype) * self.weight


def rotary_embedding(L: int, d: int, base: float = 10000.0,
                     dtype: torch.dtype = torch.float32, device=None):
    """(cos, sin), each (L, d) in `dtype`: the angles t / base^(2i/d) of
    positions t < L, computed in f32, their halves repeated (JAX
    layers.py:642-647)."""
    inv_freq = 1.0 / (base ** (torch.arange(0, d, 2, dtype=torch.float32,
                                            device=device) / d))
    t = torch.arange(L, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """x (B, L, H, d) rotated by the half-split rule (JAX :650-655)."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    rotated = torch.cat([-x2, x1], dim=-1)
    return x * cos[None, :, None, :] + rotated * sin[None, :, None, :]


def rotary_interleaved_embedding(L: int, rot_dim: int, base: float = 10000.0,
                                 dtype: torch.dtype = torch.float32,
                                 device=None):
    """GLM's partial rotary tables: (cos, sin), each (L, rot_dim / 2), over
    interleaved (even, odd) pairs (JAX :658-666)."""
    inv_freq = 1.0 / (base ** (torch.arange(
        0, rot_dim, 2, dtype=torch.float32, device=device) / rot_dim))
    t = torch.arange(L, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return freqs.cos().to(dtype), freqs.sin().to(dtype)


def apply_rotary_partial_interleaved(x: torch.Tensor, cos: torch.Tensor,
                                     sin: torch.Tensor) -> torch.Tensor:
    """GLM's rotary: the first rot_dim head dims rotate in (even, odd)
    pairs, the rest pass through (JAX :669-683). x (B, L, H, d)."""
    rot = cos.shape[-1] * 2
    xr, x_pass = x[..., :rot], x[..., rot:]
    x0, x1 = xr[..., 0::2], xr[..., 1::2]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    rotated = torch.stack([x0 * c - x1 * s, x1 * c + x0 * s],
                          dim=-1).reshape(xr.shape)
    return torch.cat([rotated, x_pass], dim=-1)


def rotary_tables(interleaved: bool, period: int, L: int, dim: int,
                  base: float, dtype: torch.dtype, device):
    """The (cos, sin) a layer applies to L positions whose count restarts
    every `period` tokens (packed items), the tables tiled L // period
    times (JAX :745-762)."""
    make = rotary_interleaved_embedding if interleaved else rotary_embedding
    cos, sin = make(period, dim, base, dtype, device)
    if period != L:
        cos, sin = cos.tile(L // period, 1), sin.tile(L // period, 1)
    return cos, sin


def _attention_core(x_dtype, q, k, v, mask_bias, num_heads, fused: bool):
    """softmax(q k^T / sqrt(d) + bias) v for q, k, v (B, L, H, d) (k and v
    already repeated per head): the kernel when `fused` and L <= MAX_T (its
    scale 1/sqrt(D // H) applied inside), else plain tensor code in the
    operands' dtype. Returns (B, L, D)."""
    B, L, H, d = q.shape
    if fused and L <= MAX_T:
        bias3 = mask_bias[:, 0].expand(B, L, L)
        return packed_attention(num_heads, 0.0, q.reshape(B, L, H * d),
                                k.reshape(B, L, H * d),
                                v.reshape(B, L, H * d), bias3)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.sqrt(
        torch.tensor(d, dtype=x_dtype))
    attn = torch.softmax(scores + mask_bias, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, L, H * d)


class LlamaDecoderLayer(nn.Module):
    """RMSNorm, q/k/v (LoRA on q and v, biases with `qkv_bias`), rotary
    (GLM's partial interleaved form with `rotary_interleaved` or
    `rotary_fraction` < 1), grouped-query attention over `num_kv_heads`
    (None: `num_heads`), o_proj, residual; RMSNorm, SwiGLU
    (`intermediate_size`, None: int(8 D / 3)), residual (JAX
    layers.py:685-795). No dropout site but LoRA's input."""

    def __init__(self, dim: int, num_heads: int,
                 num_kv_heads: Optional[int] = None,
                 intermediate_size: Optional[int] = None, lora_r: int = 0,
                 lora_alpha: int = 16, lora_dropout: float = 0.0,
                 freeze_base: bool = False, rope_theta: float = 10000.0,
                 qkv_bias: bool = False, rotary_fraction: float = 1.0,
                 rotary_interleaved: bool = False,
                 fused_attention: bool = False, fused_qkv: bool = False,
                 lora_fold: bool = False, norm_bf16: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fused_qkv = fused_qkv
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.head_dim = dim // num_heads
        self.rope_theta = rope_theta
        self.partial = rotary_interleaved or rotary_fraction < 1.0
        self.rot_dim = (int(self.head_dim * rotary_fraction) // 2 * 2
                        if self.partial else self.head_dim)
        self.fused = fused_attention
        self.dtype = dtype
        inter = intermediate_size or int(dim * 8 / 3)
        kv = self.num_kv_heads * self.head_dim
        lora = dict(lora_r=lora_r, lora_alpha=lora_alpha,
                    lora_dropout=lora_dropout, lora_fold=lora_fold,
                    freeze_base=freeze_base, dtype=dtype)
        frozen = dict(freeze_base=freeze_base, dtype=dtype)
        norm = dict(freeze=freeze_base, bf16_apply=norm_bf16, dtype=dtype)
        self.input_norm = RMSNorm(dim, **norm)
        self.q_proj = LoRADense(dim, dim, use_bias=qkv_bias, **lora)
        self.k_proj = LoRADense(dim, kv, use_bias=qkv_bias, **frozen)
        self.v_proj = LoRADense(dim, kv, use_bias=qkv_bias, **lora)
        self.o_proj = LoRADense(dim, dim, use_bias=False, **frozen)
        self.post_norm = RMSNorm(dim, **norm)
        self.gate_proj = LoRADense(dim, inter, use_bias=False, **frozen)
        self.up_proj = LoRADense(dim, inter, use_bias=False, **frozen)
        self.down_proj = LoRADense(inter, dim, use_bias=False, ffn_out=True,
                                   **frozen)
        self.attn_tp = self.ffn_tp = None

    def tp_pairs(self, n: int):
        """The attention's and the FFN's (name, LoRADense) pairs and
        whether each divides over n ranks (heads and kv heads alike)."""
        attn = [(k, getattr(self, k)) for k in ("q_proj", "k_proj", "v_proj",
                                                "o_proj")]
        ffn = [(k, getattr(self, k)) for k in ("gate_proj", "up_proj",
                                               "down_proj")]
        return (attn, ffn,
                self.num_heads % n == 0 and self.num_kv_heads % n == 0,
                self.gate_proj.weight.shape[0] % n == 0)

    def shard_tp(self, axis, attention: bool, ffn: bool):
        """Megatron TP over `axis` of the attention and / or the FFN."""
        if attention:
            for k in ("q_proj", "k_proj", "v_proj"):
                getattr(self, k).shard_tp("col", axis)
            self.o_proj.shard_tp("row", axis)
            self.attn_tp = axis
        if ffn:
            self.gate_proj.shard_tp("col", axis)
            self.up_proj.shard_tp("col", axis)
            self.down_proj.shard_tp("row", axis)
            self.ffn_tp = axis

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor,
                rotary_period: int = 0,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, L, D) in `dtype`; mask_bias (B, 1, L, L) additive;
        positions restart every `rotary_period` tokens (0: never)."""
        B, L, D = x.shape
        H, _ = _tp_heads(self.attn_tp, self.num_heads)
        KV, _ = _tp_heads(self.attn_tp, self.num_kv_heads)
        d = self.head_dim
        h = copy_to_mp(self.input_norm(x), self.attn_tp)
        if self.fused_qkv:
            q, k, v = fused_qkv(self, (self.q_proj, self.k_proj, self.v_proj),
                                h, rng)
        else:
            q, k, v = self.q_proj(h, rng), self.k_proj(h), self.v_proj(h, rng)
        q = q.reshape(B, L, H, d)
        k, v = k.reshape(B, L, KV, d), v.reshape(B, L, KV, d)
        cos, sin = rotary_tables(self.partial, rotary_period or L, L,
                                 self.rot_dim, self.rope_theta, self.dtype,
                                 x.device)
        rotate = (apply_rotary_partial_interleaved if self.partial
                  else apply_rotary)
        q, k = rotate(q, cos, sin), rotate(k, cos, sin)
        if KV != H:
            k = k.repeat_interleave(H // KV, dim=2)
            v = v.repeat_interleave(H // KV, dim=2)
        out = _attention_core(self.dtype, q, k, v, mask_bias, H, self.fused)
        x = x + self.o_proj(out)
        h = copy_to_mp(self.post_norm(x), self.ffn_tp)
        inter = F.silu(self.gate_proj(h)) * self.up_proj(h)
        return x + self.down_proj(inter)


def causal_mask_bias(mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, 1, L, L) in `dtype`: 0 where key j <= query i and j is valid,
    `finfo(dtype).min` elsewhere."""
    L = mask.shape[1]
    causal = torch.ones(L, L, dtype=torch.bool, device=mask.device).tril()
    allowed = causal[None, None] & mask.bool()[:, None, None, :]
    return torch.where(allowed, torch.zeros((), dtype=dtype,
                                            device=mask.device),
                       torch.full((), torch.finfo(dtype).min, dtype=dtype,
                                  device=mask.device))


class _DecoderSlice(_Staged, nn.Module):
    """What the two decoder slices share: the causal bias, packing (the
    causal block-diagonal bias; positions restart per item), the layer
    loop, unpacking and `final_norm`; under pp the staged stack, before
    packing, then `final_norm` (JAX applies OPT's with `norm_bf16` there,
    layers.py:1046-1050)."""

    def layers(self):
        return [getattr(self, f"layer_{i}")
                for i in range(self.start, self.start + self.num_layers)]

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def _run(self, x: torch.Tensor, mask: torch.Tensor,
             rng: Optional[torch.Generator]) -> torch.Tensor:
        B, L, D = x.shape
        mesh = self._pp_mesh()
        if mesh is not None:
            x = self._pipelined(
                x, causal_mask_bias(mask, self.dtype), rng, mesh,
                lambda layer, h, b, g: self._layer(layer, h, b, 0, g))
            if self.final_norm is not None:
                x = self.final_norm(x, self.norm_bf16)
            return x
        G = (pack_group_size(L, self.attention_pack)
             if self.attention_pack else 1)
        if G > 1:
            x, mask_p, _ = pack_items(x, mask, G)
            mask_bias = packed_mask_bias(mask_p, L, self.dtype, causal=True)
        else:
            mask_bias = causal_mask_bias(mask, self.dtype)
        means = LayerMeans(mask, self.dtype) if self.collect_pooled else None
        for layer in self.layers():
            x = self._layer(layer, x, mask_bias, L if G > 1 else 0, rng)
            if means is not None:
                means.add(x, B, L, G > 1)
        if means is not None:
            return means.stacked()
        if G > 1:
            x = x.reshape(-1, L, D)[:B]
        if self.final_norm is not None:
            x = self.final_norm(x)
        return x


class LlamaDecoderSlice(_DecoderSlice):
    """Layers [start, start + num_layers) of a Llama / GLM decoder over
    hidden states (B, L, dim) with mask (B, L), then the RMSNorm
    `final_norm` when asked (the trainable slice) (JAX layers.py:798-888).
    Parameters under the JAX names: `layer_{start + i}` and `final_norm`."""

    def __init__(self, num_layers: int, dim: int, num_heads: int = 32,
                 num_kv_heads: Optional[int] = None,
                 intermediate_size: Optional[int] = None, start: int = 0,
                 final_norm: bool = True, lora_r: int = 0,
                 lora_alpha: int = 16, lora_dropout: float = 0.0,
                 freeze_base: bool = False, rope_theta: float = 10000.0,
                 qkv_bias: bool = False, rotary_fraction: float = 1.0,
                 rotary_interleaved: bool = False, attention_pack: int = 0,
                 lora_fold: bool = False, norm_bf16: bool = False,
                 fused_attention: bool = False, fused_qkv: bool = False,
                 pipeline_stages: int = 0, pipeline_microbatches: int = 0,
                 collect_pooled: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.collect_pooled = collect_pooled
        self.num_layers = num_layers
        self.start = start
        self._set_stages(pipeline_stages, pipeline_microbatches)
        self.attention_pack = attention_pack
        self.norm_bf16 = norm_bf16
        self.dtype = dtype
        for i in range(start, start + num_layers):
            self.add_module(f"layer_{i}", LlamaDecoderLayer(
                dim, num_heads, num_kv_heads, intermediate_size, lora_r,
                lora_alpha, lora_dropout, freeze_base, rope_theta,
                qkv_bias=qkv_bias, rotary_fraction=rotary_fraction,
                rotary_interleaved=rotary_interleaved,
                fused_attention=fused_attention, fused_qkv=fused_qkv,
                lora_fold=lora_fold, norm_bf16=norm_bf16, dtype=dtype))
        self.final_norm = (RMSNorm(dim, freeze=freeze_base,
                                   bf16_apply=norm_bf16, dtype=dtype)
                           if final_norm else None)
        self.reset_parameters()

    @staticmethod
    def _layer(layer, x, mask_bias, period, rng):
        return layer(x, mask_bias, period, rng)

    def forward(self, hidden_states: torch.Tensor, mask: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        return self._run(hidden_states.to(self.dtype), mask, rng)


# ---------------------------------------------------------------------------
# OPT (learned positions at offset 2, pre-LN, causal)
# ---------------------------------------------------------------------------
class OPTDecoderLayer(nn.Module):
    """Pre-LN: LayerNorm (eps 1e-5), q/k/v with biases (LoRA on q and v),
    attention, out_proj, hidden dropout, residual; LayerNorm, fc1, ReLU,
    fc2, hidden dropout, residual (JAX layers.py:891-969). The two hidden
    dropout sites share one SharedBitsDropout draw with `dropout_reuse`.
    The kernel takes q unscaled (it scales by 1/sqrt(d) itself); the plain
    path scales q in `dtype` first, as JAX does."""

    def __init__(self, dim: int, num_heads: int, ffn_dim: Optional[int] = None,
                 lora_r: int = 0, lora_alpha: int = 16,
                 lora_dropout: float = 0.0, freeze_base: bool = False,
                 dropout: float = 0.0, fused_attention: bool = False,
                 fused_qkv: bool = False, lora_fold: bool = False,
                 norm_bf16: bool = False, dropout_reuse: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.fused = fused_attention
        self.fused_qkv = fused_qkv
        self.dtype = dtype
        self.shared = SharedBitsDropout(dropout) if dropout_reuse else None
        lora = dict(lora_r=lora_r, lora_alpha=lora_alpha,
                    lora_dropout=lora_dropout, lora_fold=lora_fold,
                    freeze_base=freeze_base, dtype=dtype)
        frozen = dict(freeze_base=freeze_base, dtype=dtype)
        norm = dict(epsilon=1e-5, bf16_apply=norm_bf16, freeze=freeze_base,
                    dtype=dtype)
        self.attn_norm = FrozenableLayerNorm(dim, **norm)
        self.q_proj = LoRADense(dim, dim, **lora)
        self.k_proj = LoRADense(dim, dim, **frozen)
        self.v_proj = LoRADense(dim, dim, **lora)
        self.out_proj = LoRADense(dim, dim, **frozen)
        self.ffn_norm = FrozenableLayerNorm(dim, **norm)
        self.fc1 = LoRADense(dim, ffn_dim or 4 * dim, **frozen)
        self.fc2 = LoRADense(ffn_dim or 4 * dim, dim, ffn_out=True, **frozen)
        self.attn_tp = self.ffn_tp = None

    def tp_pairs(self, n: int):
        """The attention's and the FFN's (name, LoRADense) pairs and
        whether each divides over n ranks."""
        attn = [(k, getattr(self, k)) for k in ("q_proj", "k_proj", "v_proj",
                                                "out_proj")]
        ffn = [("fc1", self.fc1), ("fc2", self.fc2)]
        return (attn, ffn, self.num_heads % n == 0,
                self.fc1.weight.shape[0] % n == 0)

    def shard_tp(self, axis, attention: bool, ffn: bool):
        """Megatron TP over `axis` of the attention and / or the FFN."""
        if attention:
            for k in ("q_proj", "k_proj", "v_proj"):
                getattr(self, k).shard_tp("col", axis)
            self.out_proj.shard_tp("row", axis)
            self.attn_tp = axis
        if ffn:
            self.fc1.shard_tp("col", axis)
            self.fc2.shard_tp("row", axis)
            self.ffn_tp = axis

    def _drop(self, x, site, bits, rng):
        if self.shared is not None:
            return self.shared(x, site, bits, rng)
        return dropout(x, self.dropout, rng), bits

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        B, L, _ = x.shape
        H, _ = _tp_heads(self.attn_tp, self.num_heads)
        h = copy_to_mp(self.attn_norm(x), self.attn_tp)
        if self.fused_qkv:
            q, k, v = fused_qkv(self, (self.q_proj, self.k_proj, self.v_proj),
                                h, rng)
        else:
            q, k, v = self.q_proj(h, rng), self.k_proj(h), self.v_proj(h, rng)
        D = q.shape[-1]
        d = D // H
        if self.fused and L <= MAX_T:
            out = packed_attention(H, 0.0, q, k, v,
                                   mask_bias[:, 0].expand(B, L, L))
        else:
            q = q.reshape(B, L, H, d) * (d ** -0.5)
            k, v = k.reshape(B, L, H, d), v.reshape(B, L, H, d)
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) + mask_bias
            attn = torch.softmax(scores, dim=-1)
            out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, L, D)
        out, bits = self._drop(self.out_proj(out), 0, None, rng)
        x = x + out
        h = F.relu(self.fc1(copy_to_mp(self.ffn_norm(x), self.ffn_tp)))
        h, _ = self._drop(self.fc2(h), 1, bits, rng)
        return x + h


class OPTDecoderSlice(_DecoderSlice):
    """Layers [start, start + num_layers) of an OPT decoder over hidden
    states (B, L, dim) with mask (B, L) (JAX layers.py:972-1067). At start
    0 with `embed_positions` the learned positions are added first: row
    clip(cumsum(mask) - 1, 0) + 2 of `position_embeddings` (max_position
    + 2, dim). `final_norm` (the trainable slice) is a LayerNorm of eps
    1e-5 that, as in JAX, applies in f32 whatever `norm_bf16` says."""

    def __init__(self, num_layers: int, dim: int, num_heads: int = 12,
                 ffn_dim: Optional[int] = None, start: int = 0,
                 embed_positions: bool = True, final_norm: bool = True,
                 max_position: int = 2048, lora_r: int = 0,
                 lora_alpha: int = 16, lora_dropout: float = 0.0,
                 freeze_base: bool = False, dropout: float = 0.0,
                 attention_pack: int = 0, fused_attention: bool = False,
                 fused_qkv: bool = False, lora_fold: bool = False,
                 norm_bf16: bool = False, dropout_reuse: bool = False,
                 pipeline_stages: int = 0, pipeline_microbatches: int = 0,
                 collect_pooled: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.collect_pooled = collect_pooled
        self.num_layers = num_layers
        self.start = start
        self._set_stages(pipeline_stages, pipeline_microbatches)
        self.attention_pack = attention_pack
        self.norm_bf16 = norm_bf16
        self.dtype = dtype
        self.embed = embed_positions and start == 0
        if self.embed:
            self.position_embeddings = nn.Parameter(
                torch.empty(max_position + 2, dim),
                requires_grad=not freeze_base)
        for i in range(start, start + num_layers):
            self.add_module(f"layer_{i}", OPTDecoderLayer(
                dim, num_heads, ffn_dim, lora_r, lora_alpha, lora_dropout,
                freeze_base, dropout=dropout,
                fused_attention=fused_attention, fused_qkv=fused_qkv,
                lora_fold=lora_fold, norm_bf16=norm_bf16,
                dropout_reuse=dropout_reuse, dtype=dtype))
        self.final_norm = (FrozenableLayerNorm(dim, epsilon=1e-5,
                                               freeze=freeze_base,
                                               dtype=dtype)
                           if final_norm else None)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        if self.embed:
            with torch.no_grad():
                self.position_embeddings.normal_(0.0, 0.02,
                                                 generator=generator)
        super().reset_parameters(generator)

    @staticmethod
    def _layer(layer, x, mask_bias, period, rng):
        return layer(x, mask_bias, rng)

    def forward(self, hidden_states: torch.Tensor, mask: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = hidden_states.to(self.dtype)
        if self.embed:
            pos = (torch.cumsum(mask.to(torch.int32), dim=1) - 1).clamp_min(0)
            x = x + self.position_embeddings[pos.long() + 2].to(self.dtype)
        return self._run(x, mask, rng)


# the layers `parallel/mesh.shard_plan` shards by Megatron TP
TP_LAYERS = (BertLayer, LlamaDecoderLayer, OPTDecoderLayer)
