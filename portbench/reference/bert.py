"""The reference of the "bert" family: a BERT item encoder (Devlin et al.,
"BERT", NAACL 2019, post-LayerNorm) under NAML's pool, as Legommenders'
bert-naml composes it, with the work one item takes.

Item: [CLS] title [SEP] category [SEP] from the word and category tables
and two special-token rows, valid tokens moved to the front (stable), +
position and token-type embeddings, LayerNorm, then the layers: q, k, v
(LoRA folded into q and v: W + B A alpha / r), attention over the item's
own valid tokens, output projection, residual + LayerNorm, FFN with
tanh-approximated GELU, residual + LayerNorm; then Linear to the hidden
width and the pool (layers.pool). Evaluation only: it draws no dropout.
"""
import math

import torch
from torch.nn import functional as F

from portbench.reference import layers
from portbench.reference.layers import NEG, pool, pool_flops, pool_shapes

POOL = "item_op.pool"


def parameter_shapes(ref: dict, data: dict) -> dict:
    H, D, r, Fd = ref["hidden"], ref["dim"], ref["lora_r"], ref["ffn"]
    shapes = {"eh.tables.vocab__word": (data["vocab"], D),
              "eh.tables.vocab__category": (data["topics"], D),
              "item_inputer.special_tokens": (2, D),
              "item_op.lm.position_embeddings": (ref["max_position"], D),
              "item_op.lm.token_type_embeddings": (1, D),
              "item_op.lm.embeddings_norm.weight": (D,),
              "item_op.lm.embeddings_norm.bias": (D,),
              "item_op.linear.weight": (H, D),
              "item_op.linear.bias": (H,)}
    shapes.update(pool_shapes(POOL, H, ref["pool_hidden"]))
    shapes.update(layers.ada_shapes(ref))
    for i in range(ref["layers"]):
        p = f"item_op.lm.layer_{i}."
        for name in ("query", "key", "value", "output"):
            shapes[p + f"attention.{name}.weight"] = (D, D)
            shapes[p + f"attention.{name}.bias"] = (D,)
        for name in ("query", "value"):
            shapes[p + f"attention.{name}.lora_A"] = (r, D)
            shapes[p + f"attention.{name}.lora_B"] = (D, r)
        for name in ("attention_norm", "output_norm"):
            shapes[p + f"{name}.weight"] = (D,)
            shapes[p + f"{name}.bias"] = (D,)
        shapes[p + "intermediate.weight"] = (Fd, D)
        shapes[p + "intermediate.bias"] = (Fd,)
        shapes[p + "ffn_output.weight"] = (D, Fd)
        shapes[p + "ffn_output.bias"] = (D,)
    return shapes


def _layer_norm(x, W, name, eps):
    return F.layer_norm(x, x.shape[-1:], W[name + ".weight"],
                        W[name + ".bias"], eps)


def _lora(W, p, ref):
    w = W[p + ".weight"]
    if p + ".lora_A" in W:
        w = w + (W[p + ".lora_B"] @ W[p + ".lora_A"]) * (
            ref["lora_alpha"] / ref["lora_r"])
    return w


def items(ref: dict, W: dict, title: torch.Tensor, category: torch.Tensor,
          q, rng=None) -> torch.Tensor:
    """Item vectors of title (n, Lt) and category (n,)."""
    if rng is not None:
        raise ValueError("the bert family's reference does not train")
    n = title.shape[0]
    D, Hh = ref["dim"], ref["heads"]
    d = D // Hh
    eps = ref["ln_eps"]
    mt = (title >= 0).float()
    word = W["eh.tables.vocab__word"][title.clamp(min=0)] * mt[..., None]
    cat = W["eh.tables.vocab__category"][category.long()][:, None, :]
    sp = W["item_inputer.special_tokens"]
    cls, sep = sp[0].expand(n, 1, D), sp[1].expand(n, 1, D)
    one = torch.ones_like(mt[:, :1])
    emb = torch.cat([cls, word, sep, cat, sep], dim=1)
    mask = torch.cat([one, mt, one, one, one], dim=1)
    order = torch.argsort(1.0 - mask, dim=1, stable=True)
    emb = torch.take_along_dim(emb, order[..., None], dim=1)
    mask = torch.take_along_dim(mask, order, dim=1)
    L = mask.shape[1]
    x = emb + W["item_op.lm.position_embeddings"][None, :L] \
        + W["item_op.lm.token_type_embeddings"][None]
    x = _layer_norm(x, W, "item_op.lm.embeddings_norm", eps)
    bias = ((1.0 - mask) * NEG)[:, None, None, :]
    for i in range(ref["layers"]):
        p = f"item_op.lm.layer_{i}."
        qkv = [F.linear(q(x), q(_lora(W, p + f"attention.{nm}", ref)),
                        W[p + f"attention.{nm}.bias"]).view(n, L, Hh, d)
               for nm in ("query", "key", "value")]
        s = torch.einsum("bqhd,bkhd->bhqk", q(qkv[0]), q(qkv[1]))
        a = torch.softmax(s / math.sqrt(d) + bias, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", q(a), q(qkv[2])).reshape(n, L, D)
        o = F.linear(q(o), q(W[p + "attention.output.weight"]),
                     W[p + "attention.output.bias"])
        x = _layer_norm(x + o, W, p + "attention_norm", eps)
        h = F.gelu(F.linear(q(x), q(W[p + "intermediate.weight"]),
                            W[p + "intermediate.bias"]),
                   approximate=ref["gelu"])
        h = F.linear(q(h), q(W[p + "ffn_output.weight"]),
                     W[p + "ffn_output.bias"])
        x = _layer_norm(x + h, W, p + "output_norm", eps)
    y = F.linear(q(x), q(W["item_op.linear.weight"]), W["item_op.linear.bias"])
    return pool(W, POOL, y, mask, q)


# the Ada user operator
users = layers.ada_users
user_pool_calls = layers.ada_pool_calls
user_flops = layers.ada_flops


# ---------------------------------------------------------------------- #
# the work, counted from the shapes                                        #
# ---------------------------------------------------------------------- #
def positions(ref: dict, data: dict) -> int:
    """[CLS] title [SEP] category [SEP]."""
    return data["title_tokens"][1] + 4


def _layer_flops_per_token(ref: dict) -> float:
    D, Fd = ref["dim"], ref["ffn"]
    return 2.0 * (4 * D * D + 2 * D * Fd)



def item_pool_calls(ref: dict, data: dict, n: int) -> list:
    """(N, L) of the pool launches that encode n items."""
    return [(n, positions(ref, data))]


def item_flops(ref: dict, data: dict) -> float:
    """The model's operations to encode one item on its own L positions
    (no packing pad): every layer's products and attention, the head's
    Linear, the pool."""
    L, D, H = positions(ref, data), ref["dim"], ref["hidden"]
    return (ref["layers"] * (L * _layer_flops_per_token(ref)
                             + 4.0 * L * L * D)
            + 2.0 * L * D * H + pool_flops(1, L, H, ref["pool_hidden"]))


def page_attention(ref: dict, data: dict, n: int) -> list:
    """(B, T) of the attention launches that encode a page of n items:
    the items packed `pack_tokens` // L to a row, once a layer."""
    L = positions(ref, data)
    G = max(1, ref["pack_tokens"] // L)
    return [(-(-n // G), G * L)] * ref["layers"]


def gemm_flops(ref: dict, data: dict, page_rows) -> float:
    """The matrix products of encoding pages of these item counts as the
    card runs them: every layer's q, k, v, output and FFN products over
    the packed rows' positions, the LoRA folds (B A, q and v a layer,
    once a weight set) and the head's Linear over every item's
    positions."""
    D, H, r = ref["dim"], ref["hidden"], ref["lora_r"]
    rows = sum(B * T for n in page_rows
               for B, T in page_attention(ref, data, n))
    return (rows * _layer_flops_per_token(ref)
            + ref["layers"] * 2 * 2.0 * D * r * D
            + 2.0 * sum(page_rows) * positions(ref, data) * D * H)
