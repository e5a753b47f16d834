"""The reference of the "cnn" family: NAML's item encoder (Wu et al.,
"Neural News Recommendation with Attentive Multi-View Learning", IJCAI
2019, as Legommenders composes it), with the work one item takes.

Item: title tokens -> embeddings (pads zeroed) -> Conv1d k 'same' (zeros
(k-1)//2 left, k//2 right) -> ReLU -> pads zeroed -> dropout (training);
category -> embedding -> Linear; the two sequences concatenated and
pooled (layers.pool). Training's dropout keep mask (n, Lt, hidden) is the
family's draw from the step's generator, after the negatives.
"""
import torch
from torch.nn import functional as F

from portbench.reference import layers
from portbench.reference.layers import pool, pool_flops, pool_shapes

POOL = "item_op.attention"


def parameter_shapes(ref: dict, data: dict) -> dict:
    H, D = ref["hidden"], ref.get("dim", ref["hidden"])
    shapes = {"eh.tables.vocab__word": (data["vocab"], D),
              "eh.tables.vocab__category": (data["topics"], D),
              "item_op.cnn.weight": (H, D, ref["kernel"]),
              "item_op.cnn.bias": (H,),
              "item_op.linear.weight": (H, D),
              "item_op.linear.bias": (H,)}
    shapes.update(pool_shapes(POOL, H, ref["pool_hidden"]))
    shapes.update(layers.ada_shapes(ref))
    return shapes


def items(ref: dict, W: dict, title: torch.Tensor, category: torch.Tensor,
          q, rng=None) -> torch.Tensor:
    """Item vectors of title (n, Lt) and category (n,); with `rng`, in
    training, the dropout drawn from it."""
    n, Lt = title.shape
    m = (title >= 0).float()
    emb = W["eh.tables.vocab__word"][title.clamp(min=0)] * m[..., None]
    k = ref["kernel"]
    x = F.conv1d(F.pad(q(emb).transpose(1, 2), ((k - 1) // 2, k // 2)),
                 q(W["item_op.cnn.weight"]), W["item_op.cnn.bias"])
    x = torch.relu(x).transpose(1, 2) * m[..., None]
    if rng is not None:
        keep = torch.rand((n, Lt, ref["hidden"]), generator=rng,
                          device=title.device) < 1.0 - ref["dropout"]
        x = torch.where(keep, x / (1.0 - ref["dropout"]), 0.0)
    c = W["eh.tables.vocab__category"][category.long()][:, None, :]
    c = F.linear(q(c), q(W["item_op.linear.weight"]),
                 W["item_op.linear.bias"])
    seq = torch.cat([x, c], dim=1)
    mask = torch.cat([m, torch.ones_like(m[:, :1])], dim=1)
    return pool(W, POOL, seq, mask, q)


# the Ada user operator
users = layers.ada_users
user_pool_calls = layers.ada_pool_calls
user_flops = layers.ada_flops


# ---------------------------------------------------------------------- #
# the work, counted from the shapes                                        #
# ---------------------------------------------------------------------- #
def positions(ref: dict, data: dict) -> int:
    """Positions an item's vector pools over: the title's and the
    category's."""
    return data["title_tokens"][1] + 1



def item_pool_calls(ref: dict, data: dict, n: int) -> list:
    """(N, L) of the pool launches that encode n items."""
    return [(n, positions(ref, data))]


def item_flops(ref: dict, data: dict) -> float:
    """The model's operations to encode one item, on its own positions:
    the convolution, the category's Linear, the pool."""
    H, D = ref["hidden"], ref.get("dim", ref["hidden"])
    Lt = data["title_tokens"][1]
    return (2.0 * Lt * D * H * ref["kernel"] + 2.0 * D * H
            + pool_flops(1, positions(ref, data), H, ref["pool_hidden"]))


def page_attention(ref: dict, data: dict, n: int) -> list:
    """(B, T) of the attention launches that encode a page of n items:
    none."""
    return []


def gemm_flops(ref: dict, data: dict, page_rows) -> None:
    """The encoder's products run by cuBLAS: the convolution runs in
    cuDNN, so none are counted."""
    return None
