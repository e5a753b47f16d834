"""Ulysses sequence-parallel self-attention over the sp axis.

The port of the JAX package's ops/sp_attention.py (DeepSpeed-Ulysses, a
shard_map with two all-to-alls there; here each sp rank calls it on its
own positions). q, k and v arrive sequence-sharded; an all-to-all
re-shards them from the sequence to the heads, each rank runs plain
masked-softmax attention of its H / sp heads over the whole sequence, and
the inverse all-to-all returns the output to the sequence. The
all-to-all's backward is the inverse all-to-all
(parallel/mesh.all_to_all). Requires H % sp == 0 (and the sequence's
L % sp == 0, checked where it is sharded).
"""
import torch

from legommenders_tpu_torch.ops.core import masked_softmax
from legommenders_tpu_torch.parallel.mesh import (
    Axis, all_gather_dim, all_to_all,
)


def check_heads(num_heads: int, axis: Axis):
    """JAX's refusal (lax.all_to_all) where the heads do not divide."""
    if num_heads % axis.size:
        raise ValueError(
            f"The size of all_to_all split_axis ({num_heads}) has to be "
            f"divisible by the size of the named axis sp ({axis.size})")


def check_sequence(L: int, axis: Axis):
    """JAX's refusal (shard_map) of a sequence that does not divide over
    the sp axis."""
    if L % axis.size:
        raise ValueError(
            f"a sequence of {L} positions is not evenly divisible by the "
            f"corresponding mesh axis sizes (sp={axis.size})")


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask: torch.Tensor, axis: Axis,
                      num_heads: int) -> torch.Tensor:
    """q, k, v (B, l, D) and mask (B, l): this rank's l positions. Returns
    (B, l, D), this rank's positions of the attention output."""
    check_heads(num_heads, axis)
    B, l, D = q.shape
    H, d = num_heads, D // num_heads

    def seq_to_heads(x):
        # (B, l, H, d) -> (B, L, H / sp, d)
        return all_to_all(x.reshape(B, l, H, d), axis, split=2, cat=1)

    qh, kh, vh = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    m_full = all_gather_dim(mask, axis, 1)
    scores = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / torch.tensor(
        float(d), dtype=qh.dtype).sqrt()
    attn = masked_softmax(scores, m_full[:, None, None, :])
    out = torch.einsum("bhqk,bkhd->bqhd", attn, vh)
    return all_to_all(out, axis, split=1, cat=2).reshape(B, l, D)
