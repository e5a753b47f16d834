"""Sequence-parallel additive attention over the sp axis.

The port of the JAX package's ops/sp_additive.py (a shard_map over `sp`
there; here each sp rank calls it on its own positions). The pool
out = sum_l softmax(s)_l x_l decomposes over the shards with the
max-shifted two-pass trick:
    m = the max of every shard's masked maximum (no gradient; 0 where
        every score of the row is masked)
    Z = the sum over the shards of sum_local exp(s - m) * mask
    W = the sum over the shards of sum_local exp(s - m) * mask * x
    out = W / (Z + EPS)
The two sums are all-reduces whose backward is the identity (Megatron's
g: every rank holds the same result and the same gradient of it), so each
rank's x and scores get their positions' gradient of the unsharded pool.
Everything runs in the scores' dtype, as in JAX.
"""
import torch

from legommenders_tpu_torch.ops.core import EPS
from legommenders_tpu_torch.parallel.mesh import (
    Axis, all_gather_dim, reduce_from_mp,
)


def sp_additive_attention(x: torch.Tensor, scores: torch.Tensor,
                          mask: torch.Tensor, axis: Axis) -> torch.Tensor:
    """x (B, l, D), scores (B, l), mask (B, l): this rank's l positions of
    the sequence sharded over `axis`. Returns (B, D), the same on every
    rank of the axis."""
    ms = mask.to(scores.dtype)
    neg = torch.finfo(scores.dtype).min
    local = torch.where(ms > 0, scores, torch.full_like(scores, neg))
    local_max = local.detach().amax(dim=1)
    m = all_gather_dim(local_max[None], axis, 0).amax(dim=0)
    m = torch.where(m > neg / 2, m, torch.zeros_like(m))
    e = torch.exp(local - m[:, None]) * ms
    z = reduce_from_mp(e.sum(dim=1), axis)
    w = reduce_from_mp(torch.einsum("bl,bld->bd", e, x.to(e.dtype)), axis)
    return w / (z + EPS)[:, None]
