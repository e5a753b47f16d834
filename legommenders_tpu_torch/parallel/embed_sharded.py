"""Row-sharded embedding lookup with explicit collectives.

The port of the JAX package's parallel/embed_sharded.py. A table of V rows
row-sharded over the mp axis holds rows [r V/n, (r+1) V/n) on mp rank r;
the ids are the same on every mp rank of a dp row (replicated over mp):

  * `sharded_lookup` — owner-computes: each rank gathers the rows it owns
    and writes zeros for the others, then one all-reduce over mp sums the
    ranks' results (`reduce_from_mp`: its backward is the identity, so
    each rank's backward adds the loss's gradient into its owned rows
    only);
  * `sharded_lookup_gather` — the table's shards all-gathered over mp,
    then a local take; its backward keeps this rank's rows of the
    gradient (every mp rank holds the same loss);
  * `pad_rows_for_sharding` — zero rows up to a multiple of the shards;
  * `sharded_catalog_scores` — sharded serving: the item cache stays
    row-sharded over mp; each rank scores the (replicated) user batch
    against its own items: (B, N / n), this rank's columns of the score
    matrix.
"""
import torch
from torch.nn import functional as F

from legommenders_tpu_torch.parallel.mesh import (
    Axis, all_gather_rows, reduce_from_mp,
)


def sharded_lookup(local_table: torch.Tensor, ids: torch.Tensor,
                   axis: Axis) -> torch.Tensor:
    """local_table (V / n, D), this rank's rows of a table row-sharded over
    `axis`; ids (...) int in [0, V) -> (..., D), every rank the whole
    lookup."""
    k = local_table.shape[0]
    rel = ids.long() - axis.index * k
    owned = (rel >= 0) & (rel < k)
    out = F.embedding(rel.clamp(0, k - 1), local_table)
    out = torch.where(owned[..., None], out, torch.zeros((), dtype=out.dtype,
                                                         device=out.device))
    return reduce_from_mp(out, axis)


class _GatherFromMP(torch.autograd.Function):
    """All-gather of row shards over mp; the backward keeps this rank's
    rows of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.rows = axis, x.shape[0]
        return all_gather_rows(x, None, axis)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.axis.index * ctx.rows
        return grad[lo:lo + ctx.rows].contiguous(), None


def sharded_lookup_gather(local_table: torch.Tensor, ids: torch.Tensor,
                          axis: Axis) -> torch.Tensor:
    """The table's shards all-gathered over `axis`, then a local take."""
    full = (local_table if axis.size == 1
            else _GatherFromMP.apply(local_table, axis))
    return F.embedding(ids.long().clamp(0, full.shape[0] - 1), full)


def pad_rows_for_sharding(table: torch.Tensor, n_shards: int
                          ) -> torch.Tensor:
    """Zero rows appended up to a multiple of n_shards."""
    rem = (-table.shape[0]) % n_shards
    if rem:
        table = torch.cat([table, table.new_zeros((rem,) + tuple(
            table.shape[1:]))])
    return table


def sharded_catalog_scores(user_repr: torch.Tensor,
                           local_items: torch.Tensor) -> torch.Tensor:
    """user (B, D) replicated, this rank's items (N / n, D) -> this rank's
    columns (B, N / n) of the (B, N) score matrix: no item repr moves."""
    return user_repr @ local_items.t()
