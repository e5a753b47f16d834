"""Gather-routed embedding gradients for the static catalog token ids.

The port of the JAX package's ops/catalog_grad.py. In the full-catalog
encode (models/legommender.py) every training step embeds the SAME (N, L)
catalog token matrix, and every user's history row is the same row of the
history matrix. Autograd turns those lookups' backwards into scatters:
`F.embedding`'s backward (a sort and `sum_and_scatter` on the card) for the
token ids, and advanced indexing's backward (`indexing_backward_kernel`,
duplicates of one row summed one after another) for the history gather.
Because the ids are static, the backward is a fixed segment sum whose
layout the host computes once, with numpy, and the card evaluates as a
hierarchy of gathers:

  1. stable-sort the flattened ids; group the occurrences by unique id;
  2. level 1: a static (m1, F) index matrix maps each unique id's
     occurrences into consecutive F-wide blocks (padded with a sentinel row
     that reads zeros): `index_select` of the cotangent, then `.sum(1)`;
  3. repeat with blocks per id until every id holds one row (log_F levels;
     each level is F times smaller than the one before);
  4. one `index_copy_` of the U unique rows into a zero (V, D) gradient.

`CatalogGradPlan.take(table)` is an autograd Function whose forward is the
plain lookup (`index_select` of the clipped ids, bit for bit) and whose
backward is that segment sum. `HistoryGradPlan.take(table, user_id)` reads
`table[H[user_id]]`; its backward sums the (B, S, D) cotangent by user
(`index_add_`, B rows of S * D) and then runs the inner plan over the
history matrix. The sums are f32 adds in another order than the scatter's:
equal to it within rounding. The fan-out of 8 is JAX's.

`last_trace` reports, for each catalog forward of a model, the columns
whose plan was live, those whose runtime column was not the matrix the
plan was built from (dead: plain lookup), and whether the history plan
carried the history gather; tests and the smoke run read it to assert
that the plans are engaged.
"""
import hashlib
import weakref
from typing import List, Tuple

import numpy as np
import torch

from legommenders_tpu_torch.data.token_store import UNSET
from legommenders_tpu_torch.utils import spans

last_trace = {"live": (), "dead": (), "history": False}


def record_trace(live, dead):
    last_trace["live"] = tuple(live)
    last_trace["dead"] = tuple(dead)


def record_history(active: bool):
    last_trace["history"] = bool(active)


def _ids_md5(ids: np.ndarray) -> bytes:
    return hashlib.md5(
        np.ascontiguousarray(np.asarray(ids), dtype=np.int64)).digest()


def _host(ids) -> np.ndarray:
    if isinstance(ids, torch.Tensor):
        return ids.detach().cpu().numpy()
    return np.asarray(ids)


def _level_indices(counts: np.ndarray, starts: np.ndarray, n_rows: int,
                   fanout: int, source: np.ndarray = None) -> np.ndarray:
    """(m2, F) gather matrix collapsing each id's `counts` consecutive rows
    (at `starts`, optionally indirected through `source`) into
    ceil(counts / F) blocks; pad slots point at row `n_rows` (a zero row)."""
    blocks = -(-counts // fanout)
    m2 = int(blocks.sum())
    owner = np.repeat(np.arange(counts.size), blocks)
    excl = np.concatenate([[0], np.cumsum(blocks)[:-1]])
    rank = np.arange(m2) - excl[owner]
    slot = rank[:, None] * fanout + np.arange(fanout)[None, :]
    valid = slot < counts[owner][:, None]
    pos = starts[owner][:, None] + slot
    pos = np.where(valid, pos, 0)
    if source is not None:
        pos = source[pos]
    return np.where(valid, pos, n_rows).astype(np.int64)


class _Take(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, plan):
        ctx.plan = plan
        out = table.index_select(0, plan._safe_flat)
        return out.view(*plan.ids_shape, table.shape[-1])

    @staticmethod
    def backward(ctx, g):
        with spans.span("lego.plans.backward"):
            return ctx.plan.segment_reduce(g), None


class CatalogGradPlan:
    """The gather-reduce layout of one (catalog column, table) pair.

    `take(table)` stands in for `table[clip(ids)]`: the same forward, the
    scatter-free segment sum as its backward. The index tensors live on
    `device`; `source` is the tensor (or array) the plan was built from."""

    def __init__(self, ids, num_rows: int, fanout: int = 8, name: str = "",
                 device=None):
        self.source = ids
        self._source_version = getattr(ids, "_version", None)
        host = _host(ids)
        if device is None:
            device = ids.device if isinstance(ids, torch.Tensor) else "cpu"
        self.device = torch.device(device)
        self.source_md5 = _ids_md5(host)
        self.name = name
        self.num_rows = int(num_rows)
        self.fanout = F = max(2, int(fanout))
        self.ids_shape = tuple(host.shape)
        self._seen = {}

        safe = np.where(host == UNSET, 0, host)
        safe = np.clip(safe, 0, num_rows - 1).astype(np.int64)
        flat = safe.reshape(-1)
        n = flat.size
        order = np.argsort(flat, kind="stable").astype(np.int64)
        uniq, counts = np.unique(flat, return_counts=True)
        self.num_unique = int(uniq.size)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])

        # level 1 gathers straight from the flat cotangent through `order`
        # (the sort permutation and the block padding in one gather)
        levels: List[np.ndarray] = [
            _level_indices(counts, starts, n, F, source=order)]
        counts = -(-counts // F)
        while counts.max(initial=0) > 1:
            starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
            m = int(counts.sum())
            levels.append(_level_indices(counts, starts, m, F))
            counts = -(-counts // F)

        def place(a):
            return torch.as_tensor(a, dtype=torch.int64, device=self.device)

        self._levels = [place(lv.reshape(-1)) for lv in levels]
        self._uniq = place(uniq)
        self._safe_flat = place(flat)

    def take(self, table: torch.Tensor) -> torch.Tensor:
        """(num_rows, D) table -> (*ids_shape, D) rows of the clipped ids."""
        return _Take.apply(table, self)

    def segment_reduce(self, g: torch.Tensor) -> torch.Tensor:
        """The (*ids_shape, D) cotangent summed into the (num_rows, D)
        gradient of the table, without a scatter-add."""
        D = g.shape[-1]
        cur = g.reshape(-1, D)
        zero = cur.new_zeros(1, D)
        for idx in self._levels:
            ext = torch.cat([cur, zero])
            cur = ext.index_select(0, idx).view(-1, self.fanout, D).sum(1)
        grad = g.new_zeros(self.num_rows, D)
        return grad.index_copy_(0, self._uniq, cur)

    # plans are static per (model, catalog): compared and hashed by
    # identity, and shared, not copied, when their model is copied
    def __eq__(self, other):
        return self is other

    def __hash__(self):
        return id(self)

    def __deepcopy__(self, memo):
        return self

    def matches(self, ids_shape: Tuple[int, ...], num_rows: int) -> bool:
        return (tuple(ids_shape) == self.ids_shape
                and int(num_rows) == self.num_rows)

    def matches_source(self, ids) -> bool:
        """Whether `ids` is the catalog matrix this plan was built from: the
        same tensor, unwritten since, or one of the same shape and content.
        The content of a tensor the plan has not seen is hashed once (a
        copy to the host) and the answer kept while that tensor lives
        unwritten, so a training step does not copy the catalog to the
        host."""
        if ids is self.source and getattr(
                ids, "_version", None) == self._source_version:
            return True
        if tuple(ids.shape) != self.ids_shape:
            return False
        version = getattr(ids, "_version", None)
        seen = self._seen.get(id(ids))
        if seen is not None and seen[0]() is ids and seen[1] == version:
            return seen[2]
        same = _ids_md5(_host(ids)) == self.source_md5
        try:
            ref = weakref.ref(ids)
        except TypeError:       # numpy arrays of some kinds: not kept
            return same
        self._seen = {k: v for k, v in self._seen.items()
                      if v[0]() is not None}
        self._seen[id(ids)] = (ref, version, same)
        return same


class _HistoryTake(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, users, plan):
        uc = users.long().clamp(0, plan.num_users - 1)
        ctx.plan = plan
        ctx.save_for_backward(uc)
        ids = plan._hist.index_select(0, uc).reshape(-1)
        out = table.index_select(0, ids)
        return out.view(uc.shape[0], plan.seq_len, table.shape[-1])

    @staticmethod
    def backward(ctx, g):
        (uc,) = ctx.saved_tensors
        plan = ctx.plan
        D = g.shape[-1]
        S = plan.seq_len
        with spans.span("lego.plans.backward"):
            gu = g.new_zeros(plan.num_users, S * D)
            gu.index_add_(0, uc, g.reshape(-1, S * D))
            return plan.inner.segment_reduce(
                gu.view(plan.num_users, S, D)), None, None


class HistoryGradPlan:
    """The history-repr gather of the full-catalog branch with a backward
    that sums by user and then by the static history ids.

    Forward: `take(all_reprs, user_id) == all_reprs[H_safe[user_id]]`, the
    ids the plain gather reads (H_safe: the UNSET -> 0 clipped history
    matrix, what both batch pipelines put in batch["history"]). Backward:
      1. the (B, S, D) cotangent summed by user id (`index_add_` of B rows
         of S * D, in place of B * S rows of D into the catalog);
      2. the inner CatalogGradPlan over the (U, S) history ids sums those
         per-user rows into the (N, D) catalog gradient, with no scatter.
    Valid only where batch history rows are H[user_id] verbatim: the model
    uses it on a training forward (a dropout generator given) whose batch
    carries `user_id` and matches the plan's (S, N)."""

    def __init__(self, hist, num_items: int, fanout: int = 8, device=None):
        self.inner = CatalogGradPlan(hist, num_items, fanout=fanout,
                                     name="history", device=device)
        self.num_users, self.seq_len = self.inner.ids_shape
        self.num_rows = int(num_items)
        self._hist = self.inner._safe_flat.view(self.num_users,
                                                self.seq_len)

    def take(self, table: torch.Tensor, users: torch.Tensor) -> torch.Tensor:
        return _HistoryTake.apply(table, users, self)

    def matches(self, hist_shape, num_items: int) -> bool:
        """Shape gate: (B, S) batch history against this plan's (S, N)."""
        return (len(hist_shape) == 2 and int(hist_shape[1]) == self.seq_len
                and int(num_items) == self.num_rows)

    def __eq__(self, other):
        return self is other

    def __hash__(self):
        return id(self)

    def __deepcopy__(self, memo):
        return self


def build_catalog_plans(columns, col_vocabs, specs, fanout: int = 8):
    """Plans for every trainable item-content column.

    columns: {col: (N, L) token ids (tensors, on the device the plans are
    to live on)}; col_vocabs: {col: vocab name}; specs: the EmbedSpecs.
    Frozen tables are skipped. The table of a column is found as
    EmbeddingTables finds it: the feature-keyed table first, then the
    vocab-keyed one."""
    by_key = {(s.kind, s.name): s for s in specs}
    plans = {}
    for col, arr in columns.items():
        spec = by_key.get(("feature", col)) or by_key.get(
            ("vocab", col_vocabs.get(col)))
        if spec is None or spec.frozen or arr.ndim != 2:
            continue
        plans[col] = CatalogGradPlan(arr, spec.size, fanout=fanout, name=col)
    return plans
