"""Fast-eval representation caches (the port of the JAX package's
runtime/cacher.py single-device path, :73-145 and :261-298).

Before evaluation every item representation (num_items, D) and every user
representation (num_users, D) is computed once, so that each eval row is
two gathers and the predictor (reference base_lego.py:349-398,
repr_cacher.py:35-142). Both builds are a Python loop over pages of
`page_size` rows under `torch.inference_mode()`; contents and the history
matrix are placed on the device once.

Under a mesh (JAX cacher.py:148-298) each rank encodes its block of
ceil(n / dp) rows over the dp axis, page by page from its block's start,
and the blocks are gathered into the whole cache on every rank (the mp
ranks of a dp row encode the same rows together, their TP layers, sharded
tables and expert shards exchanging over mp). Under catalog_parallel the
items are instead the rank's own padded catalog rows (`set_local_contents`
with the Manager's `catalog_contents`, parallel/catalog.py `place_catalog`:
a layer-split LM cache held by rows), encoded whole and gathered over
every rank, (dp, mp) flattened.
"""
from typing import Dict, Optional

import numpy as np
import torch

from legommenders_tpu_torch.data.token_store import UNSET
from legommenders_tpu_torch.parallel.mesh import all_gather_rows, no_pipeline
from legommenders_tpu_torch.utils import spans
from legommenders_tpu_torch.utils.device import resolve_device


class ReprCache:
    """Holds item/user representation caches for one model."""

    def __init__(self, model, item_contents: Dict[str, torch.Tensor],
                 history: np.ndarray, page_size: int = 512, device="cuda",
                 mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.model = model
        self.item_contents = {c: torch.as_tensor(a, device=self.device)
                              for c, a in item_contents.items()}
        self.page_size = int(page_size)
        self.item_repr: Optional[torch.Tensor] = None
        self.user_repr: Optional[torch.Tensor] = None
        self.num_items = next(iter(self.item_contents.values())).shape[0]
        self.num_users = history.shape[0]
        # the UNSET-split history matrix, placed once
        self.hist_safe = torch.as_tensor(
            np.where(history == UNSET, 0, history).astype(np.int32),
            device=self.device)
        self.hist_mask = torch.as_tensor(
            (history != UNSET).astype(np.int32), device=self.device)
        # the item contents are this rank's padded catalog rows
        self.local_items = False

    def set_local_contents(self, local: Dict[str, torch.Tensor]):
        """Catalog-parallel: `local` is this rank's padded rows of the
        catalog; the item cache encodes them whole and gathers."""
        self.item_contents = dict(local)
        self.local_items = True

    @property
    def active(self) -> bool:
        return self.item_repr is not None and self.user_repr is not None

    def pages(self, n: int):
        """(start, stop) of each page over n rows (of this rank's block of
        them under a mesh)."""
        P = self.page_size
        lo, hi = self._block(n)
        return [(s, min(s + P, hi)) for s in range(lo, hi, P)]

    def _block(self, n: int):
        if self.mesh is None:
            return 0, n
        axis = self.mesh.dp_axis
        k = -(-n // axis.size)
        return min(axis.index * k, n), min((axis.index + 1) * k, n)

    def _gather(self, outs, n: int) -> torch.Tensor:
        """This rank's pages -> the whole (n, ...) cache on every rank."""
        if self.mesh is None:
            return torch.cat(outs)
        k = -(-n // self.mesh.dp)
        lo, hi = self._block(n)
        if not outs:
            raise RuntimeError(f"{n} rows leave a dp rank without any")
        block = torch.cat(outs)
        if hi - lo < k:
            block = torch.cat([block, block.new_zeros(
                (k - (hi - lo),) + tuple(block.shape[1:]))])
        return all_gather_rows(block, self.mesh)[:n]

    def _item_page(self, s: int, e: int) -> torch.Tensor:
        with spans.span("lego.cache.item_page"):
            return self.model.encode_item_page(
                {c: a[s:e] for c, a in self.item_contents.items()})

    @torch.inference_mode()
    def build_item_cache(self) -> torch.Tensor:
        with spans.span("lego.cache.items"):
            if self.local_items:
                k = next(iter(self.item_contents.values())).shape[0]
                outs = [self._item_page(s, s + self.page_size)
                        for s in range(0, k, self.page_size)]
                self.item_repr = all_gather_rows(
                    torch.cat(outs), self.mesh,
                    self.mesh.catalog_axis)[:self.num_items]
                return self.item_repr
            outs = [self._item_page(s, e)
                    for s, e in self.pages(self.num_items)]
            self.item_repr = self._gather(outs, self.num_items)
            return self.item_repr

    def _user_page(self, s: int, e: int) -> torch.Tensor:
        with spans.span("lego.cache.user_page"):
            return self.model.encode_user(
                self.item_repr[self.hist_safe[s:e]], self.hist_mask[s:e])

    @torch.inference_mode()
    def build_user_cache(self) -> torch.Tensor:
        if self.item_repr is None:
            raise RuntimeError("build_item_cache first")
        with spans.span("lego.cache.users"):
            outs = [self._user_page(s, e)
                    for s, e in self.pages(self.num_users)]
            self.user_repr = self._gather(outs, self.num_users)
            return self.user_repr

    @no_pipeline()
    def cache(self):
        self.build_item_cache()
        self.build_user_cache()
        return self

    def clean(self):
        """Drop caches at train-phase entry (reference repr_cacher.py:90-101)."""
        self.item_repr = None
        self.user_repr = None
