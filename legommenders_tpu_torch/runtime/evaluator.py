"""Evaluation: device-resident cached or full-forward scoring, the host
batched path, and the metric pool.

The port of the JAX package's runtime/evaluator.py (reference
base_lego.py:349-427 and the fast-eval flow of tester.py:54-77):

  * cached (`score_phase_device`): a phase's (user, candidate) index
    columns are placed on the device once; scoring gathers both reprs from
    the caches page by page and runs the predictor;
  * full forward (`score_phase_device_full`), for models without caches or
    with `use_fast_eval` off: the history matrix, its mask, the user-extra
    columns and the item contents are placed once; each page of the eval
    batch size is made by device gathers (the tail page padded with row 0,
    its scores dropped) and runs the model's forward in eval mode;
  * host batched (`collect_scores`), for `Tester.latency` and
    `max_batches` sweeps: EvalBatcher batches moved to the device inside
    the Prefetcher's thread, scores kept on the device until one copy at
    the end.
When every metric is device-supported the scores of the device paths never
leave the device and the torch metric engine returns a handful of scalars;
otherwise one (n,) copy feeds the numpy pool.

Under a mesh (JAX evaluator.py:32-50, 102-125, 196-203) each page of
both device paths is padded to a multiple of dp, each dp rank scores its
rows of it (the mp, sp and pp ranks of a dp row the same rows, together:
a sequence-parallel user operator shards them over sp; a full
forward's batch statistics are the page's, `parallel.mesh.split_batch`)
and the scores are gathered over dp, so every rank holds every score and
computes the same metrics. The host-batched path runs every batch whole
on each rank. Evaluation runs the serial layer stack (`no_pipeline`,
JAX evaluator.py:325-330). Under catalog_parallel a layer-split LM's
cache is held by rows, and no rank has the contents a full forward
encodes: each rank encodes its own rows once a phase in eval mode, the
reprs are gathered over the catalog axis (parallel/catalog.py
`gather_catalog`), and every page's forward reads them in place of its
item encode (JAX evaluates over its row-sharded cache through GSPMD,
evaluator.py:246-320); the pages are those of one process.
"""
from typing import Callable, Dict, Optional

import numpy as np
import torch

from legommenders_tpu_torch.data.pipeline import (
    EvalBatcher, Prefetcher, _user_extra_cols, device_batches,
    on_current_stream,
)
from legommenders_tpu_torch.data.token_store import UNSET
from legommenders_tpu_torch.parallel.catalog import gather_catalog
from legommenders_tpu_torch.parallel.mesh import (
    all_gather_rows, no_pipeline, row_slice, split_batch,
)
from legommenders_tpu_torch.runtime.device_metrics import compute_device
from legommenders_tpu_torch.runtime.metrics import MetricPool
from legommenders_tpu_torch.runtime.steps import make_eval_step
from legommenders_tpu_torch.utils import spans
from legommenders_tpu_torch.utils.device import resolve_device
from legommenders_tpu_torch.utils.timer import Timer


def collect_scores(step_fn: Callable, batcher: EvalBatcher, device,
                   latency_timer: Optional[Timer] = None,
                   max_batches: int = 0, needed_keys=None):
    """Run `step_fn(batch) -> (B, K) scores` over a batcher; returns
    (scores, labels, groups) of the valid rows as numpy arrays.
    `needed_keys` limits what is moved to the device (the cached path reads
    only user_id/candidates). With a `latency_timer`, each forward is timed
    up to the device's end of it."""
    device = torch.device(device)
    prefetcher = Prefetcher(device_batches(
        batcher.epoch(), device, keys=needed_keys,
        skip=("label", "group", "valid")))
    device_scores, valids, labels_all, groups_all = [], [], [], []
    n = 0
    for batch in prefetcher:
        on_current_stream(batch)
        jb = {k: v for k, v in batch.items() if isinstance(v, torch.Tensor)}
        if latency_timer is not None:
            latency_timer.start("forward")
            out = step_fn(jb)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            latency_timer.stop("forward")
        else:
            out = step_fn(jb)
        # scores stay on the device; one copy at the end
        device_scores.append(out.reshape(len(batch["valid"]), -1)[:, 0])
        valids.append(batch["valid"] > 0)
        labels_all.append(batch["label"])
        groups_all.append(batch["group"])
        n += 1
        if max_batches and n >= max_batches:
            prefetcher.close()
            break
    scores = torch.cat(device_scores).float().cpu().numpy()
    valid = np.concatenate(valids)
    return (scores[valid],
            np.concatenate(labels_all)[valid],
            np.concatenate(groups_all)[valid])


class DevicePhase:
    """One eval phase's interaction columns on the device."""

    def __init__(self, data, phase: str, device):
        cm = data.cm
        store = data.inters[phase]
        users = store[cm.user_col].astype(np.int64)
        items = store[cm.item_col].astype(np.int64)
        self.labels = store[cm.label_col].astype(np.float32)
        self.groups = (store[cm.group_col].astype(np.int64)
                       if cm.group_col in store else users)
        self.n = len(users)
        if self.groups.size and (
                self.groups.min() < np.iinfo(np.int32).min
                or self.groups.max() > np.iinfo(np.int32).max):
            raise ValueError("group ids exceed int32 — the device metric "
                             "pool needs dense ids")
        # exact distinct-group count: the width of the metric scatter
        self.num_groups = int(len(np.unique(self.groups)))
        self.users = torch.as_tensor(users.astype(np.int32), device=device)
        self.items = torch.as_tensor(items.astype(np.int32), device=device)
        self.labels_d = torch.as_tensor(self.labels, device=device)
        self.groups_d = torch.as_tensor(self.groups.astype(np.int32),
                                        device=device)


class Evaluator:
    # rows scored per step of the device-resident cached path
    DEVICE_EVAL_PAGE = 1 << 18

    def __init__(self, model, data, metrics, cache=None, device="cuda", *,
                 item_contents: Optional[Dict[str, torch.Tensor]] = None,
                 batch_size: int = 256, mesh=None,
                 local_contents: Optional[Callable[[], Dict]] = None):
        """`item_contents` (the model's content columns, by reference: a
        layer-split LM cache added later is seen) feed the full-forward and
        host-batched paths; `batch_size` is the eval batch size, the page
        of the full-forward path; `mesh` a dp mesh whose ranks split the
        pages; `local_contents` gives this rank's rows of the catalog
        where no rank holds the whole catalog (the Manager's
        `catalog_contents` where `catalog_held_by_rows`)."""
        self.device = resolve_device(device)
        self.mesh = mesh
        self.model = model
        self.data = data
        self.item_contents = item_contents
        self.local_contents = local_contents
        self.batch_size = int(batch_size)
        self.pool = MetricPool.parse(list(metrics))
        self.cache = cache
        self._phases: Dict[str, DevicePhase] = {}
        self._substrate = None

    def phase(self, phase: str) -> DevicePhase:
        if phase not in self._phases:
            self._phases[phase] = DevicePhase(self.data, phase, self.device)
        return self._phases[phase]

    # ------------------------------------------------------------------ #
    # cached scoring                                                     #
    # ------------------------------------------------------------------ #
    @torch.inference_mode()
    def score_phase_device(self, phase: str) -> torch.Tensor:
        """(n,) scores of a whole phase from the caches, on the device."""
        if not self.cache.active:
            raise RuntimeError("build the repr caches first")
        ph = self.phase(phase)
        item_repr, user_repr = self.cache.item_repr, self.cache.user_repr
        nu, ni = user_repr.shape[0], item_repr.shape[0]
        out = []
        with spans.span("lego.eval.score"):
            for s in range(0, ph.n, self.DEVICE_EVAL_PAGE):
                e = s + self.DEVICE_EVAL_PAGE
                users, items, n = self._split(ph.users[s:e], ph.items[s:e])
                u = user_repr[users.clamp(0, nu - 1)]
                i = item_repr[items.clamp(0, ni - 1)][:, None, :]
                with split_batch(self.mesh):
                    scores = self.model.score_cached(u, i).reshape(-1)
                out.append(self._gather(scores, n))
            return torch.cat(out)

    def _split(self, users: torch.Tensor, items: torch.Tensor):
        """A page's (users, items) -> this rank's rows of it, padded with
        row 0 to a multiple of dp, and the page's real length."""
        n = len(users)
        if self.mesh is None:
            return users, items, n
        pad = (-n) % self.mesh.dp
        if pad:
            zeros = users.new_zeros(pad)
            users, items = torch.cat([users, zeros]), torch.cat([items,
                                                                 zeros])
        rows = row_slice(len(users), self.mesh)
        return users[rows], items[rows], n

    def _gather(self, scores: torch.Tensor, n: int) -> torch.Tensor:
        """This rank's scores of a page -> the page's n scores."""
        if self.mesh is None:
            return scores[:n]
        return all_gather_rows(scores, self.mesh)[:n]

    def cached_step(self) -> Callable:
        """step(batch) -> (B, K) scores from the caches (JAX
        cacher.make_cached_eval_step)."""
        cache = self.cache

        @torch.inference_mode()
        def step(batch):
            u = cache.user_repr[batch["user_id"].long().clamp(
                0, cache.user_repr.shape[0] - 1)]
            i = cache.item_repr[batch["candidates"].long().clamp(
                0, cache.item_repr.shape[0] - 1)]
            return self.model.score_cached(u, i)

        return step

    # ------------------------------------------------------------------ #
    # full-forward scoring                                               #
    # ------------------------------------------------------------------ #
    def substrate(self) -> dict:
        """History (pad -> 0), its mask, the user-extra columns and the
        item contents, on the device, placed once."""
        if self._substrate is None:
            hist = self.data.history_matrix()

            def place(a):
                return torch.as_tensor(
                    np.where(a == UNSET, 0, a).astype(np.int32),
                    device=self.device)

            self._substrate = {
                "hist": place(hist),
                "mask": torch.as_tensor((hist != UNSET).astype(np.int32),
                                        device=self.device),
                "extra": {c: place(m) for c, m in
                          _user_extra_cols(self.data).items()},
            }
        return self._substrate

    @torch.inference_mode()
    def catalog_reprs(self) -> Optional[torch.Tensor]:
        """The whole catalog's (N, D) reprs where its contents are held by
        rows (`local_contents`): this rank's rows encoded in eval mode,
        gathered over the catalog axis; None otherwise (the forward
        encodes them)."""
        if self.local_contents is None:
            return None
        n = len(next(iter(self.item_contents.values())))
        local = self.model.encode_item_content(self.local_contents())
        return gather_catalog(local, self.mesh, n)

    @torch.inference_mode()
    def score_phase_device_full(self, phase: str) -> torch.Tensor:
        """(n,) scores of a whole phase through the model's forward, on the
        device: pages of the eval batch size (of max(8, n) rows where the
        phase is smaller), the tail page padded with row 0 (user 0, item 0)
        and its padded scores dropped, as JAX pages (evaluator.py:112-120):
        a head whose scores depend on the batch (DIN's batch norm) scores
        as it does in JAX. Where the catalog is held by rows, the pages
        read `catalog_reprs`."""
        reprs = self.catalog_reprs()
        ph = self.phase(phase)
        sub = self.substrate()
        P = min(self.batch_size, max(8, ph.n))
        if self.mesh is not None:
            # page rows split over dp: the width must divide evenly
            P = -(-P // self.mesh.dp) * self.mesh.dp
        out = []
        for s in range(0, ph.n, P):
            u, i = ph.users[s:s + P], ph.items[s:s + P]
            if len(u) < P:
                pad = u.new_zeros(P - len(u))
                u, i = torch.cat([u, pad]), torch.cat([i, pad])
            u, i, n = self._split(u, i)
            ul = u.long()
            batch = {"history": sub["hist"][ul], "mask": sub["mask"][ul],
                     "candidates": i[:, None], "user_id": u}
            for c, m in sub["extra"].items():
                batch[c] = m[ul]
            with split_batch(self.mesh):
                scores = self.model(batch, self.item_contents,
                                    item_reprs=reprs).reshape(-1)
            out.append(self._gather(scores, n))
        return torch.cat(out)[:ph.n]

    # ------------------------------------------------------------------ #
    @torch.inference_mode()
    def metrics(self, phase: str, scores: torch.Tensor) -> Dict[str, float]:
        ph = self.phase(phase)
        with spans.span("lego.eval.metrics"):
            if self.pool.supports_device:
                vals = compute_device(self.pool.metrics, scores, ph.labels_d,
                                      ph.groups_d, ph.num_groups)
                return {str(m): vals[str(m)] for m in self.pool.metrics}
            return self.pool(scores.float().cpu().numpy(), ph.labels,
                             ph.groups)

    @no_pipeline()
    def evaluate(self, phase: str, latency_timer: Optional[Timer] = None,
                 use_cache: Optional[bool] = None,
                 max_batches: int = 0) -> Dict[str, float]:
        """The metrics of a phase, in JAX evaluator.py:334-388's order:
        through the caches (rebuilt first) when there are caches, else by
        full forwards; whole-phase on the device, or host batches for a
        latency timing or a `max_batches` sweep."""
        use_cache = (self.cache is not None) if use_cache is None else use_cache
        if use_cache:
            self.cache.cache()
            if latency_timer is None and not max_batches:
                return self.metrics(phase, self.score_phase_device(phase))
            step = self.cached_step()
            needed_keys = ("user_id", "candidates")
        else:
            if latency_timer is None and not max_batches:
                return self.metrics(phase,
                                    self.score_phase_device_full(phase))
            step = make_eval_step(self.model, self.item_contents,
                                  self.catalog_reprs())
            needed_keys = None
        batcher = EvalBatcher(self.data, phase, self.batch_size)
        scores, labels, groups = collect_scores(
            step, batcher, self.device, latency_timer=latency_timer,
            max_batches=max_batches, needed_keys=needed_keys)
        return self.pool(scores, labels, groups)
