"""Host-side batch pipeline: fixed-shape numpy batches, vectorized sampling.

The port's copy of the JAX package's data/pipeline.py (a TPU-first
replacement for the reference's DataLoader + per-sample Resampler,
loader/resampler.py:139-259, loader/data_set.py:61-85). Batches carry only
integer IDs — item *content* is gathered on the device from the content
tensors the model holds (models/item_table.py). For the same seed and the
same data the batches are the same numpy arrays as the JAX package's: both
draw from `np.random.default_rng(seed)` and run the same C sampler
(legommenders_tpu_torch/native) with the same seeds.

Negative-sampling semantics match resampler.py:159-171: up to K true
negatives drawn without replacement from the user's negative list, topped up
with uniform-random item ids; the positive sits at index 0 so the CE label
is always 0 (legommender.py:252-263).

`device_batches` moves batches to the device inside the Prefetcher's
thread: on the card each batch is copied from pinned memory on a side
stream that the thread waits on before it hands the batch over, so a batch
the consumer receives is complete and no pinned buffer outlives its copy;
the consumer marks the tensors as used on its own stream
(`on_current_stream`) so that the allocator does not hand their memory to
a later copy while the consumer's kernels still read them.
"""
import threading
import queue as _queue
import time
from typing import Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from legommenders_tpu_torch.data.dataset import LegoData
from legommenders_tpu_torch.data.token_store import UNSET


class Batch(dict):
    """A plain dict of numpy arrays with attribute access for readability."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e


def _pad_rows(arr_2d: np.ndarray) -> np.ndarray:
    """Replace UNSET with 0 so device gathers stay in-bounds."""
    return np.where(arr_2d == UNSET, 0, arr_2d).astype(np.int32)


def _user_extra_cols(data: LegoData) -> Dict[str, np.ndarray]:
    """User-side input columns (SemanticMix-style) to inject into batches,
    keyed by column name (kept distinct from the fixed batch schema)."""
    cols = {}
    for col, _ in getattr(data, "user_inputs", None) or []:
        if col in data.users and col != data.cm.history_col:
            cols[col] = data.users[col]
    return cols


class TrainBatcher:
    """Negative-sampled training batches (or pointwise ranking batches).

    Yields fixed-shape batches; the trailing partial batch is dropped during
    training (static shapes for jit) — with shuffling every sample is still
    seen in expectation.
    """

    def __init__(
        self,
        data: LegoData,
        batch_size: int,
        neg_count: int = 4,
        use_neg_sampling: bool = True,
        seed: int = 2023,
        phase: str = "train",
    ):
        self.data = data
        self.cm = data.cm
        self.batch_size = batch_size
        self.neg_count = neg_count
        self.use_neg_sampling = use_neg_sampling
        self.rng = np.random.default_rng(seed)

        store = data.inters[phase]
        labels = store[self.cm.label_col]
        if use_neg_sampling:
            # x-entropy training keeps only positive rows
            # (reference manager.py:331-347)
            keep = np.nonzero(labels == 1)[0]
            store = store.select(keep)
        self.store = store
        self.user_ids = store[self.cm.user_col].astype(np.int64)
        self.item_ids = store[self.cm.item_col].astype(np.int64)
        self.labels = store[self.cm.label_col].astype(np.float32)

        self.history = data.history_matrix()
        self.user_extra = _user_extra_cols(data)
        negs = data.neg_matrix()
        if negs is None or negs.ndim != 2:
            negs = np.full((data.num_users, 1), UNSET, np.int32)
        self.negs = negs
        self.neg_counts = (negs != UNSET).sum(axis=1).astype(np.int64)
        self.num_items = data.num_items

    def __len__(self) -> int:
        return len(self.user_ids) // self.batch_size

    def _sample_negatives(self, users: np.ndarray) -> np.ndarray:
        """(B, K) negative item ids: native C sampler when available
        (O(B·K) partial Fisher-Yates, legommenders_tpu_torch/native), else
        vectorized numpy argsort."""
        from legommenders_tpu_torch import native

        B, K = len(users), self.neg_count
        out = native.sample_negatives(
            self.negs, self.neg_counts.astype(np.int32), users, K,
            self.num_items, seed=int(self.rng.integers(2 ** 62)))
        if out is not None:
            return out
        rows = self.negs[users]                      # (B, M)
        counts = self.neg_counts[users]              # (B,)
        M = rows.shape[1]
        # random permutation of the valid prefix of each row: argsort random
        # keys, invalid slots pushed to the end
        keys = self.rng.random((B, M))
        keys[rows == UNSET] = 2.0
        order = np.argsort(keys, axis=1)[:, :K]      # (B, K)
        chosen = np.take_along_axis(rows, order, axis=1).astype(np.int64)
        # top up with uniform-random item ids where the user had < K negatives
        rand_items = self.rng.integers(0, self.num_items, size=(B, K))
        col = np.arange(K)[None, :]
        need_random = col >= counts[:, None]
        return np.where(need_random, rand_items, chosen).astype(np.int32)

    def epoch(self, shuffle: bool = True) -> Iterator[Batch]:
        n = len(self.user_ids)
        perm = self.rng.permutation(n) if shuffle else np.arange(n)
        bs = self.batch_size
        for start in range(0, n - bs + 1, bs):
            idx = perm[start : start + bs]
            users = self.user_ids[idx]
            pos = self.item_ids[idx]
            if self.use_neg_sampling:
                negs = self._sample_negatives(users)
                cands = np.concatenate([pos[:, None].astype(np.int32), negs], axis=1)
            else:
                cands = pos[:, None].astype(np.int32)
            hist = self.history[users]
            batch = Batch(
                history=_pad_rows(hist),
                mask=(hist != UNSET).astype(np.int32),
                candidates=cands,
                user_id=users.astype(np.int32),
                label=self.labels[idx],
            )
            for col, mat in self.user_extra.items():
                batch[col] = _pad_rows(mat[users])
            yield batch


class EvalBatcher:
    """Ordered evaluation batches with tail padding + validity mask.

    The reference feeds ragged final batches; as in the JAX package, the
    tail batch is padded to `batch_size` and its padded rows marked
    invalid, so every step sees one shape.
    """

    def __init__(self, data: LegoData, phase: str, batch_size: int):
        self.data = data
        self.cm = data.cm
        self.batch_size = batch_size
        store = data.inters[phase]
        self.user_ids = store[self.cm.user_col].astype(np.int64)
        self.item_ids = store[self.cm.item_col].astype(np.int64)
        self.labels = store[self.cm.label_col].astype(np.float32)
        group_col = self.cm.group_col
        self.groups = store[group_col].astype(np.int64) if group_col in store \
            else self.user_ids
        self.history = data.history_matrix()
        self.user_extra = _user_extra_cols(data)

    @property
    def num_samples(self) -> int:
        return len(self.user_ids)

    def __len__(self) -> int:
        return -(-len(self.user_ids) // self.batch_size)

    def epoch(self) -> Iterator[Batch]:
        n, bs = len(self.user_ids), self.batch_size
        for start in range(0, n, bs):
            end = min(start + bs, n)
            size = end - start
            sl = slice(start, end)
            users = np.zeros(bs, np.int64)
            items = np.zeros(bs, np.int64)
            labels = np.zeros(bs, np.float32)
            groups = np.zeros(bs, np.int64)
            valid = np.zeros(bs, np.int32)
            users[:size] = self.user_ids[sl]
            items[:size] = self.item_ids[sl]
            labels[:size] = self.labels[sl]
            groups[:size] = self.groups[sl]
            valid[:size] = 1
            hist = self.history[users]
            batch = Batch(
                history=_pad_rows(hist),
                mask=((hist != UNSET) & (valid[:, None] > 0)).astype(np.int32),
                candidates=items[:, None].astype(np.int32),
                user_id=users.astype(np.int32),
                label=labels,
                group=groups,
                valid=valid,
            )
            for col, mat in self.user_extra.items():
                batch[col] = _pad_rows(mat[users])
            yield batch


class Prefetcher:
    """Background-thread prefetch of host batches (replaces the reference's
    DataLoader worker processes, manager.py:374-381 — our batch assembly is
    vectorized numpy so one thread suffices).

    Producer exceptions propagate to the consumer (a mid-epoch failure must
    not silently truncate an epoch or an eval sweep); `close()` releases
    the producer when the consumer breaks early, and early-terminated
    for-loops are covered by calling close() from __del__. `wait_s` is the
    time the consumer has spent blocked on the queue.
    """

    def __init__(self, iterator: Iterator, depth: int = 4):
        self.wait_s = 0.0
        self._q: _queue.Queue = _queue.Queue(maxsize=depth)
        self._sentinel = object()
        self._error = None
        self._closed = False
        self._thread = threading.Thread(
            target=self._worker, args=(iterator,), daemon=True
        )
        self._thread.start()

    def _worker(self, iterator):
        try:
            for item in iterator:
                while not self._closed:
                    try:
                        self._q.put(item, timeout=0.2)
                        break
                    except _queue.Full:
                        continue
                if self._closed:
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            self._error = e
        finally:
            # the sentinel MUST land even if the queue is momentarily full
            # (a dropped sentinel deadlocks the consumer's q.get())
            while not self._closed:
                try:
                    self._q.put(self._sentinel, timeout=0.2)
                    break
                except _queue.Full:
                    continue

    def close(self):
        self._closed = True

    __del__ = close

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        item = self._q.get()
        self.wait_s += time.perf_counter() - t0
        if item is self._sentinel:
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item


def device_batches(batches: Iterable[Dict[str, np.ndarray]], device,
                   keys: Optional[Iterable[str]] = None,
                   skip: Iterable[str] = ()) -> Iterator[Dict]:
    """Each batch with its `keys` (all keys when None) but those in `skip`
    as tensors on `device`; the other keys stay numpy. Meant to run inside
    a Prefetcher thread (see the module docstring)."""
    device = torch.device(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    for batch in batches:
        out = Batch(batch)
        move = [k for k in batch if (keys is None or k in keys)
                and k not in skip]
        if stream is None:
            for k in move:
                out[k] = torch.as_tensor(np.asarray(batch[k]), device=device)
        else:
            with torch.cuda.stream(stream):
                for k in move:
                    host = torch.from_numpy(
                        np.ascontiguousarray(batch[k])).pin_memory()
                    out[k] = host.to(device, non_blocking=True)
            stream.synchronize()
        yield out


def on_current_stream(batch: Dict) -> Dict:
    """Mark a device_batches batch's CUDA tensors as used on the current
    stream (Tensor.record_stream); returns the batch."""
    for v in batch.values():
        if isinstance(v, torch.Tensor) and v.is_cuda:
            v.record_stream(torch.cuda.current_stream(v.device))
    return batch
