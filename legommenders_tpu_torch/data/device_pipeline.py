"""Device-resident training pipeline: batch assembly fused into the step.

The port of the JAX package's data/device_pipeline.py:60-243 without the
mesh. The training substrate (interaction rows, user histories, per-user
negative lists) lives on the device as dense int tensors; per step the
host gives only a (B,) slice of row indices, and the gathers, the negative
sampling and the dropout draw from one generator on the device.

Negative sampling (reference resampler.py:159-171): up to K true negatives
drawn without replacement from the user's negative list (the K smallest of
random keys, invalid slots pushed past every valid key, with torch.topk),
topped up with uniform item ids where the user has fewer than K; the
positive at column 0. The draws are not JAX's (another generator); tests
hold the sampler to these properties.
"""
from typing import Dict, Iterator

import numpy as np
import torch

from legommenders_tpu_torch.data.dataset import LegoData
from legommenders_tpu_torch.data.pipeline import _user_extra_cols
from legommenders_tpu_torch.data.token_store import UNSET
from legommenders_tpu_torch.runtime.steps import (
    make_train_step, step_generator,
)
from legommenders_tpu_torch.utils import spans
from legommenders_tpu_torch.utils.device import resolve_device


class DeviceTrainPipeline:
    """The substrate on the device + the fused (assemble -> loss ->
    update) train step."""

    def __init__(self, data: LegoData, batch_size: int, neg_count: int = 4,
                 use_neg_sampling: bool = True, seed: int = 2023,
                 device="cuda"):
        self.device = resolve_device(device)
        self.batch_size = int(batch_size)
        self.neg_count = int(neg_count)
        self.use_neg_sampling = bool(use_neg_sampling)
        self.host_rng = np.random.default_rng(seed)
        self.num_items = data.num_items
        cm = data.cm

        store = data.inters["train"]
        labels = store[cm.label_col]
        if use_neg_sampling:
            # cross-entropy training keeps only positive rows
            # (reference manager.py:331-347)
            store = store.select(np.nonzero(labels == 1)[0])
        self.n = len(store[cm.user_col])

        def place(arr, dtype=torch.int64):
            return torch.as_tensor(np.asarray(arr), dtype=dtype,
                                   device=self.device)

        self.user_ids = place(store[cm.user_col])
        self.item_ids = place(store[cm.item_col])
        self.labels = place(store[cm.label_col], torch.float32)

        hist = data.history_matrix()
        self.history = place(np.where(hist == UNSET, 0, hist))
        self.hist_mask = place(hist != UNSET, torch.int32)

        negs = data.neg_matrix()
        if negs is None or negs.ndim != 2:
            negs = np.full((data.num_users, 1), UNSET, np.int32)
        if negs.shape[1] < self.neg_count:
            # topk needs K <= row width
            pad = np.full((negs.shape[0], self.neg_count - negs.shape[1]),
                          UNSET, np.int32)
            negs = np.concatenate([negs, pad], axis=1)
        self.neg_counts = place((negs != UNSET).sum(axis=1))
        self.negs = place(np.where(negs == UNSET, 0, negs))
        self.negs_invalid = place(negs == UNSET, torch.bool)
        self.user_extra = {
            col: place(np.where(mat == UNSET, 0, mat))
            for col, mat in _user_extra_cols(data).items()}

    def __len__(self) -> int:
        return self.n // self.batch_size

    def epoch_indices(self, shuffle: bool = True) -> Iterator[np.ndarray]:
        """Host side of the pipeline: one (B,) int32 slice per step."""
        perm = (self.host_rng.permutation(self.n) if shuffle
                else np.arange(self.n))
        bs = self.batch_size
        for start in range(0, self.n - bs + 1, bs):
            yield perm[start:start + bs].astype(np.int32)

    def _sample_negatives(self, users: torch.Tensor,
                          rng: torch.Generator) -> torch.Tensor:
        """(B,) user ids -> (B, K) negative item ids, on the device."""
        K = self.neg_count
        rows = self.negs[users]                        # (B, M)
        invalid = self.negs_invalid[users]             # (B, M)
        counts = self.neg_counts[users]                # (B,)
        keys = torch.rand(rows.shape, generator=rng, device=self.device)
        keys = torch.where(invalid, 2.0, keys)
        # the K smallest keys: a random K-subset of the valid prefix
        order = torch.topk(keys, K, dim=1, largest=False).indices
        chosen = rows.gather(1, order)
        rand_items = torch.randint(0, self.num_items, (users.shape[0], K),
                                   generator=rng, device=self.device)
        need_random = torch.arange(K, device=self.device)[None] >= counts[:, None]
        return torch.where(need_random, rand_items, chosen)

    def assemble(self, idx, rng: torch.Generator) -> Dict[str, torch.Tensor]:
        """(B,) substrate row indices -> the batch dict."""
        with spans.span("lego.assemble"):
            idx = torch.as_tensor(idx, dtype=torch.int64, device=self.device)
            users = self.user_ids[idx]
            pos = self.item_ids[idx]
            if self.use_neg_sampling:
                negs = self._sample_negatives(users, rng)
                cands = torch.cat([pos[:, None], negs], dim=1)
            else:
                cands = pos[:, None]
            batch = {
                "history": self.history[users],
                "mask": self.hist_mask[users],
                "candidates": cands,
                "user_id": users,
                "label": self.labels[idx],
            }
            for col, mat in self.user_extra.items():
                batch[col] = mat[users]
            return batch

    def make_fused_train_step(self, model, item_contents, optimizer,
                              seed: int = 0):
        """step(idx, step_idx) -> loss: one generator per step (from seed
        and step_idx) draws the negatives and then the dropout; assemble,
        then runtime/steps.make_train_step's forward, loss, backward and
        optimizer update."""
        train_step = make_train_step(model, item_contents, optimizer,
                                     self.use_neg_sampling)

        def step(idx, step_idx: int):
            with spans.span("lego.step", step_idx=int(step_idx)):
                rng = step_generator(seed, step_idx, self.device)
                return train_step(self.assemble(idx, rng), rng)

        return step
