"""Evaluation: device-resident cached scoring + the metric pool.

The port of the JAX package's runtime/evaluator.py cached device path
(:80-130, :174-206, :334-356; reference base_lego.py:349-427 and the
fast-eval flow of tester.py:54-77). A phase's (user, candidate) index
columns are placed on the device once; scoring gathers both reprs from the
caches page by page and runs the predictor; when every metric is
device-supported the scores never leave the device and the torch metric
engine returns a handful of scalars, otherwise one (n,) copy feeds the
numpy pool. The full-forward path for models without caches is not ported
yet.
"""
from typing import Dict

import numpy as np
import torch

from legommenders_tpu_torch.runtime.device_metrics import compute_device
from legommenders_tpu_torch.runtime.metrics import MetricPool
from legommenders_tpu_torch.utils.device import resolve_device


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
    # rows scored per step of the device-resident path
    DEVICE_EVAL_PAGE = 1 << 18

    def __init__(self, model, data, metrics, cache, device="cuda"):
        if cache is None:
            raise NotImplementedError(
                "the port evaluates through the repr caches only; the "
                "full-forward path is not ported yet")
        self.device = resolve_device(device)
        self.model = model
        self.data = data
        self.pool = MetricPool.parse(list(metrics))
        self.cache = cache
        self._phases: Dict[str, DevicePhase] = {}

    def phase(self, phase: str) -> DevicePhase:
        if phase not in self._phases:
            self._phases[phase] = DevicePhase(self.data, phase, self.device)
        return self._phases[phase]

    @torch.inference_mode()
    def score_phase_device(self, phase: str) -> torch.Tensor:
        """(n,) scores of a whole phase from the caches, on the device."""
        if not self.cache.active:
            raise RuntimeError("build the repr caches first")
        ph = self.phase(phase)
        item_repr, user_repr = self.cache.item_repr, self.cache.user_repr
        nu, ni = user_repr.shape[0], item_repr.shape[0]
        out = []
        for s in range(0, ph.n, self.DEVICE_EVAL_PAGE):
            e = s + self.DEVICE_EVAL_PAGE
            u = user_repr[ph.users[s:e].clamp(0, nu - 1)]
            i = item_repr[ph.items[s:e].clamp(0, ni - 1)][:, None, :]
            out.append(self.model.score_cached(u, i).reshape(-1))
        return torch.cat(out)

    @torch.inference_mode()
    def metrics(self, phase: str, scores: torch.Tensor) -> Dict[str, float]:
        ph = self.phase(phase)
        if self.pool.supports_device:
            vals = compute_device(self.pool.metrics, scores, ph.labels_d,
                                  ph.groups_d, ph.num_groups)
            return {str(m): vals[str(m)] for m in self.pool.metrics}
        return self.pool(scores.float().cpu().numpy(), ph.labels, ph.groups)

    def evaluate(self, phase: str) -> Dict[str, float]:
        """Rebuild the caches, score the phase and compute the metrics."""
        self.cache.cache()
        return self.metrics(phase, self.score_phase_device(phase))
