"""DotPredictor — inner product (the JAX package's
models/predictors/dot.py; reference dot_predictor.py:6-10)."""
import torch

from legommenders_tpu_torch.models.predictors.base import BasePredictor
from legommenders_tpu_torch.utils.registry import PREDICTORS


@PREDICTORS.register
class DotPredictor(BasePredictor):

    def score_pair(self, user, item, rng=None):
        return (user * item).sum(dim=-1)

    def forward(self, user, items, rng=None):
        return torch.einsum("...d,...kd->...k", user, items)
