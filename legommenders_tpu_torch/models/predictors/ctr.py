"""FuxiCTR-derived scoring heads: DNN, DeepFM, PNN.

The port of the JAX package's models/predictors/ctr.py (reference
dnn_predictor.py:46-73: an MLP over concat(u, i); deepfm_predictor.py:
46-84: the FM bi-interaction and the DNN, averaged; pnn_predictor.py:
31-85: the inner product beside concat(u, i), then the DNN). Each takes
the user and item width `input_dim`; the MLP is `MLPLayer_0`, as flax
names it.
"""
from typing import Sequence

import torch

from legommenders_tpu_torch.models.common import MLPLayer, reset_children
from legommenders_tpu_torch.models.predictors.base import BasePredictor
from legommenders_tpu_torch.utils.registry import PREDICTORS


class _DNNHead(BasePredictor):
    """A head with one MLP to a single output over `extra` + 2 D
    features."""
    extra_features = 0

    def __init__(self, hidden_size: int = 64, input_dim: int = 64,
                 dnn_hidden_units: Sequence[int] = (1000, 1000, 1000),
                 dnn_activations: str = "relu", dnn_dropout: float = 0.0,
                 dnn_batch_norm: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__(hidden_size, dtype)
        self.MLPLayer_0 = MLPLayer(
            2 * input_dim + self.extra_features, dnn_hidden_units, 1,
            dnn_activations, dnn_dropout, dnn_batch_norm, dtype=dtype)

    def reset_parameters(self, generator=None):
        reset_children(self, generator)

    def dnn(self, x, rng):
        return self.MLPLayer_0(x, rng).squeeze(-1)


@PREDICTORS.register
class DNNPredictor(_DNNHead):

    def score_pair(self, user, item, rng=None):
        return self.dnn(torch.cat([user, item], dim=-1), rng)


@PREDICTORS.register
class DeepFMPredictor(_DNNHead):

    def score_pair(self, user, item, rng=None):
        fields = torch.stack([user, item], dim=-2)
        # FM bi-interaction: 0.5 ((sum)^2 - sum of squares), summed over D
        s = fields.sum(dim=-2)
        sq = (fields ** 2).sum(dim=-2)
        fm = 0.5 * (s ** 2 - sq).sum(dim=-1)
        return (fm + self.dnn(torch.cat([user, item], dim=-1), rng)) / 2.0


@PREDICTORS.register
class PNNPredictor(_DNNHead):
    extra_features = 1

    def score_pair(self, user, item, rng=None):
        # two fields: the single inner product <u, i>
        inner = (user * item).sum(dim=-1, keepdim=True)
        return self.dnn(torch.cat([user, item, inner], dim=-1), rng)
