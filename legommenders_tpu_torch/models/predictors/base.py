"""Predictor base — scoring heads.

The port of the JAX package's models/predictors/base.py (reference
model/predictors/base_predictor.py:13-31): flags `allow_ranking` /
`allow_matching` / `keep_input_dim`, and
    forward(user (B, D), items (B, K, D)) -> scores (B, K).
The pairwise-head helper (`score_pair`) comes with the first predictor
that needs it.
"""
import torch
from torch import nn


class BasePredictor(nn.Module):
    allow_ranking: bool = True
    allow_matching: bool = True
    keep_input_dim: bool = False

    def __init__(self, hidden_size: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_size = hidden_size
        self.dtype = dtype

    def reset_parameters(self, generator=None):
        pass
