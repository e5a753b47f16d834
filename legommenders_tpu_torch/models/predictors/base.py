"""Predictor base — scoring heads.

The port of the JAX package's models/predictors/base.py (reference
model/predictors/base_predictor.py:13-31): flags `allow_ranking` /
`allow_matching` / `keep_input_dim`, and
    forward(user (B, D), items (B, K, D), rng) -> scores (B, K).
Pairwise heads (the CTR heads) implement `score_pair(user, item, rng)` on
(..., D) inputs of one shape: `forward` broadcasts the user over the K
candidates first (JAX base.py:34-39). `rng` is the dropout generator of
a training forward (None: eval).
"""
from typing import Optional

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

    def score_pair(self, user: torch.Tensor, item: torch.Tensor,
                   rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """(..., D), (..., D) -> (...,). Override in pairwise heads."""
        raise NotImplementedError

    def forward(self, user: torch.Tensor, items: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        K = items.shape[-2]
        u = user[..., None, :].expand(*user.shape[:-1], K, user.shape[-1])
        return self.score_pair(u, items, rng)
