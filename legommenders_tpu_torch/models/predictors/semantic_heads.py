"""The semantic scoring heads: Poly and SemanticMix.

The port of the JAX package's models/predictors/semantic_heads.py
(reference poly_predictor.py:9-63, semantic_mix_predictor.py:34-89):
  * PolyPredictor: the base predictor (`base`) scores the candidates
    against each level of the user stack (B, n, D); the scores' mean over
    the levels;
  * SemanticMixPredictor: cumulative sums of the user's codes (B, Su, D)
    and of the items' (B, K, Si, D) (an item vector is one level), every
    (item level, user level) pair scored by the base head's `score_pair`
    (B, K, Si, Su), then `mix_linear` (Si * Su -> 1). Its width,
    `num_pairs` = Si * Su, comes from LegoConfig.
"""
from typing import Optional

import torch
from torch import nn

from legommenders_tpu_torch.models.common import dense, reset_linear
from legommenders_tpu_torch.models.predictors.base import BasePredictor
from legommenders_tpu_torch.utils.registry import PREDICTORS


def _make_base(name: str, cfg: Optional[dict], hidden_size: int, dtype):
    from legommenders_tpu_torch.models.lego_config import init_fields

    cls = PREDICTORS[name]
    known = init_fields(cls)
    cfg = {k: v for k, v in (cfg or {}).items() if k in known}
    cfg.setdefault("hidden_size", hidden_size)
    return cls(dtype=dtype, **cfg)


@PREDICTORS.register
class PolyPredictor(BasePredictor):
    keep_input_dim = True

    def __init__(self, hidden_size: int = 64, base_predictor: str = "Dot",
                 base_predictor_config: Optional[dict] = None,
                 num_layers: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__(hidden_size, dtype)
        self.base = _make_base(base_predictor, base_predictor_config,
                               hidden_size, dtype)

    def reset_parameters(self, generator=None):
        self.base.reset_parameters(generator)

    def forward(self, user, items, rng=None):
        """user (B, n, D) level stack; items (B, K, D) -> (B, K)."""
        scores = [self.base(user[:, i], items, rng)
                  for i in range(user.shape[1])]
        return torch.stack(scores).mean(dim=0)


@PREDICTORS.register
class SemanticMixPredictor(BasePredictor):
    keep_input_dim = True

    def __init__(self, hidden_size: int = 64, base_predictor: str = "Dot",
                 base_predictor_config: Optional[dict] = None,
                 num_pairs: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__(hidden_size, dtype)
        self.base = _make_base(base_predictor, base_predictor_config,
                               hidden_size, dtype)
        self.mix_linear = nn.Linear(num_pairs, 1)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        self.base.reset_parameters(generator)
        reset_linear(self.mix_linear, generator)

    def forward(self, user, items, rng=None):
        """user (B, Su, D) codes; items (B, K, Si, D) or (B, K, D)."""
        if items.ndim == 3:
            items = items[:, :, None, :]
        B, K, Si, D = items.shape
        Su = user.shape[1]
        if Si * Su != self.mix_linear.in_features:
            raise ValueError(f"SemanticMixPredictor: {Si} item levels x {Su} "
                             f"user codes, mix_linear takes "
                             f"{self.mix_linear.in_features}")
        u = torch.cumsum(user, dim=1)
        it = torch.cumsum(items, dim=2)
        pair_u = u[:, None, None, :, :].expand(B, K, Si, Su, D)
        pair_i = it[:, :, :, None, :].expand(B, K, Si, Su, D)
        scores = self.base.score_pair(pair_u, pair_i, rng)
        return dense(self.mix_linear, scores.reshape(B, K, Si * Su),
                     self.dtype).squeeze(-1)
