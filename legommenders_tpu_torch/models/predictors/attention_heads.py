"""MINERPredictor — target-aware scoring over poly user codes.

The port of MINERPredictor of the JAX package's
models/predictors/attention_heads.py:113-133 (reference
miner_predictor.py:18-64): user (B, C, D) codes, items (B, K, D) ->
scores (B, K): the item-code products reduced by `score_type` "max",
"mean", or "weighted" (a softmax over the codes of the items against
gelu(Dense_0(user)), bias-free, exact erf). Matching only. AutoInt and
DIN wait with the CTR heads (ROADMAP.md, queue 1, item 6).
"""
import torch
from torch import nn

from legommenders_tpu_torch.models.common import dense, gelu, reset_linear
from legommenders_tpu_torch.models.predictors.base import BasePredictor
from legommenders_tpu_torch.utils.registry import PREDICTORS

SCORE_TYPES = ("weighted", "max", "mean")


@PREDICTORS.register
class MINERPredictor(BasePredictor):
    allow_ranking = False
    keep_input_dim = True

    def __init__(self, hidden_size: int = 64, input_dim: int = 64,
                 score_type: str = "weighted",
                 dtype: torch.dtype = torch.float32):
        super().__init__(hidden_size, dtype)
        if score_type not in SCORE_TYPES:
            raise ValueError(f"MINERPredictor: score_type {score_type!r} is "
                             f"not one of {SCORE_TYPES}")
        self.score_type = score_type
        self.Dense_0 = (nn.Linear(input_dim, input_dim, bias=False)
                        if score_type == "weighted" else None)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        if self.Dense_0 is not None:
            reset_linear(self.Dense_0, generator)

    def forward(self, user: torch.Tensor, items: torch.Tensor
                ) -> torch.Tensor:
        dt = torch.promote_types(user.dtype, items.dtype)
        scores = torch.einsum("bkd,bcd->bkc", items.to(dt), user.to(dt))
        if self.score_type == "max":
            return scores.amax(dim=-1)
        if self.score_type == "mean":
            return scores.mean(dim=-1)
        proj = gelu(dense(self.Dense_0, user, self.dtype))
        pt = torch.promote_types(items.dtype, proj.dtype)
        w = torch.softmax(torch.einsum("bkd,bcd->bkc", items.to(pt),
                                       proj.to(pt)), dim=-1)
        return (w * scores).sum(dim=-1)
