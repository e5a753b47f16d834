"""Legommender — the composed model, eval-mode paths.

The port of the JAX package's models/legommender.py for serving: an item
(content) operator, a user (behavior) operator and a click predictor over
shared embedding tables (reference model/legommender.py:55-263).

  * `item_inputer` is a submodule: an inputer with parameters (the
    special tokens of ConcatInputer) keeps them in the model's state_dict;
  * `encode_item_content` / `encode_item_page`: token-id contents
    {col: (..., L)} -> item vectors (..., D), without paging
    (JAX :126-161, :225-227);
  * `encode_user`: click vectors (B, S, D) + mask (B, S) -> (B, D);
  * `score_cached`: precomputed reprs -> scores (B, K);
  * `forward`: the catalog branch of the JAX `__call__` (:319-342) — the
    whole catalog is encoded once and candidates and clicks are gathered
    from it. In eval mode the per-occurrence branch computes the same
    values, so the port takes this branch always.
Training (dropout on, gradient plans, paging with remat) is not ported yet.
"""
from typing import Dict, Optional

import torch
from torch import nn

from legommenders_tpu_torch.models.embedding import EmbeddingTables
from legommenders_tpu_torch.models.inputers.base import BaseInputer
from legommenders_tpu_torch.models.operators.base import BaseOperator
from legommenders_tpu_torch.models.predictors.base import BasePredictor


class Legommender(nn.Module):
    def __init__(self, eh: EmbeddingTables, item_op: BaseOperator,
                 user_op: BaseOperator, predictor: BasePredictor,
                 item_inputer: BaseInputer):
        super().__init__()
        self.eh = eh
        self.item_op = item_op
        self.user_op = user_op
        self.predictor = predictor
        self.item_inputer = item_inputer

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.eh.reset_parameters(generator)
        self.item_inputer.reset_parameters(generator)
        self.item_op.reset_parameters(generator)
        self.user_op.reset_parameters(generator)
        self.predictor.reset_parameters(generator)

    # ------------------------------------------------------------------ #
    # item side                                                          #
    # ------------------------------------------------------------------ #
    def encode_item_content(self, contents: Dict[str, torch.Tensor]
                            ) -> torch.Tensor:
        """contents: {col: (..., L)} token ids -> (..., D) item vectors.
        Leading dims are flattened for the operator pass and restored."""
        first = next(iter(contents.values()))
        lead = first.shape[:-1]
        flat = {c: a.reshape(-1, a.shape[-1]) for c, a in contents.items()}
        emb, mask = self.item_inputer.get_embeddings(self.eh, flat)
        out = self.item_op(emb, mask)
        return out.reshape(*lead, *out.shape[1:])

    def encode_item_page(self, contents: Dict[str, torch.Tensor]
                         ) -> torch.Tensor:
        """Cache-building entry: one page of items -> (P, D)."""
        return self.encode_item_content(contents)

    # ------------------------------------------------------------------ #
    # user side and scoring                                              #
    # ------------------------------------------------------------------ #
    def encode_user(self, clicks: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
        """clicks (B, S, D) click vectors + mask (B, S) -> user repr."""
        return self.user_op(clicks, mask)

    def score_cached(self, user_repr: torch.Tensor,
                     item_repr: torch.Tensor) -> torch.Tensor:
        """Fast-eval path: precomputed reprs -> scores (B, K)."""
        return self.predictor(user_repr, item_repr)

    def forward(self, batch: Dict[str, torch.Tensor],
                item_contents: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Raw scores (B, K) for a batch of candidates and histories (the
        pipeline's fixed batch keys)."""
        cand_ids = batch["candidates"]                  # (B, K)
        hist_ids = batch["history"]                     # (B, S)
        click_mask = batch["mask"]                      # (B, S)
        num_items = next(iter(item_contents.values())).shape[0]
        all_reprs = self.encode_item_content(item_contents)     # (N, D)
        item_repr = all_reprs[cand_ids.clamp(0, num_items - 1)]
        clicks = all_reprs[hist_ids.clamp(0, num_items - 1)]
        user_repr = self.encode_user(clicks, click_mask)
        return self.predictor(user_repr, item_repr)
