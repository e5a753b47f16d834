"""Semantic-code inputers (the ONCE semantic-ID family).

The port of the JAX package's models/inputers/semantic.py (reference
semantic_inputer.py:12-66, semantic_mix_inputer.py:10-38):
  * SemanticInputer: the history's code matrix (B, S, C), -1 where a click
    is padded, embedded through the code vocabulary to (B, S, C, D); a
    click counts (mask 1) where any of its codes is set;
  * SemanticMixInputer: the user's own codes (B, C), a batch column of the
    user store, embedded to (B, C, D) with a mask of ones.
"""
from typing import Dict, Optional

import torch

from legommenders_tpu_torch.models.inputers.base import BaseInputer
from legommenders_tpu_torch.utils.registry import INPUTERS


def _one_col(inputer: BaseInputer):
    if len(inputer.cols) != 1:
        raise ValueError(f"{type(inputer).__name__} takes one semantic "
                         f"column, got {[c for c, _, _ in inputer.cols]}")
    return inputer.cols[0]


@INPUTERS.register
class SemanticInputer(BaseInputer):

    def get_embeddings(self, eh, contents: Dict[str, torch.Tensor],
                       rng: Optional[torch.Generator] = None):
        col, vocab, _ = _one_col(self)
        ids = contents[col]                                   # (B, S, C)
        click_mask = (ids != -1).any(dim=-1).to(torch.int32)  # (B, S)
        return eh.embed(ids, vocab, col, rng), click_mask


@INPUTERS.register
class SemanticMixInputer(BaseInputer):
    consumes_user_cols = True

    def get_embeddings(self, eh, contents: Dict[str, torch.Tensor],
                       rng: Optional[torch.Generator] = None):
        col, vocab, _ = _one_col(self)
        ids = contents[col]                                   # (B, C)
        return (eh.embed(ids, vocab, col, rng),
                torch.ones(ids.shape, dtype=torch.int32, device=ids.device))
