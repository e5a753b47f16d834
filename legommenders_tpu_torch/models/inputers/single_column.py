"""SingleColumnInputer — one column, a direct lookup (the JAX package's
models/inputers/single_column.py; reference single_column_inputer.py:
10-34)."""
from typing import Dict, Optional

import torch

from legommenders_tpu_torch.models.inputers.base import BaseInputer
from legommenders_tpu_torch.utils.registry import INPUTERS


@INPUTERS.register
class SingleColumnInputer(BaseInputer):

    def get_embeddings(self, eh, contents: Dict[str, torch.Tensor],
                       rng: Optional[torch.Generator] = None):
        if len(self.cols) != 1:
            raise ValueError(f"SingleColumnInputer takes exactly one column, "
                             f"got {[c for c, _, _ in self.cols]}")
        col, vocab, _ = self.cols[0]
        ids = contents[col]
        m = self.mask_of(ids)
        emb = eh.embed(ids, vocab, col, rng)
        return emb * m[..., None].to(emb.dtype), m
