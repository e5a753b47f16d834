"""SimpleInputer — columns kept separate (the JAX package's
models/inputers/simple.py:13-26, reference simple_inputer.py:11-66):
per-column padded ids + masks, embeddings returned as an ordered dict
col -> (…, L, D)."""
from typing import Dict, Optional

import torch

from legommenders_tpu_torch.models.inputers.base import BaseInputer
from legommenders_tpu_torch.utils.registry import INPUTERS


@INPUTERS.register
class SimpleInputer(BaseInputer):

    def get_embeddings(self, eh, contents: Dict[str, torch.Tensor],
                       rng: Optional[torch.Generator] = None):
        embs, masks = {}, {}
        for col, vocab, _ in self.cols:
            ids = contents[col]
            m = self.mask_of(ids)
            emb = eh.embed(ids, vocab, col, rng)
            embs[col] = (emb * m[..., None].to(emb.dtype)).to(self.dtype)
            masks[col] = m
        return embs, masks
