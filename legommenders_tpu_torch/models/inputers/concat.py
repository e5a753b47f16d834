"""ConcatInputer — all input columns as one token sequence.

The port of the JAX package's models/inputers/concat.py:26-85 (reference
model/inputer/concat_inputer.py:24-114): an optional [CLS] prefix and a
[SEP] after each column from a private special-token table, per-column
vocab-embedding lookups concatenated into one (…, L, D) tensor masked by
the UNSET sentinel. Columns keep fixed slots; `compact=True` moves each
sample's valid tokens to the front with a stable sort, for encoders that
read positions (BERT).
"""
from typing import Dict, Optional

import torch
from torch import nn

from legommenders_tpu_torch.models.inputers.base import BaseInputer
from legommenders_tpu_torch.utils.registry import INPUTERS

CLS, SEP = 0, 1


def compact_sequence(emb: torch.Tensor, mask: torch.Tensor):
    """Move valid positions to the front (stable), as if tokens had been
    concatenated before padding. emb (..., L, D), mask (..., L)."""
    order = torch.argsort(1 - mask, dim=-1, stable=True)
    emb_c = torch.take_along_dim(emb, order[..., None], dim=-2)
    mask_c = torch.take_along_dim(mask, order, dim=-1)
    return emb_c, mask_c


@INPUTERS.register
class ConcatInputer(BaseInputer):
    """Parameter: `special_tokens` (2, dim), rows CLS and SEP, when either
    token is used (JAX path params/item_inputer/special_tokens)."""

    def __init__(self, cols=(), dtype: torch.dtype = torch.float32,
                 dim: Optional[int] = None, use_cls_token: bool = False,
                 use_sep_token: bool = False, compact: bool = False):
        super().__init__(cols, dtype, dim)
        self.use_cls_token = use_cls_token
        self.use_sep_token = use_sep_token
        self.compact = compact
        self.special_tokens = None
        if use_cls_token or use_sep_token:
            if dim is None:
                raise ValueError("ConcatInputer: special tokens need `dim`")
            self.special_tokens = nn.Parameter(torch.empty(2, dim))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        if self.special_tokens is not None:
            with torch.no_grad():
                self.special_tokens.normal_(0.0, 0.02, generator=generator)

    def _special(self, row: int, lead) -> torch.Tensor:
        vec = self.special_tokens[row].to(self.dtype)
        return vec.expand(*lead, 1, vec.shape[-1])

    def get_embeddings(self, eh, contents: Dict[str, torch.Tensor],
                       rng: Optional[torch.Generator] = None):
        first = contents[self.cols[0][0]]
        lead = first.shape[:-1]
        parts, mask_parts = [], []

        def one(n):
            return torch.ones(*lead, n, dtype=torch.int32, device=first.device)

        if self.use_cls_token:
            parts.append(self._special(CLS, lead))
            mask_parts.append(one(1))
        for col, vocab, _ in self.cols:
            ids = contents[col]
            m = self.mask_of(ids)
            emb = eh.embed(ids, vocab, col, rng)
            emb = emb * m[..., None].to(emb.dtype)
            parts.append(emb.to(self.dtype))
            mask_parts.append(m)
            if self.use_sep_token:
                parts.append(self._special(SEP, lead))
                mask_parts.append(one(1))

        emb = torch.cat(parts, dim=-2)
        mask = torch.cat(mask_parts, dim=-1)
        if self.compact:
            emb, mask = compact_sequence(emb, mask)
        return emb, mask
