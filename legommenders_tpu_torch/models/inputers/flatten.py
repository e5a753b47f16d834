"""FlattenSeqInputer: a user's whole click history as one token sequence.

The port of the JAX package's models/inputers/flatten.py:28-86 (reference
model/inputer/flatten_seq_inputer.py:13-86). The contents are the
history's item columns gathered per click, {col: (B, S, L_col)}, with
UNSET (-1) tokens where a click is padded. Each click keeps fixed slots:
its attribute columns' tokens, an [ATTR_SEP] between two columns and a
[SEP] after the last; a special token is real (mask 1, its embedding) only
when the column before it has a token in that click, else it is masked and
zero. The S clicks' slots are laid end to end into (B, S * per_click, D),
with an optional [CLS] in front; `compact` moves the valid tokens to the
front (stable), for position-reading encoders.
"""
from typing import Dict, Optional

import torch
from torch import nn

from legommenders_tpu_torch.models.inputers.base import BaseInputer
from legommenders_tpu_torch.models.inputers.concat import compact_sequence
from legommenders_tpu_torch.utils.registry import INPUTERS

PAD, CLS, SEP, ATTR_SEP = 0, 1, 2, 3


@INPUTERS.register
class FlattenSeqInputer(BaseInputer):
    """Parameter: `special_tokens` (4, dim), rows [PAD] [CLS] [SEP]
    [ATTR_SEP] (JAX params/user_inputer/special_tokens)."""

    def __init__(self, cols=(), dtype: torch.dtype = torch.float32,
                 dim: Optional[int] = None, use_cls_token: bool = False,
                 use_sep_token: bool = True, use_attr_sep_token: bool = True,
                 compact: bool = False):
        super().__init__(cols, dtype, dim)
        if dim is None:
            raise ValueError("FlattenSeqInputer: special tokens need `dim`")
        self.use_cls_token = use_cls_token
        self.use_sep_token = use_sep_token
        self.use_attr_sep_token = use_attr_sep_token
        self.compact = compact
        self.special_tokens = nn.Parameter(torch.empty(4, dim))
        self.reset_parameters()

    @property
    def per_click_len(self) -> int:
        """The slots of one click: the columns' tokens and the separators."""
        n = sum(length for _, _, length in self.cols)
        if self.use_sep_token:
            n += 1
        if self.use_attr_sep_token:
            n += len(self.cols) - 1
        return n

    def seq_len(self, num_clicks: int) -> int:
        """The flattened length of a history of `num_clicks` clicks."""
        return num_clicks * self.per_click_len + int(self.use_cls_token)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.special_tokens.normal_(0.0, 0.02, generator=generator)

    def get_embeddings(self, eh, contents: Dict[str, torch.Tensor],
                       rng: Optional[torch.Generator] = None):
        first = contents[self.cols[0][0]]                  # (B, S, L0)
        B, S = first.shape[0], first.shape[1]
        dim = self.special_tokens.shape[-1]
        parts, mask_parts = [], []
        for idx, (col, vocab, _) in enumerate(self.cols):
            ids = contents[col]                            # (B, S, L)
            m = self.mask_of(ids)
            emb = eh.embed(ids, vocab, col, rng)
            emb = emb * m[..., None].to(emb.dtype)
            parts.append(emb.to(self.dtype))
            mask_parts.append(m)
            last = idx == len(self.cols) - 1
            token = (SEP if last and self.use_sep_token else
                     ATTR_SEP if not last and self.use_attr_sep_token
                     else None)
            if token is not None:
                valid = (m.sum(dim=-1, keepdim=True) > 0)  # (B, S, 1)
                vec = self.special_tokens[token].to(self.dtype)
                vec = (vec.expand(B, S, 1, dim)
                       * valid[..., None].to(self.dtype))
                parts.append(vec)
                mask_parts.append(valid.to(torch.int32))
        emb = torch.cat(parts, dim=2).reshape(B, -1, dim)
        mask = torch.cat(mask_parts, dim=2).reshape(B, -1)
        if self.use_cls_token:
            cls = self.special_tokens[CLS].to(self.dtype).expand(B, 1, dim)
            emb = torch.cat([cls, emb], dim=1)
            mask = torch.cat([torch.ones(B, 1, dtype=torch.int32,
                                         device=mask.device), mask], dim=1)
        if self.compact:
            emb, mask = compact_sequence(emb, mask)
        return emb, mask
