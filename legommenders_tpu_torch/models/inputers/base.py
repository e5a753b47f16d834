"""Inputer base — the sample→tensor contract, device side.

The port of the JAX package's models/inputers/base.py (reference
model/inputer/base_inputer.py:10-41). An inputer maps token-id tensors
(…, L) with UNSET padding to embeddings (…, L', D) + mask (…, L'). The
shared EmbeddingTables are passed at call time. An inputer is an
nn.Module so that one that carries parameters (ConcatInputer's special
tokens) registers them on the model; `dim`, the width of the embeddings it
returns, sizes them.
"""
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from legommenders_tpu_torch.data.token_store import UNSET

# column spec: (column_name, vocab_name, max_len)
ColSpec = Tuple[str, str, int]


class BaseInputer(nn.Module):
    def __init__(self, cols: Tuple[ColSpec, ...] = (),
                 dtype: torch.dtype = torch.float32,
                 dim: Optional[int] = None):
        super().__init__()
        self.cols = tuple(cols)
        self.dtype = dtype

    @staticmethod
    def mask_of(ids: torch.Tensor) -> torch.Tensor:
        return (ids != UNSET).to(torch.int32)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Inputers without parameters have nothing to draw."""

    def get_embeddings(self, eh, contents: Dict[str, torch.Tensor],
                       rng: Optional[torch.Generator] = None):
        """`rng`: the dropout generator of the embedding transforms
        (None: eval)."""
        raise NotImplementedError
