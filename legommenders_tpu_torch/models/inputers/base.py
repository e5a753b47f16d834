"""Inputer base — the sample→tensor contract, device side.

The port of the JAX package's models/inputers/base.py (reference
model/inputer/base_inputer.py:10-41). An inputer maps token-id tensors
(…, L) with UNSET padding to embeddings (…, L', D) + mask (…, L'). It holds
no parameters: the shared EmbeddingTables are passed at call time.
"""
from typing import Dict, Tuple

import torch

from legommenders_tpu_torch.data.token_store import UNSET

# column spec: (column_name, vocab_name, max_len)
ColSpec = Tuple[str, str, int]


class BaseInputer:
    def __init__(self, cols: Tuple[ColSpec, ...] = (),
                 dtype: torch.dtype = torch.float32):
        self.cols = tuple(cols)
        self.dtype = dtype

    @staticmethod
    def mask_of(ids: torch.Tensor) -> torch.Tensor:
        return (ids != UNSET).to(torch.int32)

    def get_embeddings(self, eh, contents: Dict[str, torch.Tensor]):
        raise NotImplementedError
