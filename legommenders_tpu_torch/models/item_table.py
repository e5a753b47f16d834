"""Device-resident item content (the port of the JAX package's
models/item_table.py; replaces the reference's host-side Resampler item
cache, loader/resampler.py:113-126).

Every item-input column is a dense (num_items, L) int32 tensor on the
device, UNSET = -1 padded so masks can be derived; consumers slice or
index it on the device.
"""
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from legommenders_tpu_torch.data.dataset import LegoData
from legommenders_tpu_torch.data.token_store import UNSET


class ItemContentTable:
    def __init__(self, columns: Dict[str, torch.Tensor],
                 col_vocabs: Dict[str, str]):
        self.columns = columns          # col -> (N, L) int32 (UNSET padded)
        self.col_vocabs = col_vocabs    # col -> vocab name
        first = next(iter(columns.values()))
        self.num_items = int(first.shape[0])

    @classmethod
    def from_data(cls, data: LegoData,
                  inputs: Optional[List[Tuple[str, Optional[int]]]] = None,
                  device="cpu") -> "ItemContentTable":
        cols, vocabs = {}, {}
        for col, max_len in (inputs or data.item_inputs):
            arr = data.items[col]
            if arr.ndim == 1:
                arr = arr[:, None]
            if max_len is not None and arr.shape[1] != max_len:
                if arr.shape[1] > max_len:
                    arr = arr[:, :max_len]
                else:
                    pad = np.full((arr.shape[0], max_len - arr.shape[1]),
                                  UNSET, np.int32)
                    arr = np.concatenate([arr, pad], axis=1)
            cols[col] = torch.as_tensor(
                np.ascontiguousarray(arr, dtype=np.int32), device=device)
            vocabs[col] = data.items.vocab_name(col) or col
        return cls(cols, vocabs)

    def seq_lens(self) -> Dict[str, int]:
        return {c: int(a.shape[1]) for c, a in self.columns.items()}
