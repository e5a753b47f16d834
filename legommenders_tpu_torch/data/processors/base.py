"""Offline data-pipeline template.

Parity: reference processor/base_processor.py:205-373 — a processor turns raw
dataset files into on-disk token stores `data/<name>/{items,users,train,
valid,test}`, aggregates per-user negatives from train+valid label-0 rows
(base_processor.py:249-257), and trims unused users/items.
"""
import os
from typing import Dict, List, Optional

import numpy as np

from legommenders_tpu_torch.data.token_store import TokenStore, UNSET
from legommenders_tpu_torch.data.vocab import Vocab, VocabHub
from legommenders_tpu_torch.utils.registry import PROCESSORS


class BaseProcessor:
    name: str = "base"
    max_neg_store: int = 100  # cap stored true-negatives per user

    def __init__(self, raw_dir: Optional[str] = None, save_dir: Optional[str] = None):
        self.raw_dir = raw_dir
        self.save_dir = save_dir or os.path.join("data", self.name)
        self.vocab_hub = VocabHub()

    # -- to be implemented by subclasses --------------------------------
    def build(self) -> Dict[str, TokenStore]:
        """Return {'items':..., 'users':..., 'train':..., 'valid':..., 'test':...}."""
        raise NotImplementedError

    # --------------------------------------------------------------------
    def load(self, regenerate: bool = False) -> Dict[str, TokenStore]:
        parts = ("items", "users", "train", "valid", "test")
        if not regenerate and all(
            os.path.isdir(os.path.join(self.save_dir, p)) for p in parts
        ):
            return {p: TokenStore.load(os.path.join(self.save_dir, p), self.vocab_hub)
                    for p in parts}
        stores = self.build()
        for part, store in stores.items():
            store.save(os.path.join(self.save_dir, part))
        return stores

    # --------------------------------------------------------------------
    @staticmethod
    def aggregate_negatives(
        user_count: int,
        inter_stores: List[TokenStore],
        user_col: str,
        item_col: str,
        label_col: str,
        max_store: int = 100,
    ) -> np.ndarray:
        """Per-user true-negative aggregation over train+valid label-0 rows
        (reference base_processor.py:249-257). Returns (U, max) UNSET-padded."""
        negs: Dict[int, List[int]] = {}
        for store in inter_stores:
            users = store[user_col]
            items = store[item_col]
            labels = store[label_col]
            for u, i, l in zip(users, items, labels):
                if l == 0:
                    lst = negs.setdefault(int(u), [])
                    if len(lst) < max_store:
                        lst.append(int(i))
        width = max((len(v) for v in negs.values()), default=1) or 1
        out = np.full((user_count, width), UNSET, np.int32)
        for u, lst in negs.items():
            out[u, : len(lst)] = lst
        return out

    @staticmethod
    def tokenize_texts(texts: List[str], vocab: Vocab, max_len: int,
                       grow: bool = True) -> List[List[int]]:
        """Simple whitespace/punct word tokenizer for GloVe-style vocabs."""
        import re

        rows = []
        pattern = re.compile(r"[A-Za-z0-9']+")
        for text in texts:
            words = pattern.findall((text or "").lower())[:max_len]
            if grow:
                rows.append([vocab.add(w) for w in words])
            else:
                ids = [vocab.get(w) for w in words]
                rows.append([i for i in ids if i is not None])
        return rows


PROCESSORS.register(BaseProcessor)
