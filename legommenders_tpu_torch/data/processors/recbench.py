"""RecBench bridge processors.

The port's own copy of the JAX package's data/processors/recbench.py
(host-side numpy; nothing here touches a device).

Parity: reference processor/recbench_processor.py:53-206 — consume the
parquet exports of the RecBench toolkit (items.parquet / users.parquet /
finetune.parquet / test.parquet + valid_user_set_0.1.txt), split
finetune into train/valid by the predefined user set, tokenize item text
attributes, aggregate per-user negatives (cap 100) and emit a ready
`config/data/<name>.yaml`. The 15 domain subclasses specialize only the
dataset name, text attributes and natural-language prompt (reference
processor/*_recbench_processor.py, ~15 lines each).
"""
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from legommenders_tpu_torch.data.processors.base import BaseProcessor
from legommenders_tpu_torch.data.token_store import TokenStore, UNSET
from legommenders_tpu_torch.data.vocab import Vocab
from legommenders_tpu_torch.utils.io import yaml_save
from legommenders_tpu_torch.utils.registry import PROCESSORS


class RecBenchProcessor(BaseProcessor):
    name = "recbench"
    PROMPT: str = ""
    attrs: Tuple[Tuple[str, int], ...] = (("title", 50),)
    IID = "item_id"
    UID = "user_id"
    HIS = "history"
    LABEL = "click"
    NEG_TRUNCATE = 100

    def __init__(self, raw_dir=None, save_dir=None, valid_ratio: float = 0.1):
        super().__init__(raw_dir,
                         save_dir or os.path.join("data", "recbench",
                                                  self.name))
        self.valid_ratio = valid_ratio

    # ------------------------------------------------------------------
    def _read_parquet(self, fname):
        import pandas as pd

        return pd.read_parquet(os.path.join(self.raw_dir, fname))

    def _valid_user_set(self) -> set:
        path = os.path.join(self.raw_dir,
                            f"valid_user_set_{self.valid_ratio}.txt")
        with open(path) as f:
            return {line.strip() for line in f if line.strip()}

    # ------------------------------------------------------------------
    def build(self) -> Dict[str, TokenStore]:
        item_df = self._read_parquet("items.parquet")
        user_df = self._read_parquet("users.parquet")
        finetune_df = self._read_parquet("finetune.parquet")
        test_df = self._read_parquet("test.parquet")

        item_vocab = Vocab("item_id", tokens=[])
        for iid in item_df[self.IID]:
            item_vocab.add(str(iid))
        user_vocab = Vocab("user_id", tokens=[])
        for uid in user_df[self.UID]:
            user_vocab.add(str(uid))

        word_vocab = Vocab("word", tokens=[])
        items = TokenStore(vocab_hub=self.vocab_hub, key_col="item_id")
        for attr, max_len in self.attrs:
            texts = [str(t) if t is not None else ""
                     for t in item_df[attr].tolist()]
            items.add_seq_column(
                attr, self.tokenize_texts(texts, word_vocab, max_len),
                word_vocab, max_len)
        items.add_scalar_column(
            "item_id", np.arange(len(item_vocab), dtype=np.int32),
            item_vocab)

        # natural-language prompt columns (reference
        # recbench_processor.py:132-135: static domain prompt + per-attr
        # "Title: " prefixes for LLM input construction)
        if self.PROMPT:
            n_items = len(item_vocab)
            prompt_cols = {"prompt": self.PROMPT}
            for attr, _ in self.attrs:
                prompt_cols[f"prompt_{attr}"] = \
                    attr[0].upper() + attr[1:].lower() + ": "
            for col, text in prompt_cols.items():
                toks = self.tokenize_texts([text], word_vocab, 16)[0]
                items.add_seq_column(col, [list(toks)] * n_items, word_vocab,
                                     max(len(toks), 1))

        U = len(user_vocab)
        histories = [[] for _ in range(U)]
        for uid, hist in zip(user_df[self.UID], user_df[self.HIS]):
            ids = [item_vocab[str(h)] for h in list(hist)
                   if str(h) in item_vocab]
            histories[user_vocab[str(uid)]] = ids
        users = TokenStore(vocab_hub=self.vocab_hub, key_col="user_id")
        users.add_scalar_column("user_id", np.arange(U, dtype=np.int32),
                                user_vocab)
        users.add_seq_column("history", histories, item_vocab,
                             max((len(h) for h in histories), default=1) or 1)

        valid_users = self._valid_user_set()

        def make_store(df):
            rows = []
            for uid, iid, label in zip(df[self.UID], df[self.IID],
                                       df[self.LABEL]):
                if str(uid) in user_vocab and str(iid) in item_vocab:
                    rows.append((user_vocab[str(uid)], item_vocab[str(iid)],
                                 int(label), user_vocab[str(uid)]))
            arr = np.asarray(rows, np.int32) if rows else \
                np.zeros((0, 4), np.int32)
            st = TokenStore(vocab_hub=self.vocab_hub)
            st.add_scalar_column("user_id", arr[:, 0], user_vocab)
            st.add_scalar_column("item_id", arr[:, 1], item_vocab)
            st.add_scalar_column("click", arr[:, 2])
            st.add_scalar_column("imp_id", arr[:, 3])
            return st

        is_valid = finetune_df[self.UID].astype(str).isin(valid_users)
        stores = {
            "items": items,
            "users": users,
            "train": make_store(finetune_df[~is_valid]),
            "valid": make_store(finetune_df[is_valid]),
            "test": make_store(test_df),
        }
        negs = self.aggregate_negatives(
            U, [stores["train"], stores["valid"]],
            "user_id", "item_id", "click", self.NEG_TRUNCATE)
        users.add_seq_column(
            "neg", [[x for x in row if x != UNSET] for row in negs],
            item_vocab, negs.shape[1])
        self.emit_data_config()
        return stores

    def emit_data_config(self, config_dir: str = "config/data"):
        """Emit a ready config/data/<name>.yaml
        (reference recbench_processor.py:154-206)."""
        cfg = dict(
            name=self.name,
            base_dir=self.save_dir,
            item=dict(ut="${data.base_dir}/items",
                      inputs=[{attr: ln} for attr, ln in self.attrs]),
            user=dict(ut="${data.base_dir}/users",
                      truncate="${history_truncate:50}$"),
            inter=dict(train="${data.base_dir}/train",
                       dev="${data.base_dir}/valid",
                       test="${data.base_dir}/test"),
            column_map=dict(item_col="item_id", user_col="user_id",
                            history_col="history", neg_col="neg",
                            label_col="click", group_col="imp_id"),
        )
        yaml_save(cfg, os.path.join(config_dir, f"{self.name}.yaml"))


def _domain(name: str, prompt: str, attrs=(("title", 50),)):
    cls = type(f"{name.capitalize()}RBProcessor", (RecBenchProcessor,),
               {"name": f"{name}rb", "PROMPT": prompt, "attrs": tuple(attrs)})
    return PROCESSORS.register(cls, key=f"{name}rb")


# the 15 RecBench domains (reference processor/*_recbench_processor.py)
_domain("mind", "Here is a piece of news article. ")
_domain("pens", "Here is a piece of news article. ")
_domain("ebnerd", "Here is a piece of news article. ")
_domain("goodreads", "Here is a book. ", (("title", 50),))
_domain("movielens", "Here is a movie. ", (("title", 50),))
_domain("microlens", "Here is a micro video. ", (("title", 50),))
_domain("netflix", "Here is a movie. ", (("title", 50),))
_domain("lastfm", "Here is a music track. ", (("title", 50),))
_domain("hotelrec", "Here is a hotel. ", (("title", 50),))
_domain("yelp", "Here is a business. ", (("title", 50),))
_domain("hm", "Here is a fashion product. ", (("title", 50),))
_domain("pog", "Here is a fashion outfit. ", (("title", 50),))
_domain("books", "Here is a book. ", (("title", 50),))
_domain("automotive", "Here is an automotive product. ", (("title", 50),))
_domain("cds", "Here is a CD. ", (("title", 50),))
