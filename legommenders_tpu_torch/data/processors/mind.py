"""MIND dataset processor.

The port's own copy of the JAX package's data/processors/mind.py (host-side
numpy; nothing here touches a device).

Parity: reference processor/mind_processor.py — parses MIND TSVs
(news.tsv: nid/category/subcategory/title/abstract;
behaviors.tsv: imp_id/uid/time/history/impressions "nid-click"), explodes
impressions into interaction rows (mind_processor.py:160-185), cleans
histories (:137-157) and splits 10% of train users into validation
(:187-207). Tokenization: whitespace word tokenizer feeding a growable
vocab (GloVe path); HF tokenizers (bert/llama) are optional extras wired
through `extra_tokenizers`.
"""
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from legommenders_tpu_torch.data.processors.base import BaseProcessor
from legommenders_tpu_torch.data.token_store import TokenStore, UNSET
from legommenders_tpu_torch.data.vocab import Vocab
from legommenders_tpu_torch.utils.registry import PROCESSORS


class _MINDBase(BaseProcessor):
    pass


@PROCESSORS.register
class MINDProcessor(_MINDBase):
    name = "mind"
    title_len = 30
    abstract_len = 50
    history_len = 50
    valid_user_frac = 0.1

    def __init__(self, raw_dir=None, save_dir=None, seed: int = 2023,
                 extra_tokenizers: Optional[Dict] = None):
        super().__init__(raw_dir, save_dir)
        self.seed = seed
        self.extra_tokenizers = extra_tokenizers or {}

    # ------------------------------------------------------------------
    def _read_news(self, path: str) -> Tuple[List[str], List[dict]]:
        nids, rows = [], []
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) < 5:
                    continue
                nid, cat, subcat, title, abstract = parts[:5]
                nids.append(nid)
                rows.append(dict(cat=cat, subcat=subcat, title=title,
                                 abstract=abstract))
        return nids, rows

    def _read_behaviors(self, path: str):
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) < 5:
                    continue
                imp_id, uid, _time, history, impressions = parts[:5]
                yield imp_id, uid, history.split(), impressions.split()

    # ------------------------------------------------------------------
    def build(self) -> Dict[str, TokenStore]:
        train_dir = os.path.join(self.raw_dir, "train")
        test_dir = os.path.join(self.raw_dir, "dev")  # MIND-small: dev == test split

        # ---- items -----------------------------------------------------
        item_vocab = Vocab("item_id", tokens=[])
        news: Dict[str, dict] = {}
        for d in (train_dir, test_dir):
            npath = os.path.join(d, "news.tsv")
            if os.path.isfile(npath):
                nids, rows = self._read_news(npath)
                for nid, row in zip(nids, rows):
                    if nid not in news:
                        item_vocab.add(nid)
                        news[nid] = row

        ordered = [news[t] for t in item_vocab.tokens]
        word_vocab = Vocab("word", tokens=[])
        cat_vocab = Vocab("category", tokens=[])
        subcat_vocab = Vocab("subcategory", tokens=[])

        items = TokenStore(vocab_hub=self.vocab_hub, key_col="item_id")
        items.add_seq_column(
            "title",
            self.tokenize_texts([r["title"] for r in ordered], word_vocab,
                                self.title_len),
            word_vocab, self.title_len)
        items.add_seq_column(
            "abstract",
            self.tokenize_texts([r["abstract"] for r in ordered], word_vocab,
                                self.abstract_len),
            word_vocab, self.abstract_len)
        items.add_scalar_column(
            "category", [cat_vocab.add(r["cat"]) for r in ordered], cat_vocab)
        items.add_scalar_column(
            "subcategory", [subcat_vocab.add(r["subcat"]) for r in ordered],
            subcat_vocab)
        items.add_scalar_column(
            "item_id", np.arange(len(ordered), dtype=np.int32), item_vocab)

        # natural-language prompt columns for LLM input construction
        # (reference mind_processor.py:116-122: static per-item prefixes
        # composed by the ConcatInputer, config/data/mind-lm-prompt.yaml)
        n_items = len(ordered)
        prompts = {
            "prompt": "Here is a piece of news article. ",
            "prompt_title": "Title: ",
            "prompt_abstract": "Abstract: ",
            "prompt_category": "Category: ",
            "prompt_subcategory": "Subcategory: ",
        }
        for col, text in prompts.items():
            toks = self.tokenize_texts([text], word_vocab, 16)[0]
            items.add_seq_column(col, [list(toks)] * n_items, word_vocab,
                                 max(len(toks), 1))

        for name, spec in self.extra_tokenizers.items():
            # spec: (fn, max_len) or (fn, max_len, vocab)
            tok_fn, max_len = spec[0], spec[1]
            vocab = spec[2] if len(spec) > 2 else \
                Vocab(name, tokens=None).set_size(0)
            for attr in ("title", "abstract"):
                items.add_seq_column(
                    f"{attr}@{name}",
                    [tok_fn(r[attr])[:max_len] for r in ordered],
                    vocab, max_len)
            # category labels are short natural-language strings; LM
            # variants are needed by config/data/mind-lm*.yaml
            # (`category@${lm}`)
            for attr, key in (("category", "cat"), ("subcategory", "subcat")):
                items.add_seq_column(
                    f"{attr}@{name}",
                    [tok_fn(r[key])[:8] for r in ordered],
                    vocab, 8)
            for col, text in prompts.items():
                toks = list(tok_fn(text))[:16]
                items.add_seq_column(f"{col}@{name}", [list(toks)] * n_items,
                                     vocab, max(len(toks), 1))

        # ---- users + interactions --------------------------------------
        user_vocab = Vocab("user_id", tokens=[])
        histories: Dict[int, List[int]] = {}
        rows = {"train": [], "test": []}
        imp_counter = 0
        for phase, d in (("train", train_dir), ("test", test_dir)):
            bpath = os.path.join(d, "behaviors.tsv")
            if not os.path.isfile(bpath):
                continue
            for _imp, uid, hist, imps in self._read_behaviors(bpath):
                u = user_vocab.add(uid)
                if u not in histories:
                    histories[u] = [item_vocab[h] for h in hist
                                    if h in item_vocab][-self.history_len:]
                imp_counter += 1
                for imp in imps:
                    if "-" not in imp:
                        continue
                    nid, click = imp.rsplit("-", 1)
                    if nid in item_vocab:
                        rows[phase].append(
                            (u, item_vocab[nid], int(click), imp_counter))

        U = len(user_vocab)
        users = TokenStore(vocab_hub=self.vocab_hub, key_col="user_id")
        users.add_scalar_column("user_id", np.arange(U, dtype=np.int32),
                                user_vocab)
        users.add_seq_column(
            "history", [histories.get(u, []) for u in range(U)],
            item_vocab, self.history_len)

        # 10% user split for validation (mind_processor.py:187-207)
        rng = np.random.default_rng(self.seed)
        valid_users = set(
            rng.choice(U, size=max(1, int(U * self.valid_user_frac)),
                       replace=False).tolist())
        train_rows = [r for r in rows["train"] if r[0] not in valid_users]
        valid_rows = [r for r in rows["train"] if r[0] in valid_users]

        def make_store(rws):
            arr = np.asarray(rws, np.int32) if rws else np.zeros((0, 4), np.int32)
            st = TokenStore(vocab_hub=self.vocab_hub)
            st.add_scalar_column("user_id", arr[:, 0], user_vocab)
            st.add_scalar_column("item_id", arr[:, 1], item_vocab)
            st.add_scalar_column("click", arr[:, 2])
            st.add_scalar_column("imp_id", arr[:, 3])
            return st

        stores = {
            "items": items,
            "users": users,
            "train": make_store(train_rows),
            "valid": make_store(valid_rows),
            "test": make_store(rows["test"]),
        }
        negs = self.aggregate_negatives(
            U, [stores["train"], stores["valid"]],
            "user_id", "item_id", "click", self.max_neg_store)
        users.add_seq_column(
            "neg", [[x for x in row if x != UNSET] for row in negs],
            item_vocab, negs.shape[1])
        return stores


@PROCESSORS.register
class ONCEMINDProcessor(MINDProcessor):
    """MIND with a deterministic dev split given by an impression-id list
    (parity: reference processor/once_mind_processor.py:28-155 — the
    `path$imp.json` syntax names a JSON list of impression ids that form
    the validation set instead of the random 10% user split)."""

    name = "oncemind"

    def __init__(self, raw_dir=None, save_dir=None, seed: int = 2023,
                 imp_list_path: Optional[str] = None, **kw):
        if raw_dir and "$" in str(raw_dir):
            raw_dir, imp_list_path = str(raw_dir).split("$", 1)
        super().__init__(raw_dir, save_dir, seed=seed, **kw)
        self.imp_list_path = imp_list_path

    def build(self) -> Dict[str, TokenStore]:
        stores = super().build()
        if not self.imp_list_path:
            return stores
        import json

        with open(self.imp_list_path) as f:
            dev_imps = set(json.load(f))
        # merge train+valid back, re-split by impression id
        merged = {}
        for part in ("train", "valid"):
            st = stores[part]
            for col in st.col_names():
                merged.setdefault(col, []).append(st[col])
        cols = {c: np.concatenate(v) for c, v in merged.items()}
        imp = cols["imp_id"]
        is_dev = np.isin(imp, np.asarray(sorted(dev_imps), imp.dtype))
        for part, mask in (("train", ~is_dev), ("valid", is_dev)):
            st = TokenStore(vocab_hub=self.vocab_hub)
            for col, arr in cols.items():
                vocab = stores["train"].col_vocab.get(col)
                st.add_scalar_column(col, arr[mask], vocab)
            stores[part] = st
        return stores
