"""xMIND multilingual processors.

The port's own copy of the JAX package's data/processors/xmind.py (host-side
numpy; nothing here touches a device).

Parity: reference processor/xmind_processor.py:38-201 — one processor per
xMIND language; reuses the processed English MIND item vocab (item ids must
align) and re-tokenizes title/abstract text for that language. The
reference uses the Llama-1 HF tokenizer; here the tokenizer is pluggable
(`tokenize_fn`), defaulting to the whitespace word tokenizer over a
per-language vocab so the pipeline runs without HF checkpoints.

xMINDsmall ships only items (news.tsv: nid, title, abstract); users and
interactions come from English MIND, so `build` requires a processed MIND
store dir.
"""
import os
from typing import Callable, Dict, Optional

import numpy as np

from legommenders_tpu_torch.data.processors.base import BaseProcessor
from legommenders_tpu_torch.data.token_store import TokenStore
from legommenders_tpu_torch.data.vocab import Vocab
from legommenders_tpu_torch.utils.registry import PROCESSORS


class XMINDProcessor(BaseProcessor):
    name = "xmind"
    lang = "xx"
    title_len = 50
    abstract_len = 200

    def __init__(self, raw_dir=None, save_dir=None,
                 mind_dir: str = "data/mind",
                 tokenize_fn: Optional[Callable] = None):
        super().__init__(raw_dir, save_dir or os.path.join(
            "data", f"xmind-{self.lang}"))
        self.mind_dir = mind_dir
        self.tokenize_fn = tokenize_fn

    def _read_items(self, path):
        rows = {}
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) >= 3:
                    rows[parts[0]] = (parts[1], parts[2])
        return rows

    def build(self) -> Dict[str, TokenStore]:
        base = {p: TokenStore.load(os.path.join(self.mind_dir, p),
                                   self.vocab_hub)
                for p in ("items", "users", "train", "valid", "test")}
        item_vocab = base["items"].vocab_of("item_id")
        if item_vocab is None:
            raise ValueError(
                "xMIND requires the processed MIND dataset "
                "(python -m legommenders_tpu_torch.process --data mind) for vocab alignment")

        texts: Dict[str, tuple] = {}
        for sub in (f"xMINDsmall_train", f"xMINDsmall_dev"):
            path = os.path.join(self.raw_dir, sub, "news.tsv")
            if os.path.isfile(path):
                for nid, t in self._read_items(path).items():
                    texts.setdefault(nid, t)

        titles, abstracts = [], []
        for nid in item_vocab.tokens:
            t, a = texts.get(nid, ("", ""))
            titles.append(t)
            abstracts.append(a)

        items = base["items"]
        if self.tokenize_fn is not None:
            title_rows = [self.tokenize_fn(t)[: self.title_len]
                          for t in titles]
            abstract_rows = [self.tokenize_fn(a)[: self.abstract_len]
                             for a in abstracts]
            lm_vocab = Vocab(f"lm_{self.lang}").set_size(
                max((max(r) + 1 for r in title_rows + abstract_rows if r),
                    default=1))
        else:
            word_vocab = Vocab(f"word_{self.lang}", tokens=[])
            title_rows = self.tokenize_texts(titles, word_vocab,
                                             self.title_len)
            abstract_rows = self.tokenize_texts(abstracts, word_vocab,
                                                self.abstract_len)
            lm_vocab = word_vocab
        items.add_seq_column(f"title@{self.lang}", title_rows, lm_vocab,
                             self.title_len)
        items.add_seq_column(f"abstract@{self.lang}", abstract_rows,
                             lm_vocab, self.abstract_len)
        return base


def _make_lang(lang: str):
    cls = type(f"XMIND{lang.upper()}Processor", (XMINDProcessor,),
               {"lang": lang, "name": f"xmind-{lang}"})
    return PROCESSORS.register(cls, key=f"xmind-{lang}")


# the 14 xMIND languages (reference processor/xmind_processor.py bottom)
XMIND_LANGS = ["cmn", "jpn", "tur", "tha", "ron", "vie", "slv", "swh",
               "som", "kat", "ind", "hat", "grn", "fin"]
for _lang in XMIND_LANGS:
    _make_lang(_lang)
