"""Vocabulary registry — the foundation of the tokenized data substrate.

Replaces the UniTok `Vocab` dependency of the reference (SURVEY.md L0;
reference imports at processor/base_processor.py:30-34). A vocab is a named,
ordered token list with O(1) token->id lookup; id-only vocabs (e.g. item_id)
may have no explicit token strings.
"""
import os
from typing import Dict, Iterable, List, Optional


class Vocab:
    def __init__(self, name: str, tokens: Optional[List[str]] = None,
                 size: Optional[int] = None):
        self.name = name
        self.tokens: Optional[List[str]] = list(tokens) if tokens is not None else None
        self._index: Optional[Dict[str, int]] = (
            {t: i for i, t in enumerate(self.tokens)} if self.tokens is not None else None
        )
        self._size = size

    def __len__(self) -> int:
        if self.tokens is not None:
            return len(self.tokens)
        return int(self._size or 0)

    def __contains__(self, token: str) -> bool:
        return self._index is not None and token in self._index

    def __getitem__(self, token: str) -> int:
        return self._index[token]

    def get(self, token: str, default: int = None):
        if self._index is None:
            return default
        return self._index.get(token, default)

    def add(self, token: str) -> int:
        """Add a token (idempotent); returns its id."""
        if self.tokens is None:
            self.tokens, self._index = [], {}
        if token in self._index:
            return self._index[token]
        idx = len(self.tokens)
        self.tokens.append(token)
        self._index[token] = idx
        return idx

    def extend(self, tokens: Iterable[str]):
        for t in tokens:
            self.add(t)
        return self

    def set_size(self, size: int):
        self._size = size
        return self

    # ----------------------------- persistence -----------------------------
    def save(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"{self.name}.vocab")
        with open(path, "w") as f:
            if self.tokens is not None:
                f.write("\n".join(t.replace("\n", " ") for t in self.tokens))
            else:
                f.write(f"__SIZE__={len(self)}")
        return path

    @classmethod
    def load(cls, directory: str, name: str) -> "Vocab":
        path = os.path.join(directory, f"{name}.vocab")
        with open(path, "r") as f:
            content = f.read()
        if content.startswith("__SIZE__="):
            return cls(name, size=int(content.split("=", 1)[1]))
        tokens = content.split("\n") if content else []
        return cls(name, tokens=tokens)


class VocabHub:
    """Named vocab collection shared across stores."""

    def __init__(self):
        self._vocabs: Dict[str, Vocab] = {}

    def get(self, name: str) -> Vocab:
        return self._vocabs[name]

    def get_or_create(self, name: str) -> Vocab:
        if name not in self._vocabs:
            self._vocabs[name] = Vocab(name, tokens=[])
        return self._vocabs[name]

    def add(self, vocab: Vocab) -> Vocab:
        existing = self._vocabs.get(vocab.name)
        if existing is not None and existing is not vocab and len(existing) != len(vocab):
            # Mirrors the reference's vocab-size conflict detection
            # (loader/embedding_hub.py:346-360).
            raise ValueError(
                f"vocab size conflict for '{vocab.name}': "
                f"{len(existing)} vs {len(vocab)}"
            )
        self._vocabs[vocab.name] = vocab
        return vocab

    def __contains__(self, name: str) -> bool:
        return name in self._vocabs

    def names(self):
        return sorted(self._vocabs)

    def items(self):
        return self._vocabs.items()
